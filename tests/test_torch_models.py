"""The port's model substrate against the JAX package, on the CPU.

The JAX ``api.init`` weights of the reduced tinyllama-1.1b config go to the
port through ``models.convert.params_from_jax``; inputs come from numpy
seeds.  Attention paths agree within atol = rtol = 3e-2 (the JAX package's
flash-kernel tolerance); logits and caches of whole forward passes within
atol = rtol = 5e-2 (its tolerance for prefill logits): XLA's and torch's
CPU bf16 products round at different places.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ShapeSpec, get_config, reduce_for_smoke
from repro.models import api as japi
from repro.models import attention_core as jac
from repro.models import transformer as JTF
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attn as tflash
from repro_torch.models import api as tapi
from repro_torch.models import attention_core as tac
from repro_torch.models import convert
from repro_torch.models import transformer as TTF

TOL = dict(atol=5e-2, rtol=5e-2)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def model():
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    jparams = japi.init(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = reduce_for_smoke(tconfigs.get_config("tinyllama-1.1b"))
    return cfg, jparams, tcfg, convert.params_from_jax(tcfg, tree,
                                                       device="cpu")


def test_config_registry_matches_jax():
    from repro.configs import list_archs

    assert tconfigs.list_archs() == list_archs()
    for name in list_archs():
        assert dataclasses.asdict(tconfigs.get_config(name)) == \
            dataclasses.asdict(get_config(name))
        assert dataclasses.asdict(tconfigs.reduce_for_smoke(
            tconfigs.get_config(name))) == dataclasses.asdict(
            reduce_for_smoke(get_config(name)))
    cfg = tconfigs.get_config("tinyllama-1.1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (22, 2048, 32, 4, 64, 5632, 32000)


def _bf16(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("causal,window,t,s,q_off", [
    (True, 0, 8, 40, 20), (True, 6, 4, 32, 28), (False, 0, 5, 24, 0)])
def test_direct_attention_matches_jax(causal, window, t, s, q_off):
    rng = np.random.default_rng(t * s)
    jq, tq = _bf16(rng, (2, t, 2, 2, 16))
    jk, tk = _bf16(rng, (2, s, 2, 16))
    jv, tv = _bf16(rng, (2, s, 2, 16))
    kw = dict(q_offset=q_off, causal=causal, window=window,
              kv_valid=q_off + t if causal else None)
    want = jac.direct_attention(jq, jk, jv, **kw)
    got = tac.direct_attention(tq, tk, tv, **kw)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("t,s,window,kv_valid,qb,kb", [
    (128, 128, 0, None, 32, 64), (128, 192, 0, 128, 64, 64),
    (96, 96, 24, None, 32, 32)])
def test_flash_attention_matches_jax(t, s, window, kv_valid, qb, kb):
    """The blockwise torch path (bf16 accumulator) against the XLA path."""
    rng = np.random.default_rng(t + s + window)
    jq, tq = _bf16(rng, (2, t, 2, 2, 16))
    jk, tk = _bf16(rng, (2, s, 2, 16))
    jv, tv = _bf16(rng, (2, s, 2, 16))
    kw = dict(causal=True, window=window, kv_valid=kv_valid, q_block=qb,
              kv_block=kb)
    want = jac.flash_attention(jq, jk, jv, **kw)
    got = tac.flash_attention(tq, tk, tv, **kw)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-2, rtol=3e-2)
    assert np.array_equal(
        tac.valid_block_pairs(t // qb, s // kb, qb, kb, 0, causal=True,
                              window=window),
        jac.valid_block_pairs(t // qb, s // kb, qb, kb, 0, causal=True,
                              window=window))
    with pytest.raises(AssertionError):
        tac.flash_attention(tq[:, :t - 1], tk, tv, q_block=qb, kv_block=kb)


def test_b9_plain_matches_attention_core():
    """B9's plain version on the layer's layout equals the blockwise path."""
    rng = np.random.default_rng(0)
    b, t, n_kv, g, h = 2, 128, 2, 2, 32
    _, q = _bf16(rng, (b, t, n_kv, g, h))
    _, k = _bf16(rng, (b, t, n_kv, h))
    _, v = _bf16(rng, (b, t, n_kv, h))
    want = tac.flash_attention(q, k, v, causal=True, q_block=64, kv_block=64)
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * n_kv * g, t, h)
    kf = k.permute(0, 2, 1, 3).reshape(b * n_kv, t, h)
    vf = v.permute(0, 2, 1, 3).reshape(b * n_kv, t, h)
    got = tflash.flash_attn_torch(qf, kf, vf, causal=True, group=g)
    got = got.reshape(b, n_kv, g, t, h).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("route", ["auto", "kernel"])
def test_prefill_matches_jax(model, route):
    """``api.prefill``: logits and cache against JAX's on both attention
    routes (``"auto"`` on the CPU: the blockwise path; ``"kernel"``: B9's
    plain version); the JAX side always takes its XLA path."""
    cfg, jparams, tcfg, tparams = model
    shape = ShapeSpec("p", "prefill", 64, 2)
    jbatch = japi.make_inputs(cfg, shape, seed=1)
    tbatch = tapi.make_inputs(tcfg, shape, seed=1, device="cpu")
    assert np.array_equal(np.asarray(jbatch["tokens"]),
                          tbatch["tokens"].numpy())
    want_logits, want_cache = japi.prefill(jparams, cfg, jbatch)
    tflash.reset_launches()
    got_logits, got_cache = tapi.prefill(tparams, tcfg, tbatch,
                                         attn_route=route)
    assert tflash.launches["flash_attn"] == 0   # no kernel on the CPU
    assert got_logits.shape == want_logits.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(got_logits), _f32(want_logits), **TOL)
    for name in ("k", "v"):
        assert got_cache[name].shape == want_cache[name].shape
        np.testing.assert_allclose(_f32(got_cache[name]),
                                   _f32(want_cache[name]), **TOL)
    full, _ = tapi.prefill(tparams, tcfg, tbatch, last_only=False,
                           attn_route=route)
    assert full.shape == (2, 64, cfg.padded_vocab)
    assert torch.equal(full[:, -1:], got_logits)


def test_prefill_routes_agree(model):
    """B9's route against the blockwise route in the port alone."""
    _, _, tcfg, tparams = model
    tbatch = tapi.make_inputs(tcfg, ShapeSpec("p", "prefill", 48, 2), seed=3,
                              device="cpu")
    want, _ = tapi.prefill(tparams, tcfg, tbatch, attn_route="blockwise")
    got, _ = tapi.prefill(tparams, tcfg, tbatch, attn_route="kernel")
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


def test_prefill_refuses_unknown_attn_route(model):
    _, _, tcfg, tparams = model
    tbatch = tapi.make_inputs(tcfg, ShapeSpec("p", "prefill", 32, 1), seed=3,
                              device="cpu")
    with pytest.raises(ValueError, match="attn_route"):
        tapi.prefill(tparams, tcfg, tbatch, attn_route="1")


def test_decode_step_teacher_forced_matches_jax(model):
    """A prefill into a longer cache, then decode steps on the same tokens
    in both packages: every step's logits within 5e-2."""
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(7)
    b, t, n = 2, 32, 4
    toks = rng.integers(0, cfg.vocab_size, size=(b, t + n)).astype(np.int32)
    jcache = JTF.init_cache(cfg, b, t + n)
    jl, jcache, _ = JTF.forward(jparams, cfg, jnp.asarray(toks[:, :t]),
                                cache=jcache)
    tcache = TTF.init_cache(tcfg, b, t + n, device="cpu")
    tl, tcache, _ = TTF.forward(tparams, tcfg, torch.from_numpy(toks[:, :t]),
                                cache=tcache)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    for i in range(n):
        step = toks[:, t + i:t + i + 1]
        jl, jcache = JTF.decode_step(jparams, cfg, jcache, jnp.asarray(step),
                                     jnp.int32(t + i))
        tl, tcache = TTF.decode_step(tparams, tcfg, tcache,
                                     torch.from_numpy(step), t + i)
        assert tl.shape == jl.shape == (b, 1, cfg.padded_vocab)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    np.testing.assert_allclose(_f32(tcache["k"]), _f32(jcache["k"]), **TOL)


def test_decode_api_and_inputs_match_jax(model):
    cfg, jparams, tcfg, tparams = model
    shape = ShapeSpec("d", "decode", 24, 2)
    jb = japi.make_inputs(cfg, shape, seed=4)
    tb = tapi.make_inputs(tcfg, shape, seed=4, device="cpu")
    assert np.array_equal(np.asarray(jb["tokens"]), tb["tokens"].numpy())
    assert int(jb["pos"]) == tb["pos"]
    np.testing.assert_array_equal(_f32(tb["cache"]["k"]),
                                  _f32(jb["cache"]["k"]))
    jl, _ = japi.decode(jparams, cfg, jb)
    tl, _ = tapi.decode(tparams, tcfg, tb)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    train = ShapeSpec("t", "train", 16, 2)
    jt, tt = japi.make_inputs(cfg, train, 5), tapi.make_inputs(
        tcfg, train, 5, device="cpu")
    assert np.array_equal(np.asarray(jt["labels"]), tt["labels"].numpy())
    jlog, _ = japi.train_logits(jparams, cfg, jt)
    tlog, _ = tapi.train_logits(tparams, tcfg, tt)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL)
    want = float(japi.lm_loss(jlog, jt["labels"]))
    got = float(tapi.lm_loss(tlog, tt["labels"]))
    assert abs(got - want) < 5e-2


def test_init_shapes_and_refusals(model):
    _, jparams, tcfg, _ = model
    p = tapi.init(tcfg, 0, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    assert jax.tree.map(lambda x: tuple(x.shape), p) == shapes
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(p))
    again = tapi.init(tcfg, 0, device="cpu")
    assert torch.equal(p["layers"]["attn"]["wq"], again["layers"]["attn"]["wq"])
    assert float(p["embed"]["table"].abs().max()) <= 2.0
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        convert.params_from_jax(tcfg, tree, device="cpu")
    # the families that waited for A15 initialise with JAX's tree
    for arch in ("granite-moe-1b-a400m", "xlstm-1.3b"):
        cfg = tconfigs.reduce_for_smoke(tconfigs.get_config(arch))
        jcfg = reduce_for_smoke(get_config(arch))
        want = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
            lambda key: japi.init(jcfg, key), jax.random.PRNGKey(0)))
        got = tapi.init(cfg, 0, device="cpu")
        assert jax.tree.map(lambda x: tuple(x.shape), got) == want
    moe = dataclasses.replace(tcfg, n_experts=4, top_k=2)
    jmoe = reduce_for_smoke(dataclasses.replace(
        get_config("tinyllama-1.1b"), n_experts=4, top_k=2))
    want = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
        lambda key: JTF.init_lm(jmoe, key), jax.random.PRNGKey(0)))
    got = TTF.init_lm(moe, torch.Generator(), device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), got) == want
    assert got["layers"]["moe"]["router"].shape == (moe.n_layers,
                                                    moe.d_model, 4)
