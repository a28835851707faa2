"""Every model family of the port against the JAX package, on the CPU.

Each family's reduced config (``reduce_for_smoke``) gets the JAX
``api.init`` weights through ``models.convert.params_from_jax``; batches
come from both packages' ``make_inputs`` with one seed and are asserted
equal.  Logits, caches and states agree within atol = rtol = 5e-2 (the
port's model tolerance: XLA's and torch's CPU bf16 products, and their
exp/log, round at different places).  MoE routing and dispatch are held
bit for bit on inputs whose router products are exact in bf16.

The JAX side is compiled without XLA's excess precision (``_strict``), so
it rounds to bf16 after every op as its code spells out, as its op-by-op
run does and as the port does.  By default XLA keeps float32 through fused
elementwise chains; on these configs that moves the JAX package's own
logits by up to 0.38 (xlstm-1.3b) from its op-by-op run and flips one MoE
routing pick (two experts 0.0007 apart in probability).  The attention
kernel route is held against the JAX package's Pallas kernel in interpret
mode (``REPRO_PALLAS_ATTN=1``), the blockwise route against its XLA path.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ShapeSpec, get_config, reduce_for_smoke
from repro.models import api as japi
from repro.models import moe as JMOE
from repro.models import recurrent as JRG
from repro.models import xlstm as JXL
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attn as tflash
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import recurrent as TRG
from repro_torch.models import xlstm as TXL

TOL = dict(atol=5e-2, rtol=5e-2)
# the reference's own decode-vs-forward envelopes
# (tests/test_arch_smoke.py::test_decode_matches_forward)
FORCED_TOL = {"hybrid": dict(atol=3e-2, rtol=3e-2),
              "ssm": dict(atol=0.15, rtol=3e-2)}
ARCH = {"moe": "granite-moe-1b-a400m", "vlm": "internvl2-2b",
        "hybrid": "recurrentgemma-2b", "ssm": "xlstm-1.3b",
        "encdec": "seamless-m4t-medium"}
FAMILIES = tuple(ARCH)
KERNEL_FAMILIES = ("moe", "vlm", "encdec")   # prefill self-attention on B9


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _model(family):
    arch = ARCH[family]
    cfg = reduce_for_smoke(get_config(arch))
    jparams = japi.init(cfg, jax.random.PRNGKey(0))
    tcfg = reduce_for_smoke(tconfigs.get_config(arch))
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jparams, tcfg, convert.params_from_jax(tcfg, tree,
                                                       device="cpu")


def _strict(fn, *args):
    """``fn(*args)`` compiled by XLA without excess precision."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _batches(family, kind, seq_len, seed, b=2):
    cfg, _, tcfg, _ = _model(family)
    shape = ShapeSpec("s", kind, seq_len, b)
    jb = japi.make_inputs(cfg, shape, seed=seed)
    tb = tapi.make_inputs(tcfg, shape, seed=seed, device="cpu")
    (jpaths, jl), (tpaths, tl) = (zip(*_leaves(jb)), zip(*_leaves(tb)))
    assert jpaths == tpaths
    for path, a, b_ in zip(jpaths, jl, tl):
        if path == "/pos":
            assert int(a) == b_
            continue
        assert tuple(a.shape) == tuple(b_.shape), path
        np.testing.assert_array_equal(_f32(b_), _f32(a), err_msg=path)
    return jb, tb


# seq_len budgets: the VLM spends 8 on patches, the enc-dec halves it
SEQ_T = {"vlm": 40, "encdec": 64}


@pytest.mark.parametrize("family,route", [
    (f, r) for f in FAMILIES
    for r in (("auto", "kernel") if f in KERNEL_FAMILIES else ("auto",))])
def test_prefill_matches_jax(family, route, monkeypatch):
    """``api.prefill``: last-position logits and caches against JAX's
    (``"kernel"``: B9's route, its plain version on the CPU, against the
    JAX package's Pallas kernel in interpret mode)."""
    cfg, jparams, tcfg, tparams = _model(family)
    jb, tb = _batches(family, "prefill", SEQ_T.get(family, 32), seed=1)
    monkeypatch.setenv("REPRO_PALLAS_ATTN", "1" if route == "kernel"
                       else "auto")
    want, jcache = _strict(lambda p, b: japi.prefill(p, cfg, b), jparams, jb)
    tflash.reset_launches()
    got, tcache = tapi.prefill(tparams, tcfg, tb, attn_route=route)
    assert tflash.launches["flash_attn"] == 0      # no kernel on the CPU
    assert got.shape == want.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    assert (tcache is None) == (jcache is None)
    if tcache is not None:
        for name in ("k", "v"):
            assert tcache[name].shape == jcache[name].shape
            np.testing.assert_allclose(_f32(tcache[name]),
                                       _f32(jcache[name]), **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_logits_and_loss_match_jax(family):
    cfg, jparams, tcfg, tparams = _model(family)
    jb, tb = _batches(family, "train", SEQ_T.get(family, 32), seed=5)
    jlog, jaux = _strict(lambda p, b: japi.train_logits(p, cfg, b), jparams,
                         jb)
    tlog, taux = tapi.train_logits(tparams, tcfg, tb)
    assert tlog.shape == jlog.shape
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL)
    assert abs(float(taux) - float(jaux)) < 1e-4
    if family == "moe":
        assert float(taux) > 0
    want = float(japi.lm_loss(jlog, jb["labels"]))
    got = float(tapi.lm_loss(tlog, tb["labels"]))
    assert abs(got - want) < 5e-2


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_matches_jax(family):
    """``api.decode`` on ``make_inputs``' decode batch (a random cache or
    state, one token at position 7): logits and the new cache or state."""
    cfg, jparams, tcfg, tparams = _model(family)
    jb, tb = _batches(family, "decode", 24, seed=4)
    want, jnew = _strict(lambda p, b: japi.decode(p, cfg, b), jparams, jb)
    got, tnew = tapi.decode(tparams, tcfg, tb)
    assert got.shape == want.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    (jpaths, jl), (tpaths, tl) = (zip(*_leaves(jnew)), zip(*_leaves(tnew)))
    assert jpaths == tpaths
    for path, a, b in zip(jpaths, jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == (
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_allclose(_f32(b), _f32(a), err_msg=path, **TOL)


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_teacher_forced_decode_matches_forward(family):
    """Decode steps over a prompt from an empty state give the forward
    pass's logits, in the port and in JAX, within the reference's own
    envelope for the family; the two packages' decodes agree too."""
    cfg, jparams, tcfg, tparams = _model(family)
    jmod, tmod = (JRG, TRG) if family == "hybrid" else (JXL, TXL)
    jinit, tinit = ((JRG.init_hybrid_state, TRG.init_hybrid_state)
                    if family == "hybrid" else
                    (JXL.init_xlstm_state, TXL.init_xlstm_state))
    jstep = getattr(jmod, "decode_step_" + ("hybrid" if family == "hybrid"
                                            else "xlstm"))
    tstep = getattr(tmod, jstep.__name__)
    b, t = 2, 16
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    full, _ = tapi.train_logits(tparams, tcfg, {"tokens":
                                                torch.from_numpy(toks)})
    jstate, tstate = jinit(cfg, b), tinit(tcfg, b, device="cpu")
    args = (jparams, jstate, jnp.asarray(toks[:, :1]), jnp.int32(0))
    step = jax.jit(lambda p, s, x, i: jstep(p, cfg, s, x, i)).lower(
        *args).compile(compiler_options={"xla_allow_excess_precision": False})
    jouts, touts = [], []
    for i in range(t):
        jl, jstate = step(jparams, jstate, jnp.asarray(toks[:, i:i + 1]),
                          jnp.int32(i))
        tl, tstate = tstep(tparams, tcfg, tstate,
                           torch.from_numpy(toks[:, i:i + 1]), i)
        jouts.append(_f32(jl[:, 0]))
        touts.append(_f32(tl[:, 0]))
    dec = np.stack(touts, 1)
    np.testing.assert_allclose(dec, _f32(full), **FORCED_TOL[family])
    assert (dec.argmax(-1) == _f32(full).argmax(-1)).mean() > 0.9
    np.testing.assert_allclose(dec, np.stack(jouts, 1), **FORCED_TOL[family])


def test_forward_hybrid_crosses_an_rglru_chunk():
    """T = 4,096 crosses the 2,048-step scan chunk: the state carried across
    chunks, at the reduced width (d_model 64)."""
    cfg, jparams, tcfg, tparams = _model("hybrid")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             size=(1, 4096))
    want = _strict(lambda p, x: JRG.forward_hybrid(p, cfg, x,
                                                   last_only=True)[0],
                   jparams, jnp.asarray(toks, jnp.int32))
    got = TRG.forward_hybrid(tparams, tcfg, torch.from_numpy(toks),
                             last_only=True)[0]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, size=(2, 4096, 8)).astype(np.float32)
    bb = rng.normal(size=(2, 4096, 8)).astype(np.float32)
    want = JRG._chunked_linear_scan(jnp.asarray(a), jnp.asarray(bb))
    got = TRG._chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(bb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(AssertionError):
        TRG._chunked_linear_scan(torch.from_numpy(a[:, :3000]),
                                 torch.from_numpy(bb[:, :3000]))


def test_forward_xlstm_crosses_an_mlstm_chunk():
    """T = 512 is two 256-step chunks: (C, n) carried across them."""
    cfg, jparams, tcfg, tparams = _model("ssm")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             size=(1, 512))
    want = _strict(lambda p, x: JXL.forward_xlstm(p, cfg, x,
                                                  last_only=True)[0],
                   jparams, jnp.asarray(toks, jnp.int32))
    got = TXL.forward_xlstm(tparams, tcfg, torch.from_numpy(toks),
                            last_only=True)[0]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


def _exact_router(rng, n, d, e):
    """x and router weights of small dyadic values: every router product
    and sum is exact in bf16, so both packages route on equal logits."""
    x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    w = rng.integers(-4, 5, size=(d, e)).astype(np.float32) / 8
    return x, w


@pytest.mark.parametrize("n,e,k,cap", [(64, 8, 2, 12), (48, 4, 2, 24),
                                       (32, 6, 3, 2)])
def test_moe_route_and_dispatch_bit_exact(n, e, k, cap):
    """Ids, aux, dispatch and combine bit for bit, with a planted tie (two
    equal router columns: the lower expert id wins, as ``lax.top_k``) and
    capacity drops on the cumsum rule's tokens."""
    rng = np.random.default_rng(n + e)
    x, w = _exact_router(rng, n, 16, e)
    w[:, e - 1] = w[:, e - 2]                     # experts e-2, e-1 tie
    jp = {"router": jnp.asarray(w)}
    tp = {"router": torch.from_numpy(w)}
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jg, jids, jaux = _strict(lambda p, x: JMOE._route(p, x, k), jp, jx)
    tg, tids, taux = TMOE._route(tp, tx, k)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    ids = np.asarray(jids)
    tie = (ids == e - 2).any(1) != (ids == e - 1).any(1)
    assert tie.any() and not (ids == e - 1)[tie].any()   # the tie was cut
    np.testing.assert_array_equal(_f32(tg), _f32(jg))
    assert abs(float(taux) - float(jaux)) <= 1e-6  # a float32 sum's order
    jd, jc = _strict(lambda i, g: JMOE._dispatch_tensors(i, g, e, cap),
                     jids, jg)
    td, tc = TMOE._dispatch_tensors(tids, tg, e, cap)
    assert td.dtype == tc.dtype == torch.bfloat16 and td.shape == (n, e, cap)
    np.testing.assert_array_equal(_f32(td), _f32(jd))
    np.testing.assert_array_equal(_f32(tc), _f32(jc))
    # each expert keeps its first ``cap`` choices
    counts = np.bincount(ids.ravel(), minlength=e)
    assert _f32(td).sum() == np.minimum(counts, cap).sum()
    assert (counts > cap).any() == (_f32(td).sum() < n * k)


def test_moe_layer_with_every_expert_chosen():
    """``top_k == n_experts``: every token reaches every expert."""
    rng = np.random.default_rng(9)
    d, f, e = 32, 48, 4
    tree = {"router": rng.normal(0, d ** -0.5, size=(d, e)),
            "wi_gate": rng.normal(0, d ** -0.5, size=(e, d, f)),
            "wi_up": rng.normal(0, d ** -0.5, size=(e, d, f)),
            "wo": rng.normal(0, f ** -0.5, size=(e, f, d))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    x = rng.normal(size=(2, 24, d)).astype(np.float32)
    want, jaux = _strict(lambda p, x: JMOE.moe_mlp(p, x, top_k=e),
                         {k: jnp.asarray(v) for k, v in tree.items()},
                         jnp.asarray(x).astype(jnp.bfloat16))
    got, taux = TMOE.moe_mlp({k: torch.from_numpy(v) for k, v in tree.items()},
                             torch.from_numpy(x).bfloat16(), top_k=e)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 24, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    assert abs(float(taux) - float(jaux)) < 1e-5


def test_moe_mlp_refuses_an_expert_axis():
    """An LM mesh with the expert axis takes the expert-parallel path (on a
    world of one: a 1-way "model" axis, the local path's numbers), which
    refuses expert leaves that are not this rank's shard; a mesh without
    the axis takes the local path.  (``tests/test_torch_mesh.py`` holds the
    8-rank path to the JAX package.)"""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh

    class Mesh:
        mesh_dim_names = ("doc", "chunk")

    p = TMOE.init_moe(torch.Generator().manual_seed(0), 8, 8, 2,
                      device="cpu")
    x = torch.randn((1, 4, 8), generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    want, want_aux = TMOE.moe_mlp(p, x, top_k=1)
    got = TMOE.moe_mlp(p, x, top_k=1, mesh=Mesh())
    assert torch.equal(got[0], want) and torch.equal(got[1], want_aux)
    ours = not dist.is_initialized()
    try:
        mesh = lmesh.make_local_mesh(device="cpu")
        got, aux = TMOE.moe_mlp(p, x, top_k=1, mesh=mesh)
        assert torch.equal(got, want) and torch.equal(aux, want_aux)
        with pytest.raises(ValueError, match="takes its 2"):
            TMOE.moe_mlp({**p, "wi_gate": p["wi_gate"][:1]}, x, top_k=1,
                         mesh=mesh)
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("family", FAMILIES)
def test_init_shapes_and_params_from_jax_refusals(family):
    """The port's ``init`` has JAX's tree (names and shapes); the converter
    refuses a renamed and a reshaped leaf."""
    cfg, jparams, tcfg, _ = _model(family)
    shapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    p = tapi.init(tcfg, 0, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), p) == shapes
    assert tapi.param_shapes(tcfg) == shapes
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(p))
    tree = jax.tree.map(np.asarray, jparams)
    path, leaf = max(_leaves(tree), key=lambda kv: kv[1].ndim)
    *parents, name = path.strip("/").split("/")
    node = functools.reduce(lambda t, k: t[k], parents, tree)
    node[name] = leaf[..., :-1]
    with pytest.raises(ValueError, match=name):
        convert.params_from_jax(tcfg, tree, device="cpu")
    node[name + "_renamed"] = node.pop(name)[..., :1]
    with pytest.raises(ValueError, match="expected keys"):
        convert.params_from_jax(tcfg, tree, device="cpu")


def test_input_specs_name_every_family_state():
    """Decode specs carry the JAX package's state trees (names, shapes,
    dtypes), the draw order ``make_inputs`` shares with it."""
    for family in FAMILIES:
        cfg, _, tcfg, _ = _model(family)
        shape = ShapeSpec("d", "decode", 24, 2)
        want = dict(_leaves(japi.input_specs(cfg, shape)))
        got = dict(_leaves(tapi.input_specs(tcfg, shape)))
        assert list(got) == list(want)
        for path, spec in got.items():
            assert tuple(spec.shape) == tuple(want[path].shape), path
            assert str(spec.dtype).split(".")[-1] == str(want[path].dtype)


def test_stack_and_index_trees_round_trip():
    trees = [{"a": torch.full((2,), float(i)), "b": {"c": torch.ones(3) * i}}
             for i in range(3)]
    stacked = TL.stack_trees(trees)
    assert stacked["a"].shape == (3, 2) and stacked["b"]["c"].shape == (3, 3)
    one = TL.index_tree(stacked, 1)
    assert torch.equal(one["b"]["c"], trees[1]["b"]["c"])
    one["a"].fill_(7.0)                       # a view: writes reach the stack
    assert float(stacked["a"][1, 0]) == 7.0


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_every_registered_architecture(arch):
    """All ten architectures, reduced: ``init``'s tree and ``input_specs``
    of every shape kind are JAX's, ``make_inputs`` draws JAX's numbers, and
    ``train_logits`` matches JAX's (the tests above hold the five family
    representatives on every entry point)."""
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = reduce_for_smoke(tconfigs.get_config(arch))
    jparams = japi.init(cfg, jax.random.PRNGKey(1))
    assert tapi.param_shapes(tcfg) == jax.tree.map(lambda x: tuple(x.shape),
                                                   jparams)
    tparams = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    t = 24 if cfg.family == "vlm" else 16        # the VLM's 8 patches
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("s", kind, t, 1)
        want = dict(_leaves(japi.input_specs(cfg, shape)))
        got = dict(_leaves(tapi.input_specs(tcfg, shape)))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
    shape = ShapeSpec("s", "train", t, 1)
    jb, tb = (japi.make_inputs(cfg, shape, seed=2),
              tapi.make_inputs(tcfg, shape, seed=2, device="cpu"))
    for path, a in _leaves(jb):
        np.testing.assert_array_equal(_f32(dict(_leaves(tb))[path]), _f32(a))
    if arch in ARCH.values():
        return
    jlog, _ = _strict(lambda p, b: japi.train_logits(p, cfg, b), jparams, jb)
    tlog, _ = tapi.train_logits(tparams, tcfg, tb)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL)
