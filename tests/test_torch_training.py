"""Training in the port against the JAX package, on the CPU.

The optimizer (``repro_torch.training.optimizer``) is held to the JAX
package's on the same numpy trees within 1e-6 relative.  Loss and
gradients of every model family (``train_loop.loss_fn``'s loss: token
cross entropy + 0.01 x the MoE aux loss) are held to ``jax.value_and_grad``
of the JAX package compiled without excess precision (``_strict``, as
in ``test_torch_families``), at the reduced configs, with the weights
carried over by ``models.convert``:

  * in bf16 compute (the models' own), the loss within 2e-3, each
    gradient leaf within 0.1 of its L2 norm and the global norm within
    5e-3 relative: the two packages' CPU bf16 products, exp and log round at
    different places, which moves the forward logits by up to 0.03 already
    (``test_torch_families.TOL``; measured: loss 6.5e-4 on the hybrid,
    leaves 0.033 and the norm 1.1e-3 on the xLSTM), and the backward pass
    rounds after every op again;
  * in float32 compute (``layers.Compute`` patched in both packages), the
    loss within 1e-5, each leaf within 1e-4 of its L2 norm and the norm
    within 5e-5 relative (measured: 4.8e-7, 2.0e-5 and 5.5e-6, the xLSTM's
    exp gates the largest).

A whole train step, microbatching, remat, the train state crossing the
two packages' checkpoints both ways, the restart manager and
``python -m repro_torch.launch.train`` are covered too.
"""

import contextlib
import dataclasses
import functools
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ShapeSpec, get_config, reduce_for_smoke
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import CheckpointManager as JCheckpointManager
from repro.training import TrainOptions as JTrainOptions
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro.training import optimizer as JOPT
from repro_torch import configs as tconfigs
from repro_torch.distributed.fault_tolerance import RestartManager
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.training import (AdamWConfig, CheckpointManager,
                                  TrainOptions, adamw_init, adamw_update,
                                  cosine_lr, init_train_state,
                                  make_train_step)
from repro_torch.training import optimizer as TOPT

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = {"dense": "tinyllama-1.1b", "moe": "granite-moe-1b-a400m",
        "vlm": "internvl2-2b", "hybrid": "recurrentgemma-2b",
        "ssm": "xlstm-1.3b", "encdec": "seamless-m4t-medium"}
SEQ = {"vlm": 40, "encdec": 64}        # the VLM's 8 patches, enc + dec
AUX = 0.01                             # TrainOptions.aux_loss_weight
# (loss atol, leaf relative L2, global-norm rtol) per compute dtype
GRAD_TOL = {"bfloat16": (2e-3, 0.1, 5e-3), "float32": (1e-5, 1e-4, 5e-5)}
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
JOPTC = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _strict(fn, *args):
    """``fn(*args)`` compiled by XLA without excess precision (as
    ``test_torch_families._strict``)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _configs(family, **replace):
    arch = ARCH[family]
    return (dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **replace),
            dataclasses.replace(reduce_for_smoke(tconfigs.get_config(arch)),
                                **replace))


@functools.lru_cache(maxsize=None)
def _model(family):
    cfg, tcfg = _configs(family)
    # one compiled init (eager, each initialiser op compiles on its own)
    jparams = jax.jit(lambda key: japi.init(cfg, key))(jax.random.PRNGKey(0))
    return cfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _batches(cfg, tcfg, family, seed=5, b=2):
    shape = ShapeSpec("s", "train", SEQ.get(family, 32), b)
    return (japi.make_inputs(cfg, shape, seed=seed),
            tapi.make_inputs(tcfg, shape, seed=seed, device="cpu"))


def _port_loss_and_grads(tparams, tcfg, tb):
    live = jax.tree.map(lambda p: p.detach().requires_grad_(), tparams)
    logits, aux = tapi.train_logits(live, tcfg, tb)
    loss = tapi.lm_loss(logits, tb["labels"]) + AUX * aux
    loss.backward()
    return loss.detach(), jax.tree.map(lambda p: p.grad, live)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

def _opt_tree(rng, scale):
    shapes = {"a": {"w": (3, 4), "b": (4,)}, "c": (5, 2)}
    return jax.tree.map(lambda s: (rng.normal(size=s) * scale)
                        .astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


# (step before the update, gradient scale): the first step, one inside the
# warm-up, one past total_steps; the global norm above and below clip_norm
OPT_CASES = [(0, 3.0), (0, 0.05), (40, 3.0), (40, 0.05), (12_000, 3.0),
             (12_000, 0.05)]


@pytest.mark.parametrize("step0,gscale", OPT_CASES,
                         ids=[f"step{s}-g{g}" for s, g in OPT_CASES])
def test_adamw_update_matches_jax(step0, gscale):
    rng = np.random.default_rng(step0 + int(gscale * 100))
    cfg = AdamWConfig()
    jcfg = JAdamWConfig()
    params, grads = _opt_tree(rng, 1.0), _opt_tree(rng, gscale)
    m = _opt_tree(rng, 0.1)
    v = jax.tree.map(np.abs, _opt_tree(rng, 0.01))
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for _, g in _leaves(grads)))
    assert (norm > cfg.clip_norm) == (gscale > 1)     # clipping (in)active
    jopt = {"m": m, "v": v, "step": jnp.int32(step0)}
    want_p, want_o, want_m = JOPT.adamw_update(jcfg, params, grads, jopt)
    # the update consumes its arguments: fresh tensors, written in place
    tp, tg = _to_torch(params), _to_torch(grads)
    topt = {"m": _to_torch(m), "v": _to_torch(v),
            "step": torch.tensor(step0, dtype=torch.int32)}
    given = [x for _, x in _leaves({"p": tp, "o": topt})]
    got_p, got_o, got_m = adamw_update(cfg, tp, tg, topt)

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=what)

    for (path, w), (_, g) in zip(_leaves(want_p), _leaves(got_p)):
        close(g, w, f"params{path}")
    for name in ("m", "v"):
        for (path, w), (_, g) in zip(_leaves(want_o[name]),
                                     _leaves(got_o[name])):
            close(g, w, f"{name}{path}")
    assert got_o["step"].dtype == torch.int32 and got_o["step"].dim() == 0
    assert int(got_o["step"]) == int(want_o["step"]) == step0 + 1
    for name in ("grad_norm", "lr"):
        close(got_m[name], want_m[name], name)
    # the returned trees hold the given tensors
    returned = [x for _, x in _leaves({"p": got_p, "o": got_o})]
    assert all(a is b for a, b in zip(returned, given))


def test_cosine_lr_and_helpers_match_jax():
    cfg, jcfg = AdamWConfig(), JAdamWConfig()
    for step in (0, 1, 50, 99, 100, 101, 5_000, 9_999, 10_000, 20_000):
        want = float(JOPT.cosine_lr(jcfg, jnp.int32(step)))
        got = float(cosine_lr(cfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, step
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng, 2.0)
    np.testing.assert_allclose(float(TOPT.global_norm(_to_torch(tree))),
                               float(JOPT.global_norm(tree)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        (jg, jn), (tg, tn) = (JOPT.clip_by_global_norm(tree, max_norm),
                              TOPT.clip_by_global_norm(_to_torch(tree),
                                                       max_norm))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for (_, a), (_, b) in zip(_leaves(jg), _leaves(tg)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6)
    init = adamw_init(_to_torch(tree))
    jinit = JOPT.adamw_init(tree)
    assert [p for p, _ in _leaves(init)] == [p for p, _ in _leaves(jinit)]
    assert init["step"].dtype == torch.int32 and init["step"].dim() == 0
    assert all(float(x.abs().sum()) == 0 and x.dtype == torch.float32
               for _, x in _leaves({"m": init["m"], "v": init["v"]}))


# --------------------------------------------------------------------------
# loss and gradients of every family
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _float32_compute():
    """Both packages' ``Compute`` dtype set to float32 for the block."""
    mods = ((JL, jnp.float32), (JMOE, jnp.float32), (TL, torch.float32),
            (TMOE, torch.float32))
    saved = [m.Compute for m, _ in mods]
    for m, dtype in mods:
        m.Compute = dtype
    try:
        yield
    finally:
        for (m, _), dtype in zip(mods, saved):
            m.Compute = dtype


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(family, compute):
    """``jax.value_and_grad`` of the train loss in ``compute``."""
    cfg, tcfg, jparams, _ = _model(family)
    jb, _ = _batches(cfg, tcfg, family)

    def jloss(p, b):
        logits, aux = japi.train_logits(p, cfg, b)
        return japi.lm_loss(logits, b["labels"]) + AUX * aux

    with (_float32_compute() if compute == "float32"
          else contextlib.nullcontext()):
        want, jgrads = _strict(jax.value_and_grad(jloss), jparams, jb)
    return float(want), jax.tree.map(np.asarray, jgrads)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", list(ARCH))
def test_loss_and_gradients_match_jax(family, compute):
    want, jgrads = _jax_loss_and_grads(family, compute)
    cfg, tcfg, _, tree = _model(family)
    _, tb = _batches(cfg, tcfg, family)
    tparams = convert.params_from_jax(tcfg, tree, device="cpu")
    with (_float32_compute() if compute == "float32"
          else contextlib.nullcontext()):
        got, tgrads = _port_loss_and_grads(tparams, tcfg, tb)
    loss_tol, leaf_tol, norm_tol = GRAD_TOL[compute]
    assert abs(float(got) - want) <= loss_tol, (float(got), want)
    jl, tl = list(_leaves(jgrads)), list(_leaves(tgrads))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        b = _np(b)
        assert a.shape == b.shape, path
        assert np.isfinite(b).all(), path
        gap = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12)
        assert gap <= leaf_tol, (path, gap)
    jn = float(JOPT.global_norm(jgrads))
    tn = float(TOPT.global_norm(tgrads))
    assert tn > 0 and abs(tn - jn) <= norm_tol * jn, (tn, jn)


@pytest.mark.parametrize("weight", [AUX, None], ids=["loss", "aux-only"])
def test_moe_gradients_with_dropped_choices_match_jax(weight, monkeypatch):
    """The MoE's gate gradient flows through ``torch.where(keep, gates,
    0)`` in the port and through the combine one-hots in the reference:
    the same function.  Held in float32 compute (tight) at a capacity
    factor that drops choices, for the train loss and for the aux loss
    alone (its gradient reaches the router through the mean probs)."""
    for mod, dtype in ((JL, jnp.float32), (JMOE, jnp.float32),
                       (TL, torch.float32), (TMOE, torch.float32)):
        monkeypatch.setattr(mod, "Compute", dtype)
    cfg, tcfg = _configs("moe", capacity_factor=0.5)
    _, _, jparams, tree = _model("moe")
    jb, tb = _batches(cfg, tcfg, "moe")

    def jloss(p, b):
        logits, aux = japi.train_logits(p, cfg, b)
        if weight is None:
            return aux
        return japi.lm_loss(logits, b["labels"]) + weight * aux

    want, jgrads = _strict(jax.value_and_grad(jloss), jparams, jb)
    live = jax.tree.map(lambda p: p.detach().requires_grad_(),
                        convert.params_from_jax(tcfg, tree, device="cpu"))
    slots, plain = [], TMOE._slots
    monkeypatch.setattr(TMOE, "_slots",
                        lambda *a: slots.append(plain(*a)) or slots[-1])
    logits, aux = tapi.train_logits(live, tcfg, tb)
    assert all((sl < 0).any() for sl in slots)   # every layer drops choices
    got = aux if weight is None else (
        tapi.lm_loss(logits, tb["labels"]) + weight * aux)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    for (path, a), (_, t) in zip(_leaves(jgrads), _leaves(live)):
        a = np.asarray(a, np.float32)
        b = np.zeros_like(a) if t.grad is None else _np(t.grad)
        gap = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12)
        assert gap <= GRAD_TOL["float32"][1] or np.abs(a - b).max() < 1e-9, \
            (path, gap)
    assert np.linalg.norm(np.asarray(jgrads["layers"]["moe"]["router"])) > 0


@pytest.mark.parametrize("family", list(ARCH))
def test_remat_policies_give_equal_loss_and_gradients(family):
    """``"none"``, ``"nothing"`` and ``"dots"`` change memory, never
    values: equal bit for bit on the CPU."""
    results = []
    for policy in ("none", "nothing", "dots"):
        _, tcfg = _configs(family, remat_policy=policy)
        params = tapi.init(tcfg, 0, device="cpu")
        _, tb = _batches(*_configs(family), family, seed=7)
        results.append(_port_loss_and_grads(params, tcfg, tb))
    (l0, g0), rest = results[0], results[1:]
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        for (path, a), (_, b) in zip(_leaves(g0), _leaves(grads)):
            assert torch.equal(a, b), path


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_policy"):
        TL.remat(lambda x: x, "everything")


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_dense_step():
    cfg, _, _, _ = _model("dense")
    step = j_make_train_step(cfg, None, JTrainOptions(optimizer=JOPTC))
    jstate = j_init_train_state(cfg, jax.random.PRNGKey(0))
    jb, _ = _batches(*_configs("dense"), "dense", b=4)
    compiled = jax.jit(step).lower(jstate, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled, jstate, jb


def _assert_step_close(jstate, jmetrics, tstate, tmetrics):
    """One step of each package from one state: loss and grad_norm within
    the bf16 tolerances above, lr within 1e-6; each parameter within
    2 lr + 1e-6 (an Adam update is lr x a ratio in [-1, 1] plus the
    decay: a gradient whose sign differs moves it by at most 2 lr), the
    moments within the gradient leaves' 0.1 relative L2."""
    loss_tol, leaf_tol, norm_tol = GRAD_TOL["bfloat16"]
    assert abs(float(tmetrics["loss"]) - float(jmetrics["loss"])) <= loss_tol
    jn = float(jmetrics["grad_norm"])
    assert abs(float(tmetrics["grad_norm"]) - jn) <= norm_tol * jn
    lr = float(jmetrics["lr"])
    assert abs(float(tmetrics["lr"]) - lr) <= 1e-6 * lr
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"])
    for (path, a), (_, b) in zip(_leaves(jstate["params"]),
                                 _leaves(tstate["params"])):
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                   rtol=0, atol=2 * lr + 1e-6,
                                   err_msg=path)
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(_leaves(jstate["opt"][name]),
                                     _leaves(tstate["opt"][name])):
            a, b = np.asarray(a, np.float32), _np(b)
            gap = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
            assert gap <= leaf_tol, (name, path, gap)


def test_train_step_matches_jax():
    cfg, tcfg, _, _ = _model("dense")
    jstep, jstate, jb = _jax_dense_step()
    _, tb = _batches(cfg, tcfg, "dense", b=4)
    tstate = convert.train_state_from_jax(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    assert tstate["opt"]["step"].dtype == torch.int32
    tstep = make_train_step(tcfg, None, TrainOptions(optimizer=OPT))
    jnew, jmetrics = jstep(jstate, jb)
    tnew, tmetrics = tstep(tstate, tb)
    assert set(tmetrics) == {"loss", "grad_norm", "lr"}
    assert all(v.dim() == 0 for v in tmetrics.values())
    _assert_step_close(jnew, jmetrics, tnew, tmetrics)
    # the state is updated in place and returned
    assert tnew["params"]["embed"]["table"] is \
        tstate["params"]["embed"]["table"]
    back = convert.train_state_to_numpy(tnew)
    assert back["opt"]["step"].dtype == np.int32 and \
        back["opt"]["step"].shape == ()
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jnew))


def test_microbatching_matches_full_batch():
    _, tcfg = _configs("dense")
    shape = ShapeSpec("t", "train", 64, 4)
    batch = tapi.make_inputs(tcfg, shape, seed=0, device="cpu")
    s1 = init_train_state(tcfg, 0, device="cpu")
    s2 = init_train_state(tcfg, 0, device="cpu")
    step1 = make_train_step(tcfg, None, TrainOptions(num_microbatches=1))
    step4 = make_train_step(tcfg, None, TrainOptions(num_microbatches=4))
    s1, m1 = step1(s1, batch)
    s2, m2 = step4(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=2e-2)
    for (_, a), (_, b) in zip(_leaves(s1["params"]), _leaves(s2["params"])):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-3)
    with pytest.raises(ValueError, match="num_microbatches=3"):
        make_train_step(tcfg, None, TrainOptions(num_microbatches=3))(
            s1, batch)


def test_train_loss_decreases():
    _, tcfg = _configs("dense")
    batch = tapi.make_inputs(tcfg, ShapeSpec("t", "train", 64, 4), seed=0,
                             device="cpu")
    opts = TrainOptions(num_microbatches=2, optimizer=OPT)
    state = init_train_state(tcfg, 0, device="cpu", opts=opts)
    step = make_train_step(tcfg, None, opts)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses   # memorises the fixed batch


# --------------------------------------------------------------------------
# checkpoints across the packages, restart
# --------------------------------------------------------------------------

def test_train_state_resumes_across_packages(tmp_path):
    """A JAX train state saved by the JAX package's ``CheckpointManager``
    restores bit for bit in the port, and a port one in JAX; one step of
    each package from the restored state agrees."""
    cfg, tcfg, _, _ = _model("dense")
    jstep, jstate, jb = _jax_dense_step()
    _, tb = _batches(cfg, tcfg, "dense", b=4)
    tstep = make_train_step(tcfg, None, TrainOptions(optimizer=OPT))
    jstate, _ = jstep(jstate, jb)                  # a state past step 0
    jmgr = JCheckpointManager(str(tmp_path / "jax"), keep=2)
    jmgr.save(jstate, 1)
    jmgr.wait()
    like = init_train_state(tcfg, 5, device="cpu")
    tstate, at = CheckpointManager(str(tmp_path / "jax")).restore(like)
    assert at == 1
    for (path, a), (_, b) in zip(_leaves(jax.tree.map(np.asarray, jstate)),
                                 _leaves(tstate)):
        assert b.dtype == (torch.int32 if path.endswith("step")
                           else torch.float32), path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)
    jnext, jm = jstep(jstate, jb)
    tstate, tm = tstep(tstate, tb)
    _assert_step_close(jnext, jm, tstate, tm)
    # the port's state (after its own step) back to JAX
    tmgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    tmgr.save(tstate, 2)
    tmgr.wait()
    want = convert.train_state_to_numpy(tstate)
    jlike = jax.tree.map(np.asarray, jstate)
    jback, at = JCheckpointManager(str(tmp_path / "port")).restore(jlike)
    assert at == 2
    for (path, a), (_, b) in zip(_leaves(want), _leaves(jback)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=path)
    jnext, jm = jstep(jax.tree.map(jnp.asarray, jback), jb)
    tstate, tm = tstep(tstate, tb)
    _assert_step_close(jnext, jm, tstate, tm)


def test_restart_manager_recovers_from_an_injected_fault(tmp_path):
    _, tcfg = _configs("dense")
    batches = [tapi.make_inputs(tcfg, ShapeSpec("t", "train", 32, 2),
                                seed=s, device="cpu") for s in range(6)]
    opts = TrainOptions(optimizer=OPT)
    step = make_train_step(tcfg, None, opts)

    def run(fail_at, directory):
        state = init_train_state(tcfg, 0, device="cpu", opts=opts)
        mgr = CheckpointManager(str(directory), keep=2, use_async=False)
        failed = []

        def one_step(st, i):
            if i == fail_at and not failed:
                failed.append(i)
                raise RuntimeError("injected worker fault")
            st, _ = step(st, batches[i])
            return st

        rm = RestartManager(save_fn=mgr.save,
                            restore_fn=lambda: mgr.restore(state))
        final, at = rm.run(state, 0, len(batches), one_step,
                           checkpoint_every=2)
        return final, at, rm

    clean, at0, rm0 = run(None, tmp_path / "clean")
    final, at, rm = run(3, tmp_path / "faulty")
    assert at == at0 == len(batches)
    assert rm0.restarts == 0 and rm.restarts == 1
    assert rm.failures[0][0] == 3 and "injected" in rm.failures[0][1]
    for (path, a), (_, b) in zip(_leaves(clean), _leaves(final)):
        assert torch.equal(a, b), path


# --------------------------------------------------------------------------
# mesh refusals and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["make_train_step", "--mesh-data",
                                 "--mesh-model"])
def test_mesh_refusals_name_a15(how):
    """The LM mesh (ROADMAP A15) is ported: the sharded step on a world of
    one's (1, 1) mesh takes the one-device step's values, and the launcher
    refuses a mesh its world cannot hold (``tests/test_torch_mesh.py``
    runs it on 4 processes)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.training import train_loop as TLOOP

    _, tcfg = _configs("dense")
    if how != "make_train_step":
        with pytest.raises(ValueError, match="takes 2 processes, the world "
                                             "has 1"):
            tlaunch.main(["--device", "cpu", "--smoke", how, "2"])
        return
    batch = tapi.make_inputs(tcfg, ShapeSpec("t", "train", 32, 4), seed=0,
                             device="cpu")
    opts = TrainOptions(num_microbatches=2, optimizer=OPT)
    ours = not dist.is_initialized()
    try:
        mesh = lmesh.make_local_mesh(device="cpu")
        sharded = TLOOP.init_train_state_sharded(tcfg, 0, mesh, opts)
        sharded, got = make_train_step(tcfg, mesh, opts)(sharded, batch)
        state, want = make_train_step(tcfg, None, opts)(
            init_train_state(tcfg, 0, device="cpu"), batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6)
        for (path, a), (_, b) in zip(_leaves(TLOOP.local_state(sharded)),
                                     _leaves(state)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-7,
                                       err_msg=path)
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()


def _launch(*argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", "--smoke", *argv], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


def test_launch_train_and_resume_on_cpu(tmp_path):
    ckpt = tmp_path / "ckpt"
    common = ("--batch", "4", "--seq", "64", "--ckpt-dir", str(ckpt),
              "--log-every", "1", "--ckpt-every", "3")
    first = _launch("--steps", "5", *common)
    steps = [ln for ln in first if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)
    assert first[-1].startswith("done: 5 steps in ") and "tok/s" in first[-1]
    assert "filter dropped" in first[-1]
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000005"]
    # resume from step 3: the resumed steps see the batches, and give the
    # lines, of the uninterrupted run
    shutil.rmtree(ckpt / "step_00000005")
    again = _launch("--steps", "5", "--resume", *common)
    assert again[0].startswith("resumed from step 3 in ")
    assert [ln for ln in again if ln.startswith("step ")] == steps[3:]
    assert again[-1].startswith("done: 5 steps in ")


def test_launch_train_layers_cuts_depth(tmp_path):
    """``--layers`` keeps the widths and cuts the depth: the launcher's
    step 0 equals one process's step of the same stream on the cut
    config (and differs from the full depth's)."""
    lines = _launch("--layers", "3", "--steps", "1", "--batch", "4", "--seq",
                    "64", "--ckpt-dir", str(tmp_path / "ckpt"),
                    "--log-every", "1")
    got = next(ln for ln in lines if ln.startswith("step "))
    full = tconfigs.reduce_for_smoke(tconfigs.get_config("tinyllama-1.1b"))
    want = {}
    for depth in (3, full.n_layers):
        cfg = dataclasses.replace(full, n_layers=depth)
        batches, _ = tlaunch.corpus_batches(cfg, 4, 64, [r"SECRET-[0-9]+"],
                                            device="cpu")
        opts = TrainOptions(optimizer=AdamWConfig(
            lr=3e-4, warmup_steps=20, total_steps=1))
        _, m = make_train_step(cfg, None, opts)(
            init_train_state(cfg, 0, device="cpu"),
            tlaunch.batch_to_device(next(batches), "cpu"))
        want[depth] = f"loss {float(m['loss']):.4f}"
    assert want[3] in got and want[full.n_layers] not in got, (got, want)
