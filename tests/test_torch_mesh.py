"""The port's LM mesh against the JAX package, on the CPU.

  * in-process: the sharding rules (``param_specs``, ``opt_state_specs``,
    ``batch_specs``, ``cache_specs``, ``state_specs``) equal the JAX
    package's PartitionSpecs leaf by leaf, for every registered
    architecture at full width (shapes only) on meshes (16, 16),
    (2, 16, 16), (2, 2, 2), (2, 2) and (1, 1) (the JAX side reads a
    stand-in mesh: its rules read only axis names and extents); the mesh
    constructors on a world of one; ``quantize``/``dequantize`` bit for
    bit, with exact .5 ties (both round half to even);
  * one spawned gloo world of 8 CPU processes on the (2, 2, 2) ("pod",
    "data", "model") mesh, each under a time limit, running every case in
    one spawn while a subprocess with 8 forced host devices computes the
    JAX package's answers (the children import no jax):
      - ``hierarchical_merge_lvecs``, ``flat_merge_lvecs`` and
        ``distributed_membership`` (both ``spec_match`` routes) equal the
        JAX functions' results; ``hierarchical_mean`` equals the two-tier
        mean of different trees on every rank;
      - ``compressed_pod_mean``, two rounds, different gradients on each
        pod (with ties), equals the reference's arithmetic (its
        ``quantize``/``dequantize``) bit for bit;
      - ``pipeline_apply`` on a 4-rank ("stage",) mesh equals the JAX
        function and the sequential stages within 1e-5;
      - ``moe_mlp(mesh=)`` equals the JAX package's ``moe_mlp(mesh=)``
        (``_moe_sharded``, under ``set_mesh``) at the published capacity
        factor, output, aux loss and the gradients of ``sum(out * w) +
        0.01 aux`` in float32 compute within 1e-5 relative;
      - the sharded train step of reduced tinyllama-1.1b,
        granite-moe-1b-a400m, recurrentgemma-2b, xlstm-1.3b and
        seamless-m4t-medium (2 microbatches; each family's layers gather
        their weights inside the rematerialised body) equals the JAX
        package's
        unsharded ``make_train_step(cfg, None, opts)`` from the same state
        in float32 compute, to ``tests/test_torch_training.py``'s float32
        tolerances: loss 1e-5, grad_norm 5e-5 relative, each moment leaf
        1e-4 of its L2 norm, each parameter 2 lr + 1e-6.  For the MoE the
        capacity factor is 2.0
        (E / top_k: no choice drops) and the aux weight 0: the sharded
        layer averages each token block's aux loss, as ``_moe_sharded``
        does, which is not the whole batch's (the layer case above holds
        the aux loss and its gradient to ``_moe_sharded``);
      - then two int8 steps of the MoE: finite losses, the second below
        the first + 0.5 (the reference test's rule);
      - elastic reshard: the int8 state saved on (2, 2, 2), restored on
        (2, 2) (ranks 0-3): every leaf bitwise equal;
  * the launcher: ``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.train --device cpu --smoke --mesh-data 2
    --mesh-model 2`` for 2 steps prints the one-process run's losses
    within 2e-3 (``test_torch_training``'s bf16 loss tolerance: the ranks'
    bf16 products round per row block) and its gradient norms within 1e-2
    relative.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(16, 16), (2, 16, 16), (2, 2, 2), (2, 2), (1, 1)]
WORLD = 8
CHILD_S = 240
ARCHS = {"dense": "tinyllama-1.1b", "moe": "granite-moe-1b-a400m",
         "hybrid": "recurrentgemma-2b", "ssm": "xlstm-1.3b",
         "encdec": "seamless-m4t-medium"}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
STEP_BATCH = (8, 64, 2)      # rows, tokens, microbatches
MOE_LAYER = (32, 64, 4, 2, (4, 8))   # d, d_ff, experts, top_k, (B, T)
# (loss atol, leaf relative L2, global-norm rtol): test_torch_training's
# float32 row of GRAD_TOL
F32_TOL = (1e-5, 1e-4, 5e-5)


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for key, x in flat.items():
        node = out
        parts = key.strip("/").split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = x
    return out


# --------------------------------------------------------------------------
# the sharding rules, in process
# --------------------------------------------------------------------------

class _JMesh:
    """What the JAX package's rules read of a mesh."""

    def __init__(self, shape):
        self.axis_names = _names(shape)
        self.shape = dict(zip(self.axis_names, shape))


def _as_placements(spec, names, ndim):
    """A JAX PartitionSpec as one placement per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    out = []
    for name in names:
        dims = [d for d, e in enumerate(entries)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _assert_specs_equal(jspecs, tspecs, jtree, names, what):
    import jax
    from jax.sharding import PartitionSpec as P
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, P))[0])
    shapes = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    tflat = _flat(tspecs)
    assert len(jflat) == len(tflat), what
    for path, spec in jflat.items():
        key = "/" + "/".join(str(getattr(k, "key", k)) for k in path)
        want = _as_placements(spec, names, len(shapes[path].shape))
        assert tflat[key] == want, (what, key, tflat[key], spec)


@pytest.mark.parametrize("shape", MESHES,
                         ids=["x".join(map(str, s)) for s in MESHES])
@pytest.mark.parametrize("arch", sorted(
    __import__("repro_torch.configs", fromlist=["list_archs"]).list_archs()))
def test_specs_match_jax(arch, shape):
    import jax
    import jax.numpy as jnp

    from repro.configs import ShapeSpec, get_config
    from repro.distributed import sharding as JSHR
    from repro.models import api as japi
    from repro_torch.configs import get_config as tget_config
    from repro_torch.distributed import sharding as TSHR
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import api as tapi

    names = _names(shape)
    jmesh, layout = _JMesh(shape), MeshLayout(shape, names)
    cfg, tcfg = get_config(arch), tget_config(arch)
    shapes = tapi.param_shapes(tcfg)
    jtree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
    _assert_specs_equal(JSHR.param_specs(jtree, jmesh),
                        TSHR.param_specs(shapes, layout), jtree, names,
                        "param_specs")
    _assert_specs_equal(JSHR.opt_state_specs(jtree, jmesh),
                        TSHR.opt_state_specs(shapes, layout), jtree, names,
                        "opt_state_specs")
    for b in (32, 6):
        for kind in ("train", "decode"):
            sp = ShapeSpec("s", kind, 1024, b)
            jb, tb = japi.input_specs(cfg, sp), tapi.input_specs(tcfg, sp)
            _assert_specs_equal(JSHR.batch_specs(jb, jmesh, b),
                                TSHR.batch_specs(tb, layout, b), jb, names,
                                f"batch_specs {kind} B={b}")
            if kind == "decode" and "cache" in jb:
                _assert_specs_equal(
                    JSHR.cache_specs(jb["cache"], jmesh, b),
                    TSHR.cache_specs(tb["cache"], layout, b), jb["cache"],
                    names, f"cache_specs B={b}")
            if kind == "decode" and "state" in jb:
                _assert_specs_equal(
                    JSHR.state_specs(jb["state"], jmesh, b),
                    TSHR.state_specs(tb["state"], layout, b), jb["state"],
                    names, f"state_specs B={b}")


# --------------------------------------------------------------------------
# meshes on a world of one, quantisation
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """A world of one for this module (destroyed after it, so later files
    of an xdist worker start without one)."""
    ours = not dist.is_initialized()
    yield
    if ours and dist.is_initialized():
        dist.destroy_process_group()


def test_meshes_on_a_world_of_one(world):
    import jax

    from repro.launch import mesh as JM
    from repro_torch.launch import mesh as TM

    mesh = TM.make_local_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (1, 1)
    assert mesh.transport == "gloo" and mesh.device == torch.device("cpu")
    assert TM.mesh_info(mesh) == JM.mesh_info(JM.make_local_mesh())
    assert TM.dp_axes(mesh) == ("data",)
    assert TM.make_local_mesh(device="cpu") is mesh     # groups cached
    # the reference's message, on this process's jax devices and the world
    n = len(jax.devices())
    for data, model in ((3, 3), (n + 1, 1)):
        with pytest.raises(ValueError) as want:
            JM.make_local_mesh(data, model)
        with pytest.raises(ValueError) as got:
            TM.make_local_mesh(data, model)
        assert str(got.value) == str(want.value).replace(f"have {n}",
                                                         "have 1")
    for multi, msg in ((False, "mesh 16x16 needs 256 devices, have 1"),
                       (True, "mesh 2x16x16 needs 512 devices, have 1")):
        with pytest.raises(ValueError, match=msg):
            TM.make_production_mesh(multi_pod=multi)
    big = TM.MeshLayout((2, 16, 16), ("pod", "data", "model"))
    assert TM.dp_axes(big) == ("pod", "data")
    assert TM.mesh_info(big) == {"axes": {"pod": 2, "data": 16,
                                          "model": 16},
                                 "n_devices": 512, "dp": 32, "tp": 16}
    # the collectives of a one-rank mesh are identities
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(TM.all_gather(x, mesh, "data"), x)
    assert torch.equal(TM.all_reduce(x, mesh, ("data", "model")), x)
    assert torch.equal(TM.permute(x, mesh, "model"), torch.zeros_like(x))


def test_mesh_modules_import_without_jax_and_default_to_the_card():
    """The slice's modules import with jax blocked, and an LM mesh asked
    for no device wants the card (none here)."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.distributed.collectives\n"
            "import repro_torch.distributed.compression\n"
            "import repro_torch.distributed.pipeline\n"
            "import repro_torch.launch.mesh, repro_torch.training\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)\n"
            "import torch\n"
            "from repro_torch.launch.mesh import make_local_mesh\n"
            "if not torch.cuda.is_available():\n"
            "    try:\n"
            "        make_local_mesh()\n"
            "    except RuntimeError as e:\n"
            "        assert 'CUDA' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit('no card, yet a mesh')\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("case", ["ties", "normal", "zeros", "tiny"])
def test_quantize_bit_for_bit(case):
    import jax.numpy as jnp

    from repro.distributed import compression as JC
    from repro_torch.distributed import compression as TC

    rng = np.random.default_rng(3)
    g = {"ties": np.arange(-254, 255, dtype=np.float32) / 2,
         "normal": rng.normal(size=(64, 33)).astype(np.float32),
         "zeros": np.zeros((5, 4), np.float32),
         "tiny": rng.normal(size=(17,)).astype(np.float32) * 1e-14}[case]
    jq, js = JC.quantize(jnp.asarray(g))
    tq, ts = TC.quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(
        TC.dequantize(tq, ts).numpy(), np.asarray(JC.dequantize(jq, js)))
    if case == "ties":
        # g / scale lands on every half: round half to even
        assert np.asarray(jq)[1:6].tolist() == [-126, -126, -126, -125,
                                                 -124]


# --------------------------------------------------------------------------
# the spawned world: inputs, the JAX package's answers, the children
# --------------------------------------------------------------------------

def _f32_compute(jax_side: bool):
    """Both the layers' and the MoE's compute dtype set to float32."""
    if jax_side:
        import jax.numpy as jnp

        from repro.models import layers, moe
        layers.Compute = moe.Compute = jnp.float32
    else:
        from repro_torch.models import layers, moe
        layers.Compute = moe.Compute = torch.float32


def _step_cfg(family: str, torch_side: bool):
    if torch_side:
        from repro_torch.configs import get_config, reduce_for_smoke
    else:
        from repro.configs import get_config, reduce_for_smoke
    cfg = reduce_for_smoke(get_config(ARCHS[family]))
    if family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=2.0)
    return cfg


def _make_inputs(path: pathlib.Path) -> None:
    """Every input, from numpy seeds and the port's initialiser (the JAX
    steps start from the same numbers)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.core import random_dfa
    from repro_torch.models import api as tapi
    from repro_torch.training import init_train_state

    rng = np.random.default_rng(0)
    out = {"maps": rng.integers(0, 33, size=(16, 33)).astype(np.int32)}
    for tag, q, ncls in (("small", 29, 6), ("big", 300, 5)):
        dfa = random_dfa(q, ncls, rng=np.random.default_rng(7 + q))
        out[f"dfa_{tag}_table"] = dfa.table
        out[f"dfa_{tag}_meta"] = np.array([dfa.start, dfa.sink], np.int32)
        out[f"dfa_{tag}_accepting"] = dfa.accepting
        out[f"dfa_{tag}_classes"] = rng.integers(
            0, ncls, size=10_007).astype(np.int32)
    out["mean_a"] = rng.normal(size=(WORLD, 4, 3)).astype(np.float32)
    out["mean_b"] = rng.normal(size=(WORLD, 5)).astype(np.float32)
    # per-pod gradients; pod 0's land on exact halves of their scale (1)
    out["pod_g"] = np.stack([
        np.arange(-254, 254, dtype=np.float32).reshape(4, 127) / 2,
        rng.normal(size=(4, 127)).astype(np.float32)])
    out["pod_g2"] = rng.normal(size=(2, 4, 127)).astype(np.float32)
    out["pipe_w"] = (rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
    out["pipe_x"] = rng.normal(size=(6, 2, 16)).astype(np.float32)
    d, f, e, _, (b, t) = MOE_LAYER
    out["moe_router"] = rng.normal(0, d ** -0.5, (d, e)).astype(np.float32)
    out["moe_wi_gate"] = rng.normal(0, d ** -0.5, (e, d, f)).astype(
        np.float32)
    out["moe_wi_up"] = rng.normal(0, d ** -0.5, (e, d, f)).astype(np.float32)
    out["moe_wo"] = rng.normal(0, f ** -0.5, (e, f, d)).astype(np.float32)
    out["moe_x"] = rng.normal(size=(b, t, d)).astype(np.float32)
    out["moe_w"] = rng.normal(size=(b, t, d)).astype(np.float32)
    rows, tokens, _ = STEP_BATCH
    for family in ARCHS:
        cfg = _step_cfg(family, True)
        state = init_train_state(cfg, 0, device="cpu")
        for k, v in _flat(state).items():
            out[f"{family}_state{k}"] = v.numpy()
        batch = tapi.make_inputs(cfg, ShapeSpec("t", "train", tokens, rows),
                                 seed=0, device="cpu")
        for k, v in batch.items():
            # bf16 frames as float32 (exact; float32 compute reads them so)
            out[f"{family}_batch_{k}"] = v.float().numpy() \
                if v.dtype == torch.bfloat16 else v.numpy()
    np.savez(path, **out)


def _jax_reference(inp_path: str, out_path: str) -> None:
    """The JAX package's answers (run with 8 forced host devices)."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import collectives as JC
    from repro.distributed import compression as JQ
    from repro.distributed.pipeline import pipeline_apply
    from repro.jax_compat import set_mesh
    from repro.models import moe as JMOE
    from repro.training import AdamWConfig, TrainOptions, make_train_step

    z = np.load(inp_path)
    out = {}
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    maps = jnp.asarray(z["maps"])
    out["hier"] = np.asarray(JC.hierarchical_merge_lvecs(maps, mesh))
    out["flat"] = np.asarray(JC.flat_merge_lvecs(maps, mesh))
    for tag in ("small", "big"):
        start, sink = (int(v) for v in z[f"dfa_{tag}_meta"])
        out[f"member_{tag}"] = np.array(JC.distributed_membership(
            z[f"dfa_{tag}_table"], z[f"dfa_{tag}_classes"], start, sink,
            z[f"dfa_{tag}_accepting"], mesh))
    same = {"a": jnp.asarray(z["mean_a"][0]), "b": jnp.asarray(z["mean_b"][0])}
    got = JC.hierarchical_mean(same, mesh)
    out["mean_same_a"], out["mean_same_b"] = (np.asarray(got["a"]),
                                              np.asarray(got["b"]))
    # the reference's arithmetic for the compressed mean, pod by pod
    err = [np.zeros_like(z["pod_g"][0]) for _ in range(2)]
    for r, g in enumerate((z["pod_g"], z["pod_g2"])):
        deq = []
        for p in range(2):
            corrected = jnp.asarray(g[p]) + err[p]
            q, s = JQ.quantize(corrected)
            err[p] = np.asarray(corrected - JQ.dequantize(q, s))
            deq.append(np.asarray(q, np.float32) * np.asarray(s))
        out[f"pod_mean{r}"] = np.asarray(jnp.mean(jnp.stack(deq), axis=0))
        out[f"pod_err{r}"] = np.stack(err)
    smesh = jax.make_mesh((4,), ("stage",), devices=jax.devices()[:4])
    out["pipe"] = np.asarray(pipeline_apply(
        lambda w, x: jnp.tanh(x @ w), jnp.asarray(z["pipe_w"]),
        jnp.asarray(z["pipe_x"]), smesh))

    _f32_compute(True)
    p = {k: jnp.asarray(z[f"moe_{k}"])
         for k in ("router", "wi_gate", "wi_up", "wo")}
    _, _, _, top_k, _ = MOE_LAYER

    def layer(p, x, w):
        y, aux = JMOE.moe_mlp(p, x, top_k=top_k, mesh=mesh)
        return jnp.sum(y * w) + 0.01 * aux, (y, aux)

    with set_mesh(mesh):
        fn = jax.jit(jax.value_and_grad(layer, argnums=(0, 1),
                                        has_aux=True))
        (_, (y, aux)), (gp, gx) = fn(p, jnp.asarray(z["moe_x"]),
                                     jnp.asarray(z["moe_w"]))
    out["moe_out"], out["moe_aux"] = np.asarray(y), np.asarray(aux)
    out["moe_gx"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"moe_g_{k}"] = np.asarray(v)

    rows, tokens, nm = STEP_BATCH
    for family in ARCHS:
        cfg = _step_cfg(family, False)
        opts = TrainOptions(num_microbatches=nm,
                            aux_loss_weight=0.0 if family == "moe" else 0.01,
                            optimizer=AdamWConfig(**OPT))
        state = _unflat({k[len(f"{family}_state"):]: np.array(z[k])
                         for k in z.files if k.startswith(f"{family}_state")})
        state["opt"]["step"] = np.int32(state["opt"]["step"])
        batch = {k[len(f"{family}_batch_"):]: jnp.asarray(z[k])
                 for k in z.files if k.startswith(f"{family}_batch_")}
        step = jax.jit(make_train_step(cfg, None, opts)).lower(
            state, batch).compile(
                compiler_options={"xla_allow_excess_precision": False})
        new, metrics = step(state, batch)
        for k, v in _flat(jax.tree.map(np.asarray, new)).items():
            out[f"{family}_new{k}"] = v
        for k in ("loss", "grad_norm", "lr"):
            out[f"{family}_{k}"] = np.asarray(metrics[k])
    np.savez(out_path, **out)


def _child_cases(rank: int, z, ckpt: str) -> dict:
    from repro_torch.distributed import collectives as TC
    from repro_torch.distributed import compression as TQ
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.fault_tolerance import reshard_tree
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import mesh as lm
    from repro_torch.models import convert
    from repro_torch.models import moe as TMOE
    from repro_torch.training import (AdamWConfig, CheckpointManager,
                                      TrainOptions)
    from repro_torch.training import train_loop as TL

    out = {}
    mesh = lm.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    maps = torch.from_numpy(z["maps"])
    out["hier"] = TC.hierarchical_merge_lvecs(maps, mesh).numpy()
    out["flat"] = TC.flat_merge_lvecs(maps, mesh).numpy()
    for tag in ("small", "big"):
        start, sink = (int(v) for v in z[f"dfa_{tag}_meta"])
        out[f"member_{tag}"] = np.array(TC.distributed_membership(
            z[f"dfa_{tag}_table"], z[f"dfa_{tag}_classes"], start, sink,
            z[f"dfa_{tag}_accepting"], mesh))
    mine = {"a": torch.from_numpy(z["mean_a"][rank]),
            "b": torch.from_numpy(z["mean_b"][rank])}
    got = TC.hierarchical_mean(mine, mesh)
    out["mean_a"], out["mean_b"] = got["a"].numpy(), got["b"].numpy()
    same = {"a": torch.from_numpy(z["mean_a"][0]),
            "b": torch.from_numpy(z["mean_b"][0])}
    got = TC.hierarchical_mean(same, mesh)
    out["mean_same_a"], out["mean_same_b"] = (got["a"].numpy(),
                                              got["b"].numpy())
    pod = mesh.coordinate("pod")
    err = TQ.init_error_state({"w": torch.zeros(4, 127)})
    for r, g in enumerate((z["pod_g"], z["pod_g2"])):
        mean, err = TQ.compressed_pod_mean(
            {"w": torch.from_numpy(g[pod])}, err, mesh)
        out[f"pod_mean{r}"], out[f"pod_err{r}"] = (mean["w"].numpy(),
                                                   err["w"].numpy())
    smesh = lm.make_mesh((4,), ("stage",), device="cpu")
    if smesh.get_coordinate() is not None:
        out["pipe"] = pipeline_apply(
            lambda w, x: torch.tanh(x @ w), torch.from_numpy(z["pipe_w"]),
            torch.from_numpy(z["pipe_x"]), smesh).numpy()

    _f32_compute(False)
    _, _, e, top_k, _ = MOE_LAYER
    m = mesh.coordinate("model")
    part = e // 2
    p = {k: torch.from_numpy(z[f"moe_{k}"]).requires_grad_()
         for k in ("router", "wi_gate", "wi_up", "wo")}
    shard = {k: v if k == "router" else v[m * part:(m + 1) * part]
             for k, v in p.items()}
    x = torch.from_numpy(z["moe_x"]).requires_grad_()
    y, aux = TMOE.moe_mlp(shard, x, top_k=top_k, mesh=mesh)
    (torch.sum(y * torch.from_numpy(z["moe_w"])) + 0.01 * aux).backward()
    out["moe_out"], out["moe_aux"] = y.detach().numpy(), aux.detach().numpy()
    out["moe_gx"] = x.grad.numpy()
    for k, v in p.items():
        g = v.grad if k == "router" else v.grad[m * part:(m + 1) * part]
        out[f"moe_g_{k}"] = g.numpy()

    rows, tokens, nm = STEP_BATCH
    for family in ARCHS:
        cfg = _step_cfg(family, True)
        opts = TrainOptions(num_microbatches=nm,
                            aux_loss_weight=0.0 if family == "moe" else 0.01,
                            optimizer=AdamWConfig(**OPT))
        host = _unflat({k[len(f"{family}_state"):]: np.array(z[k])
                        for k in z.files if k.startswith(f"{family}_state")})
        whole = convert.train_state_from_jax(cfg, host, device="cpu")
        state = reshard_tree(whole, TL.state_shardings(whole, mesh))
        batch = {k[len(f"{family}_batch_"):]: torch.from_numpy(z[k])
                 for k in z.files if k.startswith(f"{family}_batch_")}
        step = TL.jit_train_step(cfg, mesh, state,
                                 shr.batch_specs(batch, mesh, rows), opts)
        state, metrics = step(state, batch)
        for k, v in _flat(state).items():
            out[f"{family}_new{k}"] = lm.whole_on_host(v).numpy()
        for k in ("loss", "grad_norm", "lr"):
            out[f"{family}_{k}"] = metrics[k].numpy()

    # two int8 steps of the MoE (default aux weight), then the elastic
    # reshard of that state: saved on (2, 2, 2), restored on (2, 2)
    from repro_torch.configs import get_config, reduce_for_smoke
    cfg = reduce_for_smoke(get_config(ARCHS["moe"]))
    opts = TrainOptions(num_microbatches=nm, grad_compression="int8",
                        optimizer=AdamWConfig(**OPT))
    state = TL.init_train_state_sharded(cfg, 0, mesh, opts)
    batch = {k[len("moe_batch_"):]: torch.from_numpy(z[k])
             for k in z.files if k.startswith("moe_batch_")}
    step = TL.make_train_step(cfg, mesh, opts)
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    out["int8_losses"] = np.array(losses)
    out["int8_err_norm"] = np.array(sum(
        float(torch.sum(v.to_local() ** 2)) for v in _flat(state["err"])
        .values()))
    mgr = CheckpointManager(ckpt, use_async=False)
    mgr.save(state, 2)
    saved = {k: lm.whole_on_host(v) for k, v in _flat(state).items()}
    mesh_b = lm.make_local_mesh(2, 2, device="cpu")
    mgr.wait()
    if mesh_b.get_coordinate() is not None:
        back, at = mgr.restore(state, TL.state_shardings(state, mesh_b))
        flat = _flat(back)
        out["reshard_step"] = np.array(at)
        out["reshard_equal"] = np.array(sorted(flat) == sorted(saved) and all(
            torch.equal(lm.whole_on_host(flat[k]), saved[k]) for k in saved))
        out["reshard_local"] = np.array(
            [int(np.prod(v.to_local().shape)) for v in flat.values()])
    return out


def _child_main(rank: int, world: int, store: str, inp: str, out_path: str,
                ckpt: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=CHILD_S))
    try:
        rep = _child_cases(rank, np.load(inp), ckpt)
        rep["foreign"] = np.array(sorted(
            m for m in sys.modules if m in ("jax", "repro")
            or m.startswith(("jax.", "repro."))), dtype=str)
        np.savez(out_path, **rep)
    finally:
        dist.destroy_process_group()


def _run(procs, limit):
    t0, logs = time.monotonic(), []
    try:
        for p in procs:
            left = limit - (time.monotonic() - t0)
            logs.append(p.communicate(timeout=max(left, 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(i, p.returncode, log[-3000:])
              for i, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, failed
    return logs


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_spawned_world(tmp_path):
    """Eight gloo ranks on (2, 2, 2), every case in one spawn, beside the
    JAX package's answers from a subprocess of 8 forced host devices."""
    inp = tmp_path / "inputs.npz"
    _make_inputs(inp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    jenv = {**env, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": (
        "--xla_force_host_platform_device_count=8 "
        + env.get("XLA_FLAGS", "")).strip()}
    ref = tmp_path / "ref.npz"
    jproc = subprocess.Popen(
        [sys.executable, __file__, "--jax-reference", str(inp), str(ref)],
        env=jenv, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD),
         str(tmp_path / "store"), str(inp), str(tmp_path / f"out{r}.npz"),
         str(tmp_path / "ckpt")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    _run([jproc] + procs, CHILD_S)
    want = np.load(ref)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    z = np.load(inp)
    for r, got in enumerate(outs):
        assert list(got["foreign"]) == [], r
        # collectives: integer results exactly
        for k in ("hier", "flat", "member_small", "member_big"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {r}")
        # the two-tier mean of each rank's own tree
        coord = np.unravel_index(r, (2, 2, 2))
        for k in ("a", "b"):
            vals = z[f"mean_{k}"].reshape((2, 2, 2) + z[f"mean_{k}"]
                                          .shape[1:])
            data = vals.mean(axis=1, keepdims=True)      # over "data"
            pods = data.mean(axis=0)                     # then over "pod"
            np.testing.assert_allclose(got[f"mean_{k}"],
                                       pods[0, coord[2]], rtol=1e-6)
            np.testing.assert_array_equal(got[f"mean_same_{k}"],
                                          want[f"mean_same_{k}"])
        # the int8 pod mean: the reference's arithmetic, bit for bit
        for i in range(2):
            np.testing.assert_array_equal(got[f"pod_mean{i}"],
                                          want[f"pod_mean{i}"])
            np.testing.assert_array_equal(got[f"pod_err{i}"],
                                          want[f"pod_err{i}"][coord[0]])
        if r < 4:
            seq = z["pipe_x"]
            for i in range(4):
                seq = np.tanh(seq @ z["pipe_w"][i])
            np.testing.assert_allclose(got["pipe"], want["pipe"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["pipe"], seq, rtol=1e-5,
                                       atol=1e-5)
        # expert parallelism against _moe_sharded, float32 compute
        for k in ("moe_out", "moe_aux", "moe_gx", "moe_g_router"):
            assert _rel_l2(got[k], want[k]) <= 1e-5, (k, r)
        e = MOE_LAYER[2] // 2
        m = coord[2]
        for k in ("wi_gate", "wi_up", "wo"):
            assert _rel_l2(got[f"moe_g_{k}"],
                           want[f"moe_g_{k}"][m * e:(m + 1) * e]) <= 1e-5, \
                (k, r)
    # the sharded steps against the unsharded JAX step (rank 0's gathers;
    # every rank gathered the same)
    got = outs[0]
    loss_tol, leaf_tol, norm_tol = F32_TOL
    for family in ARCHS:
        assert abs(float(got[f"{family}_loss"])
                   - float(want[f"{family}_loss"])) <= loss_tol, family
        jn = float(want[f"{family}_grad_norm"])
        assert abs(float(got[f"{family}_grad_norm"]) - jn) <= norm_tol * jn
        lr = float(want[f"{family}_lr"])
        assert abs(float(got[f"{family}_lr"]) - lr) <= 1e-6 * lr
        keys = [k for k in want.files if k.startswith(f"{family}_new")]
        assert sorted(keys) == sorted(k for k in got.files
                                      if k.startswith(f"{family}_new"))
        for k in keys:
            if "/params/" in k:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=2 * lr + 1e-6, err_msg=k)
            elif "/opt/step" in k:
                assert int(got[k]) == int(want[k]) == 1
            else:
                assert _rel_l2(got[k], want[k]) <= leaf_tol, k
    # int8: the reference test's rule, on every rank alike
    l1, l2 = outs[0]["int8_losses"]
    assert np.isfinite(l1) and np.isfinite(l2) and l2 < l1 + 0.5
    assert all(np.array_equal(o["int8_losses"], outs[0]["int8_losses"])
               for o in outs)
    assert float(outs[0]["int8_err_norm"]) > 0
    # elastic reshard onto (2, 2): every leaf bitwise, each rank a quarter
    for r in range(4):
        assert int(outs[r]["reshard_step"]) == 2
        assert bool(outs[r]["reshard_equal"]), r
    assert os.listdir(tmp_path / "ckpt") == ["step_00000002"]


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _steps(text: str) -> list[tuple[int, float, float]]:
    return [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
        r"^step +(\d+) loss ([0-9.]+) gnorm ([0-9.]+)", text, re.M)]


def test_launcher_on_a_mesh_matches_one_process(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    common = ["--device", "cpu", "--smoke", "--steps", "2", "--batch", "4",
              "--seq", "64", "--log-every", "1"]
    mesh = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", *common, "--mesh-data", "2",
         "--mesh-model", "2", "--ckpt-dir", str(tmp_path / "mesh")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    one = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--ckpt-dir", str(tmp_path / "one")], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    got, want = (_steps(log) for log in _run([mesh, one], CHILD_S))
    assert [s[0] for s in want] == [0, 1] and [s[0] for s in got] == [0, 1]
    for (_, loss, gnorm), (_, wloss, wgnorm) in zip(got, want):
        assert abs(loss - wloss) <= 2e-3, (got, want)
        assert abs(gnorm - wgnorm) <= 1e-2 * wgnorm, (got, want)
    # rank 0 alone wrote the checkpoint
    assert os.listdir(tmp_path / "mesh") == ["step_00000002"]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    else:
        _child_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4], sys.argv[5], sys.argv[6])
