"""The LM mesh's partitioned program against the JAX package, on the CPU.

One spawned gloo world of 8 CPU processes on the (2, 2, 2) ("pod", "data",
"model") mesh, each under a time limit, runs every case in one spawn while
a subprocess with 8 forced host devices computes the JAX package's
unsharded answers (the children import no jax).  Reduced configs (2
layers, d_model 64), the JAX package's weights carried to each rank's
blocks by ``convert.params_from_jax(..., mesh=)``, float32 compute on both
sides and the JAX side compiled without XLA's excess precision
(``tests/test_torch_families.py``'s ``_strict``):

  * ``api.prefill`` (every position's logits) and the last-token logits of
    4 decode steps from its cache, against the JAX package's unsharded
    ``api.prefill`` / ``api.decode``, within 1e-5 of the largest |logit|
    and with equal argmax tokens: tinyllama-1.1b's family with 2 kv heads
    (split over "model"), with 1 kv head (``wk``/``wv`` split on head_dim
    and gathered, each rank keeping the kv head its query heads read), and
    granite-moe-1b-a400m (tensor-parallel attention, experts under expert
    parallelism, capacity factor E / top_k);
  * ``api.prefill`` of recurrentgemma-2b and seamless-m4t-medium (their
    rows over the data axes, their weights gathered whole), likewise;
  * each rank's shapes: the cache [L, B / dp, S, local kv heads, H], the
    query heads N / m of ``wq`` and ``wo``, the MLP's hidden columns and
    the vocab rows;
  * the tensor-parallel train step of reduced tinyllama-1.1b and
    granite-moe-1b-a400m against the JAX package's unsharded
    ``make_train_step`` at ``tests/test_torch_mesh.py``'s tolerances (loss
    1e-5, grad_norm 5e-5 relative, each moment leaf 1e-4 of its L2 norm,
    each parameter 2 lr + 1e-6);
  * constrained greedy ``ServingEngine.generate`` on the mesh (each rank
    its rows, its grammar cursors and its masked logits) gives the JAX
    engine's tokens and the port's one-process tokens.

And without a spawn: the (16, 16) dry run of tinyllama-1.1b
``prefill_32k`` and ``decode_32k`` peaks below 80 GiB a rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
MESH = (2, 2, 2)
CHILD_S = 240
# the serving cases: (name, arch, n_kv override or 0)
CASES = {"dense": ("tinyllama-1.1b", 0), "dense_kv1": ("tinyllama-1.1b", 1),
         "moe": ("granite-moe-1b-a400m", 0)}
# the families that gather their weights whole and split only their rows:
# prefill alone
WHOLE = {"hybrid": ("recurrentgemma-2b", 0),
         "encdec": ("seamless-m4t-medium", 0)}
TRAIN = {"dense": "tinyllama-1.1b", "moe": "granite-moe-1b-a400m"}
PREFILL = (8, 24)            # rows, prompt tokens (dp = 4: 2 rows a rank)
DECODE = 4
GENERATE = (8, 16, 6)        # rows, prompt bytes, new tokens
GRAMMAR = r"([0-9]{1,6}[.,] )*[0-9]{0,6}"
STEP_BATCH = (8, 64, 2)      # rows, tokens, microbatches
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
LOGIT_TOL = 1e-5             # of the largest |logit|
F32_TOL = (1e-5, 1e-4, 5e-5)  # loss atol, leaf relative L2, norm rtol


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


def _cfg(arch: str, n_kv: int, torch_side: bool):
    if torch_side:
        from repro_torch.configs import get_config, reduce_for_smoke
    else:
        from repro.configs import get_config, reduce_for_smoke
    cfg = reduce_for_smoke(get_config(arch))
    if n_kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=n_kv)
    if cfg.n_experts:             # E / top_k: no choice drops
        cfg = dataclasses.replace(cfg, capacity_factor=float(
            cfg.n_experts // cfg.top_k))
    return cfg


def _f32_compute(jax_side: bool):
    if jax_side:
        import jax.numpy as jnp

        from repro.models import layers, moe
        layers.Compute = moe.Compute = jnp.float32
    else:
        from repro_torch.models import layers, moe
        layers.Compute = moe.Compute = torch.float32


def _grammar_prompts(rng, b: int, t: int) -> np.ndarray:
    """[b, t] byte prompts made of ``GRAMMAR``'s groups, cut at t."""
    rows = []
    for _ in range(b):
        s = b""
        while len(s) < t:
            digits = rng.choice(np.frombuffer(b"0123456789", np.uint8),
                                size=int(rng.integers(1, 7)))
            sep = rng.choice(np.frombuffer(b".,", np.uint8), size=1)
            s += digits.tobytes() + sep.tobytes() + b" "
        rows.append(np.frombuffer(s[:t], np.uint8).astype(np.int32))
    return np.stack(rows)


# --------------------------------------------------------------------------
# inputs, the JAX package's answers, the children
# --------------------------------------------------------------------------

def _make_inputs(path: pathlib.Path) -> None:
    """The JAX package's weights and train states (numpy), and the
    tokens."""
    import jax

    from repro.models import api as japi
    from repro.training import init_train_state

    rng = np.random.default_rng(0)
    out = {}
    for name, (arch, n_kv) in {**CASES, **WHOLE}.items():
        cfg = _cfg(arch, n_kv, False)
        params = jax.tree.map(np.asarray, japi.init(
            cfg, jax.random.PRNGKey(1)))
        for k, v in _flat(params).items():
            out[f"{name}_params{k}"] = v
        b, t = PREFILL
        out[f"{name}_tokens"] = rng.integers(
            0, cfg.vocab_size, size=(b, t)).astype(np.int32)
        if cfg.family == "encdec":
            out[f"{name}_frames"] = rng.normal(
                0, 1, size=(b, t, cfg.d_model)).astype(np.float32)
        out[f"{name}_decode"] = rng.integers(
            0, cfg.vocab_size, size=(b, DECODE)).astype(np.int32)
    rows, tokens, _ = STEP_BATCH
    for name, arch in TRAIN.items():
        cfg = _cfg(arch, 0, False)
        state = jax.tree.map(np.asarray, init_train_state(
            cfg, jax.random.PRNGKey(2)))
        for k, v in _flat(state).items():
            out[f"train_{name}_state{k}"] = v
        out[f"train_{name}_tokens"] = rng.integers(
            0, cfg.vocab_size, size=(rows, tokens)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, size=(rows, tokens))
        labels[:, :3] = -1                       # ignored positions
        out[f"train_{name}_labels"] = labels.astype(np.int32)
    b, t, _ = GENERATE
    out["prompts"] = _grammar_prompts(np.random.default_rng(3), b, t)
    np.savez(path, **out)


def _tree(z, prefix: str) -> dict:
    return _unflat({k[len(prefix):]: np.array(z[k]) for k in z.files
                    if k.startswith(prefix)})


def _strict(fn, *args):
    import jax
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _jax_reference(inp_path: str, out_path: str) -> None:
    """The JAX package's unsharded answers (run with 8 forced host
    devices)."""
    import jax.numpy as jnp

    from repro.core import compile_regex
    from repro.models import api as japi
    from repro.serving import GrammarConstraint, ServeConfig, ServingEngine
    from repro.training import AdamWConfig, TrainOptions, make_train_step

    _f32_compute(True)
    z = np.load(inp_path)
    out = {}
    for name, (arch, n_kv) in WHOLE.items():
        cfg = _cfg(arch, n_kv, False)
        batch = {k: jnp.asarray(z[f"{name}_{k}"]) for k in ("tokens",
                                                            "frames")
                 if f"{name}_{k}" in z.files}
        logits, _ = _strict(lambda p, b: japi.prefill(
            p, cfg, b, last_only=False), _tree(z, f"{name}_params"), batch)
        out[f"{name}_prefill"] = np.asarray(logits)
    for name, (arch, n_kv) in CASES.items():
        cfg = _cfg(arch, n_kv, False)
        params = _tree(z, f"{name}_params")
        toks = jnp.asarray(z[f"{name}_tokens"])
        logits, cache = _strict(lambda p, b: japi.prefill(
            p, cfg, b, last_only=False), params, {"tokens": toks})
        out[f"{name}_prefill"] = np.asarray(logits)
        t = toks.shape[1]
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, DECODE), (0, 0),
                                (0, 0))) for k, v in cache.items()}
        dec = z[f"{name}_decode"]
        step = None
        for i in range(DECODE):
            batch = {"tokens": jnp.asarray(dec[:, i:i + 1]),
                     "pos": jnp.int32(t + i), "cache": cache}
            if step is None:
                step = _strict_compiled(lambda p, b: japi.decode(p, cfg, b),
                                        params, batch)
            logits, cache = step(params, batch)
            out[f"{name}_decode{i}"] = np.asarray(logits[:, -1])
        if name == "dense":
            b, _, n = GENERATE
            gc = GrammarConstraint(compile_regex(GRAMMAR), cfg.padded_vocab,
                                   eos_id=None)
            out["generate"] = np.asarray(ServingEngine(
                cfg, params, ServeConfig(max_new_tokens=n),
                constraint=gc).generate(z["prompts"]))
    rows, tokens, nm = STEP_BATCH
    for name, arch in TRAIN.items():
        cfg = _cfg(arch, 0, False)
        opts = TrainOptions(num_microbatches=nm,
                            aux_loss_weight=0.0 if name == "moe" else 0.01,
                            optimizer=AdamWConfig(**OPT))
        state = _tree(z, f"train_{name}_state")
        state["opt"]["step"] = np.int32(state["opt"]["step"])
        batch = {"tokens": jnp.asarray(z[f"train_{name}_tokens"]),
                 "labels": jnp.asarray(z[f"train_{name}_labels"])}
        step = _strict_compiled(make_train_step(cfg, None, opts), state,
                                batch)
        new, metrics = step(state, batch)
        for k, v in _flat(jax_tree_np(new)).items():
            out[f"train_{name}_new{k}"] = v
        for k in ("loss", "grad_norm", "lr"):
            out[f"train_{name}_{k}"] = np.asarray(metrics[k])
    np.savez(out_path, **out)


def _strict_compiled(fn, *args):
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def jax_tree_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _child_cases(rank: int, z) -> dict:
    from repro_torch.core import compile_regex
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.fault_tolerance import reshard_tree
    from repro_torch.launch import mesh as lm
    from repro_torch.models import api, convert
    from repro_torch.models import transformer as TF
    from repro_torch.serving import (GrammarConstraint, ServeConfig,
                                     ServingEngine)
    from repro_torch.training import AdamWConfig, TrainOptions
    from repro_torch.training import train_loop as TL

    _f32_compute(False)
    mesh = lm.make_mesh(MESH, ("pod", "data", "model"), device="cpu")
    out = {"coordinate": np.array(mesh.get_coordinate())}
    for name, (arch, n_kv) in WHOLE.items():
        cfg = _cfg(arch, n_kv, True)
        params = convert.params_from_jax(cfg, _tree(z, f"{name}_params"),
                                         device="cpu", mesh=mesh)
        batch = {k: torch.from_numpy(z[f"{name}_{k}"]) for k in (
            "tokens", "frames") if f"{name}_{k}" in z.files}
        logits, _ = api.prefill(params, cfg, batch, mesh=mesh,
                                last_only=False)
        out[f"{name}_prefill"] = logits.numpy()
    for name, (arch, n_kv) in CASES.items():
        cfg = _cfg(arch, n_kv, True)
        tree = _tree(z, f"{name}_params")
        params = convert.params_from_jax(cfg, tree, device="cpu", mesh=mesh)
        lm.reset_mesh_stats()
        toks = torch.from_numpy(z[f"{name}_tokens"])
        logits, cache = api.prefill(params, cfg, {"tokens": toks},
                                    mesh=mesh, last_only=False)
        out[f"{name}_prefill"] = logits.numpy()
        out[f"{name}_cache_shape"] = np.array(cache["k"].shape)
        out[f"{name}_stats"] = np.array(json.dumps(lm.MESH_STATS))
        layer = params["layers"]
        out[f"{name}_shapes"] = np.array(json.dumps({
            "wq": layer["attn"]["wq"].shape, "wk": layer["attn"]["wk"].shape,
            "wo": layer["attn"]["wo"].shape,
            "table": params["embed"]["table"].shape,
            "head": params["head"]["w"].shape,
            **({"wi_gate": layer["mlp"]["wi_gate"].shape}
               if "mlp" in layer else
               {"experts": layer["moe"]["wi_gate"].shape})}))
        t = toks.shape[1]
        big = TF.init_cache(cfg, cache["k"].shape[1], t + DECODE,
                            device="cpu", mesh=mesh)
        for k in big:
            big[k][:, :, :t] = cache[k]
        dec = torch.from_numpy(z[f"{name}_decode"])
        for i in range(DECODE):
            logits, big = api.decode(params, cfg, {
                "tokens": dec[:, i:i + 1], "pos": t + i, "cache": big},
                mesh=mesh)
            out[f"{name}_decode{i}"] = logits[:, -1].numpy()
        if name == "dense":
            b, _, n = GENERATE
            gc = GrammarConstraint(compile_regex(GRAMMAR), cfg.padded_vocab,
                                   eos_id=None, device="cpu")
            out["generate"] = ServingEngine(
                cfg, params, ServeConfig(max_new_tokens=n), constraint=gc,
                mesh=mesh).generate(z["prompts"])
            if rank == 0:
                whole = convert.params_from_jax(cfg, tree, device="cpu")
                out["generate_one"] = ServingEngine(
                    cfg, whole, ServeConfig(max_new_tokens=n),
                    constraint=gc).generate(z["prompts"])
    rows, _, nm = STEP_BATCH
    for name, arch in TRAIN.items():
        cfg = _cfg(arch, 0, True)
        opts = TrainOptions(num_microbatches=nm,
                            aux_loss_weight=0.0 if name == "moe" else 0.01,
                            optimizer=AdamWConfig(**OPT))
        whole = convert.train_state_from_jax(
            cfg, _tree(z, f"train_{name}_state"), device="cpu")
        state = reshard_tree(whole, TL.state_shardings(whole, mesh))
        batch = {"tokens": torch.from_numpy(z[f"train_{name}_tokens"]),
                 "labels": torch.from_numpy(z[f"train_{name}_labels"])}
        step = TL.jit_train_step(cfg, mesh, state,
                                 shr.batch_specs(batch, mesh, rows), opts)
        lm.reset_mesh_stats()
        state, metrics = step(state, batch)
        out[f"train_{name}_stats"] = np.array(json.dumps(lm.MESH_STATS))
        for k, v in _flat(state).items():
            out[f"train_{name}_new{k}"] = lm.whole_on_host(v).numpy()
        for k in ("loss", "grad_norm", "lr"):
            out[f"train_{name}_{k}"] = metrics[k].numpy()
    return out


def _child_main(rank: int, world: int, store: str, inp: str,
                out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=CHILD_S))
    try:
        rep = _child_cases(rank, np.load(inp))
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the ranks' outputs, the JAX package's answers, the inputs)."""
    tmp = tmp_path_factory.mktemp("tp")
    inp = tmp / "inputs.npz"
    _make_inputs(inp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    jenv = {**env, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": (
        "--xla_force_host_platform_device_count=8 "
        + env.get("XLA_FLAGS", "")).strip()}
    ref = tmp / "ref.npz"
    jproc = subprocess.Popen(
        [sys.executable, __file__, "--jax-reference", str(inp), str(ref)],
        env=jenv, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(tmp / "store"),
         str(inp), str(tmp / f"out{r}.npz")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    _run([jproc] + procs, CHILD_S)
    return ([np.load(tmp / f"out{r}.npz") for r in range(WORLD)],
            np.load(ref), np.load(inp))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close_logits(got, want, what):
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    assert gap <= LOGIT_TOL * scale, (what, gap, scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

def test_children_import_no_jax(world):
    outs, _, _ = world
    assert [list(o["foreign"]) for o in outs] == [[]] * WORLD


@pytest.mark.parametrize("case", sorted(CASES) + sorted(WHOLE))
def test_prefill_matches_jax(world, case):
    """Every position's logits of the partitioned prefill, on every rank
    (each returns the whole batch's), against the unsharded JAX
    prefill."""
    outs, want, _ = world
    for r, got in enumerate(outs):
        _close_logits(got[f"{case}_prefill"], want[f"{case}_prefill"],
                      f"{case} rank {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_jax(world, case):
    """The last-token logits of 4 decode steps from the prefill's cache
    (each rank's rows and kv heads) against the unsharded JAX decode."""
    outs, want, _ = world
    for r, got in enumerate(outs):
        for i in range(DECODE):
            _close_logits(got[f"{case}_decode{i}"], want[f"{case}_decode{i}"],
                          f"{case} step {i} rank {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_its_rows_and_heads(world, case):
    """B / dp rows and the local kv heads in the cache; N / m query heads,
    the MLP's hidden columns and the vocab rows in the weights (data
    shards on d_model beside them); one sum over "model" a block."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import api as tapi

    outs, _, _ = world
    arch, n_kv = CASES[case]
    cfg = _cfg(arch, n_kv, True)
    pod, data, m = MESH
    b, t = PREFILL
    kv_local = n_kv or cfg.n_kv_heads // m
    for got in outs:
        assert tuple(got[f"{case}_cache_shape"]) == (
            cfg.n_layers, b // (pod * data), t, kv_local, cfg.hd)
        shapes = json.loads(str(got[f"{case}_shapes"]))
        d_loc = cfg.d_model // data
        assert shapes["wq"] == [cfg.n_layers, d_loc, cfg.n_heads // m,
                                cfg.hd]
        assert shapes["wo"] == [cfg.n_layers, cfg.n_heads // m, cfg.hd,
                                d_loc]
        # one kv head: split on head_dim, as the rules place it
        assert shapes["wk"] == ([cfg.n_layers, d_loc, 1, cfg.hd // m]
                                if n_kv == 1 else
                                [cfg.n_layers, d_loc, cfg.n_kv_heads // m,
                                 cfg.hd])
        assert shapes["table"] == [cfg.padded_vocab // m, d_loc]
        assert shapes["head"] == [d_loc, cfg.padded_vocab // m]
        if cfg.n_experts:
            assert shapes["experts"] == [cfg.n_layers, cfg.n_experts // m,
                                         cfg.d_model, cfg.d_ff]
        else:
            assert shapes["wi_gate"] == [cfg.n_layers, d_loc, cfg.d_ff // m]
        stats = json.loads(str(got[f"{case}_stats"]))
        # the embedding's sum over "model" and two a layer: the attention
        # output's and the MLP's (the MoE's: its aux loss's mean over the
        # token blocks)
        assert stats["all_reduce model"][0] == 2 * cfg.n_layers + 1
        assert stats["all_gather pod,data"][0] == 1     # the logits' rows
    # what the dry run places: the same cache for a decode cell
    spec = tapi.input_specs(cfg, ShapeSpec("d", "decode", t, b),
                            MeshLayout(MESH, ("pod", "data", "model")))
    assert spec["cache"]["k"].shape == (cfg.n_layers, b // (pod * data), t,
                                        kv_local, cfg.hd)


@pytest.mark.parametrize("family", sorted(TRAIN))
def test_train_step_matches_jax(world, family):
    """The tensor-parallel sharded step against the JAX package's
    unsharded step from the same state, float32 compute."""
    outs, want, _ = world
    got = outs[0]
    name = f"train_{family}"
    loss_tol, leaf_tol, norm_tol = F32_TOL
    assert abs(float(got[f"{name}_loss"])
               - float(want[f"{name}_loss"])) <= loss_tol
    jn = float(want[f"{name}_grad_norm"])
    assert abs(float(got[f"{name}_grad_norm"]) - jn) <= norm_tol * jn
    lr = float(want[f"{name}_lr"])
    keys = [k for k in want.files if k.startswith(f"{name}_new")]
    assert sorted(keys) == sorted(k for k in got.files
                                  if k.startswith(f"{name}_new"))
    for k in keys:
        if "/params/" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=k)
        elif "/opt/step" in k:
            assert int(got[k]) == int(want[k]) == 1
        else:
            assert _rel_l2(got[k], want[k]) <= leaf_tol, k
    # the dense layers ran tensor-parallel: sums over "model" in both
    # passes' forward, no gradient summed over it
    stats = json.loads(str(got[f"{name}_stats"]))
    assert stats["all_reduce model"][0] > 0
    assert not any(k.startswith("reduce_scatter") and "model" in k
                   for k in stats)


def test_generate_on_the_mesh_gives_one_process_tokens(world):
    outs, want, _ = world
    one = outs[0]["generate_one"]
    np.testing.assert_array_equal(one, want["generate"])
    for r, got in enumerate(outs):
        np.testing.assert_array_equal(got["generate"], one, err_msg=str(r))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_production_mesh_fits_a_card(tmp_path, shape):
    """tinyllama-1.1b on the (16, 16) fake world: a rank's peak is below
    80 GiB (each rank 2 or 8 rows, 1 of 4 kv heads, 1/256 of the
    weights)."""
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"sys.argv = ['dryrun', '--arch', 'tinyllama-1.1b', '--shape', "
            f"{shape!r}, '--mesh', 'single', '--out', {str(tmp_path)!r}]\n"
            "sys.exit(dryrun.main())\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp_path / "single" / f"tinyllama-1.1b--{shape}.json") as f:
        rec = json.load(f)
    assert rec["ok"], rec.get("error")
    assert rec["memory"]["peak_bytes"] < 80 * 2 ** 30
    # the tokens' rows over "data", the heads over "model"
    assert rec["collectives"]["all-reduce"]["count"] == 2 * 22 + 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    else:
        _child_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4], sys.argv[5])
