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
    4 decode steps, against the JAX package's unsharded ``api.prefill`` /
    ``api.decode``, within 1e-5 of the largest |logit| and with equal
    argmax tokens: tinyllama-1.1b's family with 2 kv heads (split over
    "model"), with 1 kv head (``wk``/``wv`` split on head_dim and
    gathered, each rank keeping the kv head its query heads read),
    granite-moe-1b-a400m (tensor-parallel attention, experts under expert
    parallelism, capacity factor E / top_k), recurrentgemma-2b (the
    RG-LRU's channels split over "model", its attention's query heads;
    with 3 query heads, ``hybrid_h3``, the attention split on head_dim:
    each rank its columns of every head, its ring their block), xlstm-1.3b
    (the mLSTM's heads and the sLSTM's channels; with 1 head, ``ssm_h1``,
    the mLSTM split on head_dim: ``C``'s value columns and ``n``'s key
    columns a rank, ``h`` exchanged to the rank's columns) and
    seamless-m4t-medium
    (encoder, decoder and cross-attention heads).  The transformer and
    enc-dec decode from the prefill's cache (the enc-dec against a random
    encoder memory), the hybrid and ssm from their zero state;
  * each rank's shapes: the cache [L, B / dp, S, local kv heads, H], the
    query heads N / m of ``wq`` and ``wo``, the MLP's hidden columns and
    the vocab rows; the RG-LRU's d_rnn / m channels in its leaves and
    state, the mLSTM's N / m heads, the sLSTM's D / m channels; the split
    cases' ring and state the block ``sharding.state_specs`` places, and
    no gather over "model" of their ``wv``/``wo`` (attention) or ``wv``
    (mLSTM) in a prefill, a decode step or a train step;
  * the tensor-parallel train step of reduced tinyllama-1.1b,
    granite-moe-1b-a400m, recurrentgemma-2b (and ``hybrid_h3``),
    xlstm-1.3b (and ``ssm_h1``) and seamless-m4t-medium against the JAX
    package's unsharded
    ``make_train_step`` at ``tests/test_torch_mesh.py``'s tolerances (loss
    1e-5, grad_norm 5e-5 relative, each moment leaf 1e-4 of its L2 norm,
    each parameter 2 lr + 1e-6), with the loss vocab-parallel: each rank
    reduces its [rows, T, V / m] logits over "model" (a max, a sum of exp
    and the gold logit, [rows, T] floats each) and gathers no logits;
  * ``layers.vocab_parallel_nll`` of each rank's vocab half against
    ``lm_loss`` of the whole logits (the port's and the JAX package's),
    value and gradient, with ignored labels and the last padded column;
  * constrained greedy ``ServingEngine.generate`` on the mesh (each rank
    its rows, its grammar cursors and its masked logits) gives the JAX
    engine's tokens and the port's one-process tokens.

And without a spawn: the (16, 16) dry run of tinyllama-1.1b
``prefill_32k`` and ``decode_32k`` peaks below 80 GiB a rank, and
xlstm-1.3b's ``decode_32k`` below 0.5 GiB; the rank's decode state or
cache that ``api.input_specs`` gives the hybrid, ssm and enc-dec families
on (16, 16); ``launch.mesh.scatter_parts``' gradient against the adjoint
of its sum, on a stand-in axis of 4 ranks; and, on an axis of 4 ranks run
as threads of one process, ``vocab_parallel_nll``'s gradient against
``lm_loss``'s, and a head_dim split's decode step and prefill (the
attention's, the ring's, the mLSTM's) against one process in value and
gradient.
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
# the spawn's limit: the JAX subprocess's strict compiles (8 serving cases,
# 5 train steps) are its longest part, ~60 s alone and ~190 s beside five
# other pytest workers
CHILD_S = 420
# the serving cases: name -> (arch, config overrides)
CASES = {"dense": ("tinyllama-1.1b", {}),
         "dense_kv1": ("tinyllama-1.1b", {"n_kv_heads": 1}),
         "moe": ("granite-moe-1b-a400m", {}),
         "hybrid": ("recurrentgemma-2b", {}),
         "hybrid_h3": ("recurrentgemma-2b", {"n_heads": 3}),
         "ssm": ("xlstm-1.3b", {}),
         "ssm_h1": ("xlstm-1.3b", {"n_heads": 1, "n_kv_heads": 1}),
         "encdec": ("seamless-m4t-medium", {})}
# the train cases: name -> (arch, config overrides); ``hybrid_h3`` and
# ``ssm_h1`` split their attention and mLSTM on head_dim over "model"
TRAIN = {"dense": ("tinyllama-1.1b", {}),
         "moe": ("granite-moe-1b-a400m", {}),
         "hybrid": ("recurrentgemma-2b", {}),
         "hybrid_h3": CASES["hybrid_h3"],
         "ssm": ("xlstm-1.3b", {}),
         "ssm_h1": CASES["ssm_h1"],
         "encdec": ("seamless-m4t-medium", {})}
# the cases whose attention or mLSTM splits on head_dim over "model"
SPLIT = ("hybrid_h3", "ssm_h1")
PREFILL = (8, 24)            # rows, prompt tokens (dp = 4: 2 rows a rank)
DECODE = 4
GENERATE = (8, 16, 6)        # rows, prompt bytes, new tokens
GRAMMAR = r"([0-9]{1,6}[.,] )*[0-9]{0,6}"
STEP_BATCH = (8, 64, 2)      # rows, tokens, microbatches
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
LOGIT_TOL = 1e-5             # of the largest |logit|
NLL_SHAPE = (4, 8, 96)       # the vocab-parallel loss: rows, tokens, V
NLL_TOL = 1e-6               # its loss relative, its gradient of |max|
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


def _cfg(arch: str, over: dict, torch_side: bool):
    if torch_side:
        from repro_torch.configs import get_config, reduce_for_smoke
    else:
        from repro.configs import get_config, reduce_for_smoke
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **over)
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
    for name, (arch, over) in CASES.items():
        cfg = _cfg(arch, over, False)
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
            out[f"{name}_memory"] = rng.normal(
                0, 1, size=(b, cfg.enc_frames_decode, cfg.d_model)
            ).astype(np.float32)
        out[f"{name}_decode"] = rng.integers(
            0, cfg.vocab_size, size=(b, DECODE)).astype(np.int32)
    rows, tokens, _ = STEP_BATCH
    for name, (arch, over) in TRAIN.items():
        cfg = _cfg(arch, over, False)
        state = jax.tree.map(np.asarray, init_train_state(
            cfg, jax.random.PRNGKey(2)))
        for k, v in _flat(state).items():
            out[f"train_{name}_state{k}"] = v
        out[f"train_{name}_tokens"] = rng.integers(
            0, cfg.vocab_size, size=(rows, tokens)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, size=(rows, tokens))
        labels[:, :3] = -1                       # ignored positions
        out[f"train_{name}_labels"] = labels.astype(np.int32)
        if cfg.family == "encdec":
            out[f"train_{name}_frames"] = rng.normal(
                0, 1, size=(rows, tokens, cfg.d_model)).astype(np.float32)
    b, t, _ = GENERATE
    out["prompts"] = _grammar_prompts(np.random.default_rng(3), b, t)
    logits, labels = _nll_inputs(torch.Generator().manual_seed(4),
                                 *NLL_SHAPE, MESH[2])
    out["nll_logits"], out["nll_labels"] = logits.numpy(), labels.numpy()
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
    for name, (arch, over) in CASES.items():
        cfg = _cfg(arch, over, False)
        params = _tree(z, f"{name}_params")
        batch = {k: jnp.asarray(z[f"{name}_{k}"]) for k in ("tokens",
                                                            "frames")
                 if f"{name}_{k}" in z.files}
        logits, cache = _strict(lambda p, b: japi.prefill(
            p, cfg, b, last_only=False), params, batch)
        out[f"{name}_prefill"] = np.asarray(logits)
        t = batch["tokens"].shape[1]
        if cache is None:          # the hybrid and ssm: their zero state
            state, pos = _zero_state(cfg), 0
        else:
            state = {"cache": {k: jnp.pad(v, ((0, 0), (0, 0), (0, DECODE),
                                              (0, 0), (0, 0)))
                               for k, v in cache.items()}}
            pos = t
            if f"{name}_memory" in z.files:
                state["memory"] = jnp.asarray(z[f"{name}_memory"])
        dec = z[f"{name}_decode"]
        step = None
        for i in range(DECODE):
            batch = {"tokens": jnp.asarray(dec[:, i:i + 1]),
                     "pos": jnp.int32(pos + i), **state}
            if step is None:
                step = _strict_compiled(lambda p, b: japi.decode(p, cfg, b),
                                        params, batch)
            logits, new = step(params, batch)
            state["cache" if "cache" in state else "state"] = new
            out[f"{name}_decode{i}"] = np.asarray(logits[:, -1])
        if name == "dense":
            b, _, n = GENERATE
            gc = GrammarConstraint(compile_regex(GRAMMAR), cfg.padded_vocab,
                                   eos_id=None)
            out["generate"] = np.asarray(ServingEngine(
                cfg, params, ServeConfig(max_new_tokens=n),
                constraint=gc).generate(z["prompts"]))
    rows, tokens, nm = STEP_BATCH
    for name, (arch, over) in TRAIN.items():
        cfg = _cfg(arch, over, False)
        opts = TrainOptions(num_microbatches=nm,
                            aux_loss_weight=0.0 if name == "moe" else 0.01,
                            optimizer=AdamWConfig(**OPT))
        state = _tree(z, f"train_{name}_state")
        state["opt"]["step"] = np.int32(state["opt"]["step"])
        batch = {k: jnp.asarray(z[f"train_{name}_{k}"])
                 for k in ("tokens", "labels", "frames")
                 if f"train_{name}_{k}" in z.files}
        step = _strict_compiled(make_train_step(cfg, None, opts), state,
                                batch)
        new, metrics = step(state, batch)
        for k, v in _flat(jax_tree_np(new)).items():
            out[f"train_{name}_new{k}"] = v
        for k in ("loss", "grad_norm", "lr"):
            out[f"train_{name}_{k}"] = np.asarray(metrics[k])
    import jax

    from repro.models.transformer import lm_loss
    labels = jnp.asarray(z["nll_labels"])
    loss, grad = _strict(jax.value_and_grad(lambda x: lm_loss(x, labels)),
                         jnp.asarray(z["nll_logits"]))
    out["nll_loss"], out["nll_grad"] = np.asarray(loss), np.asarray(grad)
    np.savez(out_path, **out)


def _zero_state(cfg) -> dict:
    """The JAX package's zero decode state of the hybrid or ssm family."""
    from repro.models import recurrent, xlstm
    init = (recurrent.init_hybrid_state if cfg.family == "hybrid"
            else xlstm.init_xlstm_state)
    return {"state": init(cfg, PREFILL[0])}


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
    from repro_torch.models import encdec as ED
    from repro_torch.models import recurrent as RG
    from repro_torch.models import transformer as TF
    from repro_torch.models import xlstm as XL
    from repro_torch.serving import (GrammarConstraint, ServeConfig,
                                     ServingEngine)
    from repro_torch.training import AdamWConfig, TrainOptions
    from repro_torch.training import train_loop as TL

    _f32_compute(False)
    mesh = lm.make_mesh(MESH, ("pod", "data", "model"), device="cpu")
    out = {"coordinate": np.array(mesh.get_coordinate())}
    out.update(_child_nll(mesh, z))
    for name, (arch, over) in CASES.items():
        cfg = _cfg(arch, over, True)
        tree = _tree(z, f"{name}_params")
        params = convert.params_from_jax(cfg, tree, device="cpu", mesh=mesh)
        lm.reset_mesh_stats()
        batch = {k: torch.from_numpy(z[f"{name}_{k}"]) for k in (
            "tokens", "frames") if f"{name}_{k}" in z.files}
        spy = _Spy(lm, keep=name in SPLIT).__enter__()
        try:
            logits, cache = api.prefill(params, cfg, batch, mesh=mesh,
                                        last_only=False)
        finally:
            spy.__exit__()
        out[f"{name}_prefill"] = logits.numpy()
        out[f"{name}_stats"] = np.array(json.dumps(lm.MESH_STATS))
        b, t = batch["tokens"].shape
        rows = b // shr.dp_parts(mesh, b)
        if cache is None:                 # the hybrid and ssm: zero state
            init = (RG.init_hybrid_state if cfg.family == "hybrid"
                    else XL.init_xlstm_state)
            state = {"state": init(cfg, rows, device="cpu", mesh=mesh)}
            pos = 0
        else:
            init = (ED.init_encdec_cache if cfg.family == "encdec"
                    else TF.init_cache)
            big = init(cfg, rows, t + DECODE, device="cpu", mesh=mesh)
            for k in big:
                big[k][:, :, :t] = cache[k]
            state, pos = {"cache": big}, t
            if f"{name}_memory" in z.files:
                state["memory"] = torch.from_numpy(z[f"{name}_memory"])
        out[f"{name}_shapes"] = np.array(json.dumps({
            k: list(v.shape) for k, v in {
                **_flat(params, "params"),
                **_flat(state.get("state", state.get("cache")), "state"),
            }.items()}))
        dec = torch.from_numpy(z[f"{name}_decode"])
        with _Spy(lm, keep=name in SPLIT) as dspy:
            for i in range(DECODE):
                logits, new = api.decode(params, cfg, {
                    "tokens": dec[:, i:i + 1], "pos": pos + i, **state},
                    mesh=mesh)
                out[f"{name}_decode{i}"] = logits[:, -1].numpy()
        if name in SPLIT:
            blocks = _split_blocks(cfg, tree, mesh)
            out[f"{name}_gathers"] = np.array([
                _matches(g, blocks[k]) for g in (spy.gathered,
                                                 dspy.gathered)
                for k in ("wq", "kept")])
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
    for name, (arch, over) in TRAIN.items():
        cfg = _cfg(arch, over, True)
        opts = TrainOptions(num_microbatches=nm,
                            aux_loss_weight=0.0 if name == "moe" else 0.01,
                            optimizer=AdamWConfig(**OPT))
        whole = convert.train_state_from_jax(
            cfg, _tree(z, f"train_{name}_state"), device="cpu")
        state = reshard_tree(whole, TL.state_shardings(whole, mesh))
        batch = {k: torch.from_numpy(z[f"train_{name}_{k}"])
                 for k in ("tokens", "labels", "frames")
                 if f"train_{name}_{k}" in z.files}
        step = TL.jit_train_step(cfg, mesh, state,
                                 shr.batch_specs(batch, mesh, rows), opts)
        lm.reset_mesh_stats()
        with _Spy(lm, keep=name in SPLIT) as spy:
            state, metrics = step(state, batch)
        if name in SPLIT:
            blocks = _split_blocks(cfg, _tree(
                z, f"train_{name}_state")["params"], mesh)
            out[f"train_{name}_gathers"] = np.array([
                _matches(spy.gathered, blocks[k]) for k in ("wq", "kept")])
        out[f"train_{name}_stats"] = np.array(json.dumps(lm.MESH_STATS))
        out[f"train_{name}_calls"] = np.array(json.dumps(spy.calls))
        for k, v in _flat(state).items():
            out[f"train_{name}_new{k}"] = lm.whole_on_host(v).numpy()
        for k in ("loss", "grad_norm", "lr"):
            out[f"train_{name}_{k}"] = metrics[k].numpy()
    return out


def _split_blocks(cfg, tree: dict, mesh) -> dict:
    """This rank's "model" blocks, whole over "data", of the leaves of the
    layers split on head_dim: {"wq": [...], "kept": [...]}, the attention's
    and mLSTM's ``wq`` (which a prefill makes whole over "model") and the
    leaves that stay the rank's (the attention's ``wv``/``wo``, the
    mLSTM's ``wv``)."""
    from repro_torch.distributed.sharding import model_head_dim
    hd = cfg.hd if cfg.family == "hybrid" else cfg.d_model // cfg.n_heads
    span = model_head_dim(cfg.n_heads, hd, mesh.axis_size("model"),
                          mesh.coordinate("model"))
    cols = slice(span[0], span[0] + span[1])
    out = {"wq": [], "kept": []}
    for path, leaf in _flat(tree).items():
        block = "attn/" in path or "_mlstm/" in path
        name = path.rsplit("/", 1)[-1]
        if not block or name not in ("wq", "wv", "wo"):
            continue
        leaf = np.asarray(leaf, np.float32)
        entries = leaf if path.startswith("/groups/") else leaf[None]
        for w in entries:
            if name == "wo" and "_mlstm/" in path:
                continue                 # the mLSTM's [D, D] row-parallel
            w = w[:, cols] if name == "wo" else w[..., cols]
            out["wq" if name == "wq" else "kept"].append(w)
    return out


def _matches(gathered: list, blocks: list) -> int:
    """How many of the gathered inputs equal one of ``blocks``."""
    return sum(any(g.shape == b.shape and np.array_equal(g, b)
                   for b in blocks) for g in gathered)


def _child_nll(mesh, z) -> dict:
    """``vocab_parallel_nll`` of this rank's vocab slice over "model" of
    the whole logits ``nll_logits``, its gradient of that slice, and the
    port's ``lm_loss`` and its gradient on the whole logits."""
    from repro_torch.launch import mesh as lm
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import lm_loss, model_axis

    logits = torch.from_numpy(z["nll_logits"])
    labels = torch.from_numpy(z["nll_labels"])
    vocab = logits.shape[-1]
    nv = vocab // mesh.axis_size("model")
    cols = slice(mesh.coordinate("model") * nv,
                 (mesh.coordinate("model") + 1) * nv)
    x = logits[..., cols].clone().requires_grad_()
    lm.reset_mesh_stats()
    nll, count = L.vocab_parallel_nll(x, labels, vocab=vocab,
                                      mesh=model_axis(mesh))
    loss = nll / torch.clamp(count, min=1)
    stats = json.dumps(lm.MESH_STATS)
    (grad,) = torch.autograd.grad(loss, x)
    whole = logits.clone().requires_grad_()
    want = lm_loss(whole, labels)
    (want_grad,) = torch.autograd.grad(want, whole)
    return {"nll_loss": loss.detach().numpy(), "nll_count": count.numpy(),
            "nll_grad": grad.numpy(), "nll_cols": np.array(
                [cols.start, cols.stop]), "nll_stats": np.array(stats),
            "nll_lm_loss": want.detach().numpy(),
            "nll_lm_grad": want_grad[..., cols].numpy()}


class _Spy:
    """Records each ``launch.mesh.all_gather`` and ``all_reduce`` while
    open, as [kind, axes, op, input shape, dtype]; ``keep``: also the
    input of each gather over "model" (``gathered``)."""

    def __init__(self, lm, keep: bool = False):
        self.lm, self.calls, self.keep, self.gathered = lm, [], keep, []
        self.saved = (lm.all_gather, lm.all_reduce)

    def _add(self, kind, x, axes, op):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.calls.append([kind, ",".join(axes), op, list(x.shape),
                           str(x.dtype)])

    def __enter__(self):
        gather, reduce = self.saved

        def all_gather(x, mesh, axes, dim=0):
            self._add("all_gather", x, axes, "")
            if self.keep and axes in ("model", ("model",)):
                self.gathered.append(x.detach().float().numpy().copy())
            return gather(x, mesh, axes, dim)

        def all_reduce(x, mesh, axes, op="sum"):
            self._add("all_reduce", x, axes, op)
            return reduce(x, mesh, axes, op)

        self.lm.all_gather, self.lm.all_reduce = all_gather, all_reduce
        return self

    def __exit__(self, *exc):
        self.lm.all_gather, self.lm.all_reduce = self.saved


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


@pytest.mark.parametrize("case", sorted(CASES))
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
    or the zero state (each rank's rows and its part over "model") against
    the unsharded JAX decode."""
    outs, want, _ = world
    for r, got in enumerate(outs):
        for i in range(DECODE):
            _close_logits(got[f"{case}_decode{i}"], want[f"{case}_decode{i}"],
                          f"{case} step {i} rank {r}")


def _kinds(cfg) -> list:
    """The block kinds of a hybrid or ssm config, layer by layer."""
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    return list(pat) * n_groups + list(pat[:cfg.n_layers
                                           - n_groups * len(pat)])


def _model_sums(cfg) -> tuple[int, int]:
    """(all-reduces, reduce-scatters) over "model" of one prefill: the
    embedding's sum and one a row-parallel output (the MoE's: its aux
    loss's mean over the token blocks), the attention's and the mLSTM's
    where they split on head_dim too (``hybrid_h3``, ``ssm_h1``: the rank's
    columns of every head through ``wo``'s rows); the RG-LRU's gates'
    reduce-scatter."""
    if cfg.family == "hybrid":
        n_rglru = _kinds(cfg).count("rglru")
        n_attn = cfg.n_layers - n_rglru
        return 1 + 2 * n_rglru + 2 * n_attn, n_rglru
    if cfg.family == "ssm":
        return 1 + cfg.n_layers, 0
    if cfg.family == "encdec":
        return 1 + 2 * cfg.n_enc_layers + 3 * cfg.n_layers, 0
    return 1 + 2 * cfg.n_layers, 0


def _expected_shapes(case: str, cfg) -> dict:
    """The shapes of a rank's leaves on (2, 2, 2), by the path
    ``_child_cases`` records ("params/...", "state/..."): d_model over
    "data", heads, hidden columns, channels and vocab over "model", the
    rows over ("pod", "data")."""
    pod, data, m = MESH
    b, t = PREFILL
    rows, d_loc, hd = b // (pod * data), cfg.d_model // data, cfg.hd
    out = {"params/embed/table": [cfg.padded_vocab // m, d_loc],
           "params/head/w": [d_loc, cfg.padded_vocab // m]}
    if cfg.family in ("dense", "moe"):
        n = cfg.n_layers
        lay = "params/layers/"
        out[lay + "attn/wq"] = [n, d_loc, cfg.n_heads // m, hd]
        out[lay + "attn/wo"] = [n, cfg.n_heads // m, hd, d_loc]
        # one kv head: split on head_dim, as the rules place it
        out[lay + "attn/wk"] = ([n, d_loc, 1, hd // m]
                                if cfg.n_kv_heads == 1 else
                                [n, d_loc, cfg.n_kv_heads // m, hd])
        if cfg.n_experts:
            out[lay + "moe/wi_gate"] = [n, cfg.n_experts // m, cfg.d_model,
                                        cfg.d_ff]
        else:
            out[lay + "mlp/wi_gate"] = [n, d_loc, cfg.d_ff // m]
        kv = 1 if cfg.n_kv_heads == 1 else cfg.n_kv_heads // m
        out["state/k"] = [n, rows, t + DECODE, kv, hd]
    elif cfg.family == "hybrid":
        r = cfg.rglru_dim // m
        g = "params/groups/b0_rglru/"
        out.update({g + "wx": [1, d_loc, r], g + "wgate": [1, d_loc, r],
                    g + "conv_w": [1, 4, r], g + "conv_b": [1, r],
                    g + "lam": [1, r],
                    g + "w_r": [1, r, cfg.rglru_dim // data],
                    g + "w_i": [1, r, cfg.rglru_dim // data],
                    g + "wo": [1, r, d_loc],
                    g + "mlp/wi_gate": [1, d_loc, cfg.d_ff // m],
                    "params/tail/b0_rglru/wx": [d_loc, r],
                    "state/groups/b0_rglru/h": [1, rows, r],
                    "state/groups/b0_rglru/conv": [1, rows, 3, r],
                    "state/tail/b1_rglru/h": [rows, r]})
        a = "params/groups/b2_attn/attn/"
        if cfg.n_heads % m:        # 3 heads: split on head_dim, the ring too
            out[a + "wq"] = [1, d_loc, cfg.n_heads, hd // m]
            out[a + "wo"] = [1, cfg.n_heads, hd // m, d_loc]
            ring = hd // m
        else:
            out[a + "wq"] = [1, d_loc, cfg.n_heads // m, hd]
            ring = hd
        out[a + "wk"] = [1, d_loc, 1, hd // m]
        out["state/groups/b2_attn/k"] = [1, rows, cfg.attn_window, 1, ring]
    elif cfg.family == "ssm":
        hd = cfg.d_model // cfg.n_heads
        g = "params/groups/b0_mlstm/"
        nh = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
        # one head: C's value columns and n's key columns over "model"
        cols = hd if nh < cfg.n_heads else hd // m
        out.update({g + "wog": [1, d_loc, cfg.d_model // m],
                    g + "wo": [1, cfg.d_model // m, d_loc],
                    g + "wi": [1, d_loc, nh],
                    "params/groups/b7_slstm/wz": [1, d_loc, cfg.d_model // m],
                    "params/groups/b7_slstm/wo": [1, cfg.d_model // m, d_loc],
                    "state/groups/b0_mlstm/C": [1, rows, nh, hd, cols],
                    "state/groups/b7_slstm/c": [1, rows, cfg.d_model // m],
                    "state/tail/b1_mlstm/n": [rows, nh, cols]})
        out[g + "wq"] = ([1, d_loc, nh, hd] if nh < cfg.n_heads
                         else [1, d_loc, cfg.n_heads, hd // m])
    else:                                                       # encdec
        n, k = cfg.n_layers, cfg.n_kv_heads // m
        out.update({"params/enc/attn/wq": [cfg.n_enc_layers, d_loc,
                                           cfg.n_heads // m, hd],
                    "params/dec/self/wq": [n, d_loc, cfg.n_heads // m, hd],
                    "params/dec/cross/wk": [n, d_loc, k, hd],
                    "params/dec/cross/wo": [n, cfg.n_heads // m, hd, d_loc],
                    "params/dec/mlp/wi_gate": [n, d_loc, cfg.d_ff // m],
                    "state/k": [n, rows, t + DECODE, k, hd]})
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_its_rows_and_heads(world, case):
    """B / dp rows and the rank's part over "model" in the cache or state
    (kv heads; the RG-LRU's d_rnn / m channels, the mLSTM's N / m heads,
    the sLSTM's D / m channels); N / m query heads, the MLP's hidden
    columns, the channels and the vocab rows in the weights (data shards
    on d_model beside them); one sum over "model" a row-parallel block;
    and ``api.input_specs`` gives a decode cell the same cache or
    state."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import api as tapi

    from repro_torch.distributed import sharding as shr
    from repro_torch.models import recurrent as RG
    from repro_torch.models import xlstm as XL

    outs, _, _ = world
    arch, over = CASES[case]
    cfg = _cfg(arch, over, True)
    want = _expected_shapes(case, cfg)
    sums, scatters = _model_sums(cfg)
    layout = MeshLayout(MESH, ("pod", "data", "model"))
    b, t = PREFILL
    if case in SPLIT:              # the rules' block of the whole state
        init = (RG.init_hybrid_state if cfg.family == "hybrid"
                else XL.init_xlstm_state)
        whole = _flat(init(cfg, b, device="meta"), "state")
        specs = shr.state_specs(whole, layout, b)
    for r, got in enumerate(outs):
        shapes = json.loads(str(got[f"{case}_shapes"]))
        assert {k: shapes[k] for k in want} == want, r
        stats = json.loads(str(got[f"{case}_stats"]))
        assert stats["all_reduce model"][0] == sums
        assert stats.get("reduce_scatter model", [0])[0] == scatters
        assert stats["all_gather pod,data"][0] == 1     # the logits' rows
        if case in SPLIT:
            coord = [int(c) for c in got["coordinate"]]
            blocks = {k: [s_.stop - s_.start for s_ in shr.local_slices(
                tuple(v.shape), specs[k], MESH, coord)]
                for k, v in whole.items()}
            assert {k: shapes[k] for k in blocks} == blocks, r
            # wq and wk made whole over "model" a split layer, then the
            # logits' vocab; the mLSTM's h to its columns, one all-to-all
            n_split = (_kinds(cfg).count("attn") if cfg.family == "hybrid"
                       else _kinds(cfg).count("mlstm"))
            assert stats["all_gather model"][0] == 2 * n_split + 1
            assert stats.get("all_to_all model", [0])[0] == (
                n_split if cfg.family == "ssm" else 0)
    # what the dry run places for a decode cell: the same cache or state
    spec = tapi.input_specs(cfg, ShapeSpec("d", "decode", t + DECODE, b),
                            layout)
    state = spec["state"] if "state" in spec else spec["cache"]
    assert {"state" + k: list(v.shape) for k, v in _flat(state).items()} \
        == {k: v for k, v in shapes.items() if k.startswith("state/")}


@pytest.mark.parametrize("case", SPLIT)
def test_head_dim_split_gathers_no_value_side_leaf(world, case):
    """A layer split on head_dim over "model" keeps its value side on the
    rank: no gather over "model" in the prefill, the decode steps or the
    train step has the rank's block of the attention's ``wv``/``wo`` or
    the mLSTM's ``wv`` as its input, while the prefill makes each split
    layer's ``wq`` whole (once a layer) and the train step does too."""
    outs, _, _ = world
    cfg = _cfg(*CASES[case], True)
    n_split = (_kinds(cfg).count("attn") if cfg.family == "hybrid"
               else _kinds(cfg).count("mlstm"))
    for r, got in enumerate(outs):
        pre_wq, pre_kept, dec_wq, dec_kept = (int(v) for v in
                                              got[f"{case}_gathers"])
        assert (pre_wq, pre_kept, dec_wq, dec_kept) == (n_split, 0, 0, 0), r
        train_wq, train_kept = (int(v) for v in got[f"train_{case}_gathers"])
        assert train_wq > 0 and train_kept == 0, (r, train_wq, train_kept)


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
    # the layers ran tensor-parallel: sums over "model" in both passes'
    # forward; the RG-LRU's gates reduce-scattered over it, and the
    # gradient of the ``wq``/``wk`` a head_dim split makes whole; no
    # gradient summed over it where every leaf splits on its heads
    stats = json.loads(str(got[f"{name}_stats"]))
    assert stats["all_reduce model"][0] > 0
    scatters = stats.get("reduce_scatter model", [0])[0]
    assert (scatters > 0) == (family.startswith("hybrid")
                              or family in SPLIT)


@pytest.mark.parametrize("family", sorted(TRAIN))
def test_train_step_reduces_the_loss_over_model(world, family):
    """The sharded step's loss is vocab-parallel on every rank: no gather
    over "model" of a microbatch's logits (the rank's [rows, T, V / m]
    slice), and per microbatch three all-reduces over "model" of its
    [rows, T] float32 rows: the max, the sum of exp and the gold logit."""
    outs, _, _ = world
    rows, t, nm = STEP_BATCH
    pod, data, m = MESH
    cfg = _cfg(*TRAIN[family], True)
    local = [rows // nm // (pod * data), t]
    numel = local[0] * t * cfg.padded_vocab // m
    for r, got in enumerate(outs):
        calls = json.loads(str(got[f"train_{family}_calls"]))
        big = [c for c in calls if c[0] == "all_gather" and c[1] == "model"
               and np.prod(c[3]) >= numel]
        assert not big, (r, big)
        ops = sorted(c[2] for c in calls if c[0] == "all_reduce"
                     and c[1] == "model" and c[3] == local
                     and c[4] == "torch.float32")
        assert ops == ["max"] * nm + ["sum"] * (2 * nm), (r, ops)
        # MESH_STATS: the largest gather over "model" is below the slice
        stats = json.loads(str(got[f"train_{family}_stats"]))
        assert stats.get("all_gather model", [0] * 4)[3] < numel * 4, r


def test_vocab_parallel_nll_matches_lm_loss(world):
    """Each rank's ``vocab_parallel_nll`` of its half of the vocab over
    "model" (labels -1, in both ranks' ranges and at the last padded
    column): nll_sum / count within 1e-6 relative of ``lm_loss`` of the
    whole logits (the port's and the JAX package's), its gradient of the
    slice within 1e-6 of |max| of theirs, and three sums of [rows, T]
    floats over "model", no gather."""
    outs, want, inp = world
    labels = inp["nll_labels"]
    rows, t, _ = NLL_SHAPE
    for r, got in enumerate(outs):
        assert int(got["nll_count"]) == int((labels >= 0).sum())
        loss = float(got["nll_loss"])
        for ref in (float(got["nll_lm_loss"]), float(want["nll_loss"])):
            assert abs(loss - ref) <= NLL_TOL * abs(ref), (r, loss, ref)
        c0, c1 = got["nll_cols"]
        for ref in (got["nll_lm_grad"], want["nll_grad"][..., c0:c1]):
            scale = float(np.abs(ref).max())
            gap = float(np.abs(got["nll_grad"] - ref).max())
            assert gap <= NLL_TOL * scale, (r, gap, scale)
        stats = json.loads(str(got["nll_stats"]))
        assert stats == {"all_reduce model": [3, 3 * rows * t * 4, 0.0,
                                              rows * t * 4]}


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


def test_dryrun_xlstm_decode_holds_its_state_block(tmp_path):
    """xlstm-1.3b ``decode_32k`` on the (16, 16) fake world: a rank's peak
    is below 0.5 GiB (8 rows; the 42 mLSTM blocks' ``C`` and ``n`` split
    on head_dim over "model": 0.08 of the 1.31 GiB whole heads hold), and
    each mLSTM block sums its ``q . n`` over "model" and exchanges ``h``
    once."""
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            "sys.argv = ['dryrun', '--arch', 'xlstm-1.3b', '--shape', "
            f"'decode_32k', '--mesh', 'single', '--out', {str(tmp_path)!r}]\n"
            "sys.exit(dryrun.main())\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp_path / "single" / "xlstm-1.3b--decode_32k.json") as f:
        rec = json.load(f)
    assert rec["ok"], rec.get("error")
    assert rec["memory"]["peak_bytes"] < 0.5 * 2 ** 30
    assert rec["collectives"]["all-to-all"]["count"] == 42


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b",
                                  "seamless-m4t-medium"])
def test_input_specs_give_the_rank_its_state_on_the_production_mesh(arch):
    """``decode_32k`` on (16, 16): 8 of 128 rows a rank and its part over
    "model": recurrentgemma-2b's d_rnn / 16 RG-LRU channels and its ring's
    head_dim / 16 columns of its one kv head (10 query heads do not split
    16 ways: the layer splits on head_dim); xlstm-1.3b's sLSTM D / 16
    channels and, its 4 mLSTM heads split on head_dim, every head's
    ``C`` value columns and ``n`` key columns / 16; seamless-m4t-medium's
    1 of 16 kv heads in the decoder cache.  The hybrid's and ssm's blocks
    are those ``sharding.state_specs`` places on rank 0 of the whole
    batch's state."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import api as tapi
    from repro_torch.models import recurrent as RG
    from repro_torch.models import xlstm as XL

    cfg = get_config(arch)
    layout = MeshLayout((16, 16), ("data", "model"))
    spec = tapi.input_specs(cfg, SHAPES["decode_32k"], layout)
    got = {k: v.shape for k, v in _flat(spec).items()
           if k.startswith(("/state", "/cache"))}
    rows, s = 128 // 16, 32_768
    if arch == "recurrentgemma-2b":
        r = 2560 // 16
        want = {"/state/groups/b0_rglru/h": (8, rows, r),
                "/state/groups/b1_rglru/conv": (8, rows, 3, r),
                "/state/groups/b2_attn/k": (8, rows, 2048, 1, 16),
                "/state/groups/b2_attn/v": (8, rows, 2048, 1, 16),
                "/state/tail/b1_rglru/h": (rows, r)}
    elif arch == "xlstm-1.3b":
        want = {"/state/groups/b0_mlstm/C": (6, rows, 4, 512, 32),
                "/state/groups/b6_mlstm/n": (6, rows, 4, 32),
                "/state/groups/b7_slstm/c": (6, rows, 2048 // 16)}
    else:
        want = {"/cache/k": (12, rows, s, 1, 64),
                "/cache/v": (12, rows, s, 1, 64)}
    assert {k: got[k] for k in want} == want
    if cfg.family in ("hybrid", "ssm"):
        init = (RG.init_hybrid_state if cfg.family == "hybrid"
                else XL.init_xlstm_state)
        whole = _flat(init(cfg, 128, device="meta"), "/state")
        specs = shr.state_specs(whole, layout, 128)
        placed = {k: tuple(s_.stop - s_.start for s_ in shr.local_slices(
            tuple(v.shape), specs[k], (16, 16), (0, 0)))
            for k, v in whole.items()}
        assert placed == {k: got[k] for k in placed}


def test_byte_view_of_a_tensor_whose_last_stride_is_not_one():
    """A bf16 collective's byte view (``launch.mesh._raw``) of a tensor
    that torch counts contiguous although its size-1 dims leave its last
    stride above 1 (one row's logits moved to dim 0, as a vocab-parallel
    gather of a batch of one does)."""
    from repro_torch.launch import mesh as lm

    x = torch.arange(8, dtype=torch.bfloat16).reshape(1, 1, 8).movedim(2, 0)
    assert x.is_contiguous() and x.stride(-1) > 1
    raw = lm._raw(x)
    assert raw.dtype == torch.uint8 and raw.shape == (8, 1, 2)
    assert torch.equal(raw.view(torch.bfloat16), x)


class _StandInAxis:
    """A "model" axis of ``n`` ranks inside one process: rank ``rank``'s
    collectives read the other ranks' tensors from ``xs`` (forward) and
    ``gs`` (backward)."""

    def __init__(self, xs, gs):
        self.xs, self.gs, self.rank = xs, gs, 0

    def axis_size(self, axes) -> int:
        return len(self.xs)


def _stand_in_reduce_scatter(x, mesh, axes, dim=0):
    parts = [x if j == mesh.rank else xj.float()
             for j, xj in enumerate(mesh.xs)]
    return sum(parts).chunk(len(parts), dim)[mesh.rank]


def _stand_in_all_gather(g, mesh, axes, dim=0):
    return torch.cat([g if j == mesh.rank else gj
                      for j, gj in enumerate(mesh.gs)], dim)


def test_scatter_parts_gradient_is_the_adjoint_of_its_sum(monkeypatch):
    """Each of 4 ranks holds x_j [2, 3, 8]; ``scatter_parts`` gives rank r
    its quarter (along the last dim) of the sum of all x_j, and rank j's
    gradient must be that of sum_r <y_r, G_r> with respect to x_j: every
    rank's G_r all-gathered.  A backward that kept the rank's own part, or
    passed its G through, fails."""
    from repro_torch.launch import mesh as lm

    monkeypatch.setattr(lm, "reduce_scatter", _stand_in_reduce_scatter)
    monkeypatch.setattr(lm, "all_gather", _stand_in_all_gather)
    gen = torch.Generator().manual_seed(0)
    n = 4
    xs = [torch.randn(2, 3, 8, generator=gen) for _ in range(n)]
    gs = [torch.randn(2, 3, 8 // n, generator=gen) for _ in range(n)]
    axis = _StandInAxis(xs, gs)
    leaves = [x.clone().requires_grad_() for x in xs]
    total = sum(torch.sum(y * g) for y, g in zip(
        torch.stack(leaves).sum(0).chunk(n, -1), gs))
    want = torch.autograd.grad(total, leaves)
    for r in range(n):
        axis.rank = r
        x = xs[r].clone().requires_grad_()
        y = lm.scatter_parts(x, axis, "model", -1)
        torch.testing.assert_close(y, sum(xs).chunk(n, -1)[r])
        (got,) = torch.autograd.grad(torch.sum(y * gs[r]), x)
        torch.testing.assert_close(got, want[r], rtol=0, atol=1e-6)


class _ThreadAxis:
    """A "model" axis of ``n`` ranks inside one process, each rank a
    thread: a collective puts the rank's tensor on the shared board, waits
    for every rank's and combines them."""

    def __init__(self, board, rank: int):
        self.board, self.rank = board, rank

    def axis_size(self, axes) -> int:
        return self.board["n"]

    def coordinate(self, axis: str) -> int:
        return self.rank


def _thread_all_reduce(x, mesh, axes, op="sum"):
    board = mesh.board
    board["parts"][mesh.rank] = x.detach().clone()
    board["barrier"].wait()
    parts = torch.stack(board["parts"])
    board["barrier"].wait()          # every rank has read the board
    return parts.amax(0) if op == "max" else parts.sum(0)


def _on_threads(n: int, fn) -> list:
    """``fn(axis)`` on each rank of a ``_ThreadAxis`` of ``n`` ranks."""
    import threading
    board = {"n": n, "parts": [None] * n,
             "barrier": threading.Barrier(n, timeout=60)}
    out, errors = [None] * n, []

    def run(r):
        try:
            out[r] = fn(_ThreadAxis(board, r))
        except BaseException as e:            # noqa: BLE001 - re-raised
            errors.append(e)
            board["barrier"].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _nll_inputs(gen, rows: int, t: int, vocab: int, m: int):
    """Logits [rows, t, vocab] of std 2 (a model's scale: float32's
    rounding of a log-sum-exp near 30 alone moves the softmax by 1e-6) and
    labels with -1 (ignored), ids in every rank's vocab range and the last
    padded column."""
    logits = torch.randn(rows, t, vocab, generator=gen) * 2
    labels = torch.randint(0, vocab, (rows, t), generator=gen)
    nv = vocab // m
    labels[0, :m] = torch.arange(m) * nv + nv // 2     # each rank's range
    labels[0, m] = vocab - 1                           # the last pad column
    labels[1, :3] = -1
    return logits, labels


def test_vocab_parallel_nll_gradient_is_lm_loss_gradient(monkeypatch):
    """Each of 4 ranks holds a quarter of the vocab of [3, 7, 64] logits;
    ``vocab_parallel_nll``'s loss, nll_sum / count, and its gradient of
    the rank's slice equal ``lm_loss`` and the matching columns of its
    gradient on the whole logits.  A backward that summed the gradient
    over "model", or dropped the gold logit's -1, fails."""
    from repro_torch.launch import mesh as lm
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import lm_loss

    monkeypatch.setattr(lm, "all_reduce", _thread_all_reduce)
    n, vocab = 4, 64
    logits, labels = _nll_inputs(torch.Generator().manual_seed(0), 3, 7,
                                 vocab, n)
    whole = logits.clone().requires_grad_()
    want = lm_loss(whole, labels)
    (want_g,) = torch.autograd.grad(want, whole)
    nv = vocab // n

    def rank(axis):
        x = logits[..., axis.rank * nv:(axis.rank + 1) * nv].clone()
        x.requires_grad_()
        nll, count = L.vocab_parallel_nll(x, labels, vocab=vocab, mesh=axis)
        loss = nll / torch.clamp(count, min=1)
        (g,) = torch.autograd.grad(loss, x)
        return loss.detach(), int(count), g

    for r, (loss, count, g) in enumerate(_on_threads(n, rank)):
        assert count == int((labels >= 0).sum())
        torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=0)
        scale = float(want_g.abs().max())
        gap = float((g - want_g[..., r * nv:(r + 1) * nv]).abs().max())
        assert gap <= 1e-6 * scale, (r, gap, scale)


def _thread_parts(x, mesh) -> list:
    """Every rank's ``x`` of a ``_ThreadAxis``, in rank order."""
    board = mesh.board
    board["parts"][mesh.rank] = x
    board["barrier"].wait()
    parts = list(board["parts"])
    board["barrier"].wait()          # every rank has read the board
    return parts


def _thread_collectives(monkeypatch, lm) -> None:
    """``launch.mesh``'s collectives over a ``_ThreadAxis``."""
    def all_reduce(x, mesh, axes, op="sum"):
        parts = torch.stack(_thread_parts(x.detach().clone(), mesh))
        return parts.amax(0) if op == "max" else parts.sum(0)

    def all_gather(x, mesh, axes, dim=0):
        return torch.cat(_thread_parts(x.detach().clone(), mesh), dim)

    def reduce_scatter(x, mesh, axes, dim=0):
        total = sum(_thread_parts(x.detach().clone(), mesh))
        return total.chunk(mesh.board["n"], dim)[mesh.rank].contiguous()

    def all_to_all_v(x, mesh, axis, send, recv):
        parts = _thread_parts((x.detach().clone(), list(send)), mesh)
        out = []
        for src, sizes in parts:
            lo = sum(sizes[:mesh.rank])
            out.append(src[lo:lo + sizes[mesh.rank]])
        got = torch.cat(out, 0)
        assert got.shape[0] == sum(recv)
        return got

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter),
                     ("all_to_all_v", all_to_all_v)):
        monkeypatch.setattr(lm, name, fn)


class _Snapshots(dict):
    """A decode state whose every read is a fresh copy, the last one read
    kept in ``last``: the step's in-place update then writes a copy, not
    the tensor its products saved for the backward pass."""

    def __init__(self, state):
        super().__init__(state)
        self.last = {}

    def __getitem__(self, k):
        self.last[k] = dict.__getitem__(self, k).clone()
        return self.last[k]


SPLIT_HD = (4, 3, 16, 64, 8)     # ranks, query heads, head_dim, D, positions
PROMPT_HD = 24                   # the prefill cases' tokens (mLSTM: 3 chunks)


def _split_case(kind: str, gen):
    """(the whole layer's leaves, its cache or state, a forward ``run(p,
    x, mesh, state)`` returning (out, the state or cache it wrote), the
    dim of each leaf or state cut to a rank's block, d_model) of a decode
    step of a layer split on head_dim over ``SPLIT_HD[0]`` ranks."""
    import dataclasses as dc

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import layers as L
    from repro_torch.models import recurrent as RG
    from repro_torch.models import xlstm as XL

    n, heads, hd, d, s = SPLIT_HD
    pos = s - 3
    if kind.startswith("mlstm"):         # 3 heads of hd: D = 3 hd
        p = XL.init_mlstm_block(gen, heads * hd, heads, device="cpu")
        state = {"C": torch.randn(2, heads, hd, hd, generator=gen) * 0.1,
                 "n": torch.randn(2, heads, hd, generator=gen)}
        if kind == "mlstm_prefill":
            state = {}

        def run(p, x, mesh, st):
            snap = _Snapshots(st) if st else None
            out, _ = XL.mlstm_block(p, x, n_heads=heads, eps=1e-5,
                                    state=snap, mesh=mesh)
            return out, snap.last if st else {}
        cut = {"wq": 2, "wk": 2, "wv": 2, "C": 3, "n": 2, "wog": 1, "wo": 0}
        return p, state, run, cut, heads * hd
    cfg = dc.replace(reduce_for_smoke(get_config("recurrentgemma-2b")),
                     d_model=d, n_heads=heads, n_kv_heads=1, head_dim=hd,
                     attn_window=s)
    if kind == "ring":
        p = RG.init_attn_block(gen, cfg, device="cpu")
        ring = {k: torch.randn(2, s, 1, hd, generator=gen)
                for k in ("k", "v")}

        def run(p, x, mesh, st):
            return RG.attn_block_decode(p, x, cfg, st, pos, mesh=mesh)
        return p, ring, run, {"attn/wq": 2, "attn/wk": 2, "attn/wv": 2,
                              "attn/wo": 1, "k": 3, "v": 3,
                              "mlp/wi_gate": 1, "mlp/wi_up": 1,
                              "mlp/wo": 0}, d
    p = L.init_attention(gen, d, heads, 1, hd, device="cpu")
    if kind.startswith("cross"):         # K/V from a memory every rank holds
        memory = torch.randn(2, 6, d, generator=gen)

        def run(p, x, mesh, st):
            out, _ = L.attention(p, x, positions=None, rope_theta=10_000.0,
                                 memory=memory, causal=False, mesh=mesh,
                                 heads=(heads, 1, hd))
            return out, {}
        return p, {}, run, {"wq": 2, "wk": 2, "wv": 2, "wo": 1}, d
    cache = {k: torch.randn(2, s, 1, hd, generator=gen) for k in ("k", "v")}
    at, positions = pos, torch.full((1, 1), pos)
    if kind == "attention_prefill":      # blockwise, from position 0
        cache = {k: torch.zeros(2, PROMPT_HD, 1, hd) for k in ("k", "v")}
        at, positions = 0, torch.arange(PROMPT_HD)[None]

    def run(p, x, mesh, st):
        return L.attention(p, x, positions=positions, rope_theta=10_000.0,
                           window=5, cache=st, cache_index=at, mesh=mesh,
                           heads=(heads, 1, hd))
    return p, cache, run, {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "k": 3,
                           "v": 3}, d


def _block(x, dim, n, r):
    return x.chunk(n, dim)[r]


@pytest.mark.parametrize("kind", ["attention", "ring", "mlstm", "cross",
                                  "attention_prefill", "mlstm_prefill",
                                  "cross_prefill"])
def test_head_dim_split_is_one_process(monkeypatch, kind):
    """A decode step (and a prefill: ``PROMPT_HD`` tokens, the attention
    blockwise into a cache from position 0, the mLSTM in 3 chunks) of a
    layer, and a cross-attention to a memory, whose heads do not divide
    "model" (3
    query heads, the mLSTM's too) on an axis of 4 ranks run as
    threads, each holding its head_dim / 4 columns of ``wq``/``wk``/
    ``wv``/``wo`` and of the cache, ring or state (``C``'s value columns,
    ``n``'s key columns): the output equals one process's within 1e-5 of
    its largest |value|, each rank's cache or state equals its block of
    one process's, and the gradient of the output's inner product with a
    random tensor, in x and in the rank's leaves, equals the matching
    block of one process's.  rope's partner columns lie on another rank
    (column i pairs with i + 8 of 16); the partial scores (the mLSTM's
    ``q . n``) are summed over "model" in the forward and their gradient
    in the backward: dropping either sum fails."""
    from repro_torch.launch import mesh as lm
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import xlstm as XL

    monkeypatch.setattr(L, "Compute", torch.float32)
    monkeypatch.setattr(moe, "Compute", torch.float32)
    monkeypatch.setattr(XL, "CHUNK", PROMPT_HD // 3)
    _thread_collectives(monkeypatch, lm)
    n = SPLIT_HD[0]
    gen = torch.Generator().manual_seed(5)
    p, state, run, cut, d = _split_case(kind, gen)
    t = PROMPT_HD if kind.endswith("prefill") else 1
    x = torch.randn(2, t, d, generator=gen)
    g = torch.randn(2, t, d, generator=gen)
    flat = _flat(p)
    names = sorted(flat)

    def one(leaves, x, mesh, st):
        out, st = run(_unflat(dict(zip(names, leaves))), x, mesh, st)
        grads = torch.autograd.grad(torch.sum(out * g), [x, *leaves])
        return out.detach(), {k: v.detach() for k, v in st.items()}, grads

    leaves = [flat[k].clone().requires_grad_() for k in names]
    want, want_st, want_g = one(leaves, x.clone().requires_grad_(), None,
                                {k: v.clone() for k, v in state.items()})

    def key(name):
        return name.strip("/")

    def rank(axis):
        r = axis.rank
        mine = [(_block(flat[k], cut[key(k)], n, r) if key(k) in cut
                 else flat[k]).clone().requires_grad_() for k in names]
        st = {k: _block(v, cut[k], n, r).clone() for k, v in state.items()}
        return one(mine, x.clone().requires_grad_(), axis, st)

    scale = float(want.abs().max())
    for r, (out, st, grads) in enumerate(_on_threads(n, rank)):
        assert float((out - want).abs().max()) <= 1e-5 * scale, (kind, r)
        for k, v in st.items():
            torch.testing.assert_close(v, _block(want_st[k], cut[k], n, r),
                                       rtol=0, atol=1e-5 * float(
                                           want_st[k].abs().max()))
        for name, got, ref in zip(["x", *names], grads, want_g):
            if key(name) in cut:
                ref = _block(ref, cut[key(name)], n, r)
            gap = float((got - ref).abs().max())
            assert gap <= 1e-5 * max(float(ref.abs().max()), 1e-30), \
                (kind, r, name, gap, float(ref.abs().max()))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    else:
        _child_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4], sys.argv[5])
