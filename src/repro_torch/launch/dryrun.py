"""Multi-pod dry run of the port: one rank of every (arch x shape x mesh)
cell traced on a fake world, with no card and no cluster.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell on 512 forced host devices.  Per cell this driver

  1. starts a fake world of 256 or 512 ranks in this process (torch's
     ``fake`` process-group backend over a ``FakeStore``: collectives move
     nothing) and builds the production mesh (16x16 single-pod / 2x16x16
     multi-pod) on it, naming rank 0's device instead of probing for it;
  2. makes rank 0's parameter, optimizer and batch leaves as
     ``FakeTensor``s (shapes, no data, nothing drawn): the parameters from
     ``models.api.param_shapes``, each leaf this rank's block under
     ``distributed.sharding.param_specs`` (training and serving alike),
     the batch from ``models.api.input_specs(cfg, shape, mesh)``.  The
     port's steps take the whole batch's tokens on every rank (SPMD) and
     cut this rank's rows themselves, as ``batch_specs`` places them; a
     decode cell's cache or state is this rank's own (its rows and its
     part over "model": the block of ``transformer.cache_block``, the
     kv heads its query heads read or, where the heads do not divide
     "model", every kv head's head_dim / m columns; the RG-LRU's and the
     sLSTM's channels; the mLSTM's block of ``xlstm.state_block``, its
     heads or its ``C``'s and ``n``'s head_dim / m columns), as
     ``state_specs`` and the prefill leave it.  Every family
     traces its tensor-parallel program over "model";
  3. runs one *production* step on them inside ``launch.census
     .trace_census``: ``training.make_train_step(cfg, mesh, opts)`` for
     train cells, ``api.prefill`` / ``api.decode(..., mesh=mesh)`` for
     serving ones, with the live storages' peak (``census
     .trace_memory``);
  4. writes ``<out>/<mesh>/<arch>--<shape>.json`` with ``ok``,
     ``n_devices``, ``num_microbatches`` (train), ``route`` (whose program
     the trace took: "cuda" the card's, "cpu" the plain one),
     ``trace_s``, ``total_s``,
     ``census``, ``collectives`` and ``memory`` (``peak_bytes``,
     ``argument_bytes``, ``temp_bytes`` = peak - arguments), or ``error``.

The trace takes the card's program by default (``--device cuda``): the
kernel wrappers go their card route (B9 counts its launches and work
without launching, ``kernels.flash_attn``; any other kernel handed a
FakeTensor raises).  The fake tensors are CPU tensors traced inside
``kernels.census_hooks.fake_card`` on every torch, so a trace is the same
whether torch was built with CUDA or not (a torch built without it cannot
index, copy or differentiate fake CUDA tensors); ``chip_smoke.py`` holds
this trace to a real step on the card.  ``--device cpu`` traces the plain
route.  No card is needed either way.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape prefill_32k --mesh both
  python -m repro_torch.launch.dryrun --all [--mesh both] [--timeout 3600]
The --all driver runs each cell in a subprocess (a crash must not kill the
sweep) and records each failure.  ``REPRO_NM`` overrides a train cell's
microbatch count and ``REPRO_COMPRESS`` its gradient compression, as in the
reference.  ``python -m repro_torch.launch.roofline`` reads the records.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["ARTIFACTS", "build_cell", "run_cell", "trace_cell",
           "trace_one_card", "all_cells", "fake_world", "main"]

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")


def fake_world(n: int) -> None:
    """Start a world of ``n`` ranks of torch's ``fake`` backend in this
    process, as rank 0 (destroy it with
    ``torch.distributed.destroy_process_group``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# the fake leaves' device on either route (see the module's docstring)
_FAKE_DEVICE = torch.device("cpu")


def _batch(cfg, shape, device, mesh=None) -> dict:
    """Fake batch leaves of ``api.input_specs`` (call under a fake mode);
    a decode cell's position is the cache's last, an int as
    ``api.make_inputs`` gives it."""
    from ..models import api

    def leaf(path, spec):
        if path == ("pos",):
            return shape.seq_len - 1
        return torch.empty(spec.shape, dtype=spec.dtype, device=device)
    return _tree_map(leaf, api.input_specs(cfg, shape, mesh))


def _train_state(cfg, mesh, opts, device) -> dict:
    """Rank 0's train state of fake leaves: each parameter, ``m`` and ``v``
    leaf its ``param_specs`` block as a ``DTensor`` (``state_shardings``'
    layout); call under a fake mode, after ``mesh.device_mesh`` exists."""
    from torch.distributed.tensor import Replicate

    from ..distributed import sharding as shr
    from ..models import api
    from ..training.train_loop import _wants_err

    shapes = api.param_shapes(cfg)
    specs = shr.param_specs(shapes, mesh)
    coord = mesh.get_coordinate()

    def leaves(path, shape):
        placements = specs
        for k in path:
            placements = placements[k]
        idx = shr.local_slices(shape, placements, mesh.shape, coord)
        local = torch.empty(tuple(s.stop - s.start for s in idx),
                            dtype=torch.float32, device=device)
        return mesh.dtensor(local, placements, shape)

    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    state = {"params": _tree_map(leaves, shapes),
             "opt": {"m": _tree_map(leaves, shapes),
                     "v": _tree_map(leaves, shapes),
                     "step": mesh.dtensor(torch.zeros(
                         (), dtype=torch.int32, device=device), rep, ())}}
    if _wants_err(mesh, opts):
        state["err"] = _tree_map(leaves, shapes)
    return state


def _serving_params(cfg, mesh, device) -> dict:
    """Rank 0's serving parameters as fake leaves: each leaf its
    ``param_specs`` block, as ``api.init(..., keep=sharding.param_keep
    (mesh))`` keeps it."""
    from ..distributed import sharding as shr
    from ..models import api

    shapes = api.param_shapes(cfg)
    specs = shr.param_specs(shapes, mesh)
    coord = mesh.get_coordinate()

    def leaf(path, shape):
        placements = specs
        for k in path:
            placements = placements[k]
        idx = shr.local_slices(shape, placements, mesh.shape, coord)
        return torch.empty(tuple(s.stop - s.start for s in idx),
                           dtype=torch.float32, device=device)
    return _tree_map(leaf, shapes)


def _locals(tree) -> list:
    """The local tensors of a tree's tensor leaves (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    out = []
    if isinstance(tree, (dict, tuple, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            out += _locals(v)
    elif isinstance(tree, DTensor):
        out.append(tree._local_tensor)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def build_cell(arch: str, shape_name: str, multi_pod: bool, *,
               device: str = "cuda", fake_mode=None):
    """``(mesh, fn, args, extra)``: the production mesh on the running
    (fake) world, the production step, and rank 0's fake CPU leaves,
    made in ``fake_mode`` (a new ``FakeTensorMode`` by default), for a
    trace of ``device``'s program (``trace_cell``)."""
    from ..configs import SHAPES, get_config
    from ..launch.mesh import dp_axes, make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    dev = _FAKE_DEVICE
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    mesh.device_mesh                 # built before the fake mode starts
    dp = mesh.axis_size(dp_axes(mesh))
    fake_mode = fake_mode or _fake_mode()
    if shape.kind == "train":
        from ..training import TrainOptions, make_train_step
        nm = max(1, shape.global_batch // dp)  # 1 sequence/device/microbatch
        if os.environ.get("REPRO_NM"):
            nm = int(os.environ["REPRO_NM"])
        opts = TrainOptions(
            num_microbatches=nm,
            grad_compression=os.environ.get("REPRO_COMPRESS", "none"))
        with fake_mode:
            args = (_train_state(cfg, mesh, opts, dev),
                    _batch(cfg, shape, dev))
        fn = make_train_step(cfg, mesh, opts)
        extra = {"num_microbatches": nm}
    else:
        from ..models import api
        # the parameters' placements, drawn on the meta device before the
        # trace so that its memory holds the step's storages alone
        api.MeshRows(cfg, mesh, shape.global_batch)
        with fake_mode:
            args = (_serving_params(cfg, mesh, dev),
                    _batch(cfg, shape, dev, mesh))
        if shape.kind == "prefill":
            fn = lambda p, b: api.prefill(p, cfg, b, mesh=mesh)
        else:
            fn = lambda p, b: api.decode(p, cfg, b, mesh=mesh)
        extra = {}
    return mesh, fn, args, extra


def trace_cell(fn, args, fake_mode, *, card: bool = True) -> dict:
    """Trace ``fn(*args)`` (fake leaves of ``fake_mode``) under the census
    and the memory tracker: ``{"census", "collectives", "memory",
    "trace_s"}``.  ``card``: the card's program (the fake leaves traced
    inside ``census_hooks.fake_card``)."""
    from .census import fake_card, trace_memory

    t0 = time.time()
    with fake_mode, (fake_card() if card else contextlib.nullcontext()):
        _, census, memory = trace_memory(fn, args, _locals(args))
    return {"trace_s": round(time.time() - t0, 2),
            "collectives": census.pop("collectives"), "census": census,
            "memory": memory}


def trace_one_card(cfg, shape, *, opts=None, device: str = "cuda") -> dict:
    """``trace_cell``'s dict for one step of ``cfg`` at ``shape`` (a
    ``configs.ShapeSpec``) on one card, without a mesh or a world: the
    train step of ``opts`` (``make_train_step(cfg, None, opts)``; the state
    of ``init_train_state``, whole) or ``api.prefill`` / ``api.decode``, on
    fake leaves of ``device``'s program.  What ``chip_smoke.py`` holds a
    real step's census to."""
    from ..models import api
    from ..training import TrainOptions, make_train_step

    dev = _FAKE_DEVICE
    fake_mode = _fake_mode()
    with fake_mode:
        if shape.kind == "train":
            params = _tree_map(lambda _, s: torch.empty(
                s, dtype=torch.float32, device=dev), api.param_shapes(cfg))
            moment = lambda: _tree_map(lambda _, p: torch.empty_like(p),
                                       params)
            state = {"params": params,
                     "opt": {"m": moment(), "v": moment(),
                             "step": torch.zeros((), dtype=torch.int32,
                                                 device=dev)}}
            args = (state, _batch(cfg, shape, dev))
        else:
            args = (_tree_map(lambda _, s: torch.empty(
                s, dtype=torch.float32, device=dev), api.param_shapes(cfg)),
                _batch(cfg, shape, dev))
    if shape.kind == "train":
        fn = make_train_step(cfg, None, opts or TrainOptions())
    elif shape.kind == "prefill":
        fn = lambda p, b: api.prefill(p, cfg, b)
    else:
        fn = lambda p, b: api.decode(p, cfg, b)
    return trace_cell(fn, args, fake_mode, card=device == "cuda")


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, *,
             device: str = "cuda") -> dict:
    """Dry-run one cell in this process (a fake world of 256 or 512 ranks,
    destroyed after the cell) and write its record into ``out_dir``."""
    multi = mesh_kind == "multi"
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "ok": False}
    if dist.is_initialized():
        raise RuntimeError("run_cell starts a fake world of its own; this "
                           "process already has a world")
    fake_world(512 if multi else 256)
    try:
        record["route"] = device
        fake_mode = _fake_mode()
        mesh, fn, args, extra = build_cell(arch, shape_name, multi,
                                           device=device, fake_mode=fake_mode)
        record.update(extra, n_devices=int(mesh.size()))
        record.update(trace_cell(fn, args, fake_mode,
                                 card=device == "cuda"))
        record["ok"] = True
    except Exception as exc:  # noqa: BLE001 - the record carries it
        tb = traceback.extract_tb(exc.__traceback__)[-3:]
        where = " <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                            for f in reversed(tb))
        record["error"] = f"{type(exc).__name__}: {exc} [{where}]"[:2000]
    finally:
        dist.destroy_process_group()
    record["total_s"] = round(time.time() - t0, 2)

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}--{shape_name}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


# --------------------------------------------------------------------------
# Sweep driver
# --------------------------------------------------------------------------

def all_cells() -> list[tuple[str, str]]:
    from ..configs import get_config, list_archs, shapes_for
    cells = []
    for arch in list_archs():
        for shape in shapes_for(get_config(arch)):
            cells.append((arch, shape.name))
    return cells


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACTS)
    ap.add_argument("--timeout", type=int, default=7200)
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="trace the card's program (default) or the plain "
                         "route's")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mk in meshes:
            rec = run_cell(args.arch, args.shape, mk,
                           os.path.join(args.out, mk), device=args.device)
            print(json.dumps({k: rec[k] for k in
                              ("arch", "shape", "mesh", "ok", "route",
                               "total_s") if k in rec}
                             | ({"error": rec["error"]} if "error" in rec
                                else {})))
        return 0

    # sweep: one subprocess per cell so a crash cannot kill the sweep
    failures = 0
    for mk in meshes:
        for arch, shape in all_cells():
            out_json = os.path.join(args.out, mk, f"{arch}--{shape}.json")
            if args.skip_done and os.path.exists(out_json):
                with open(out_json) as f:
                    if json.load(f).get("ok"):
                        print(f"[skip] {mk} {arch} {shape}")
                        continue
            t0 = time.time()
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mk,
                   "--out", args.out, "--device", args.device]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=args.timeout)
                ok = proc.returncode == 0 and os.path.exists(out_json)
                if ok:
                    with open(out_json) as f:
                        ok = json.load(f).get("ok", False)
                if not ok:
                    failures += 1
                    err = (proc.stderr or "")[-500:]
                    os.makedirs(os.path.dirname(out_json), exist_ok=True)
                    if not os.path.exists(out_json):
                        with open(out_json, "w") as f:
                            json.dump({"arch": arch, "shape": shape,
                                       "mesh": mk, "ok": False,
                                       "error": err}, f)
                print(f"[{'ok' if ok else 'FAIL'}] {mk} {arch} {shape} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            except subprocess.TimeoutExpired:
                failures += 1
                print(f"[TIMEOUT] {mk} {arch} {shape}", flush=True)
    print(f"sweep done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
