"""End-to-end training driver, on one device or on an LM mesh.

Wires the substrate together: synthetic corpus -> DFA block-list filter
(``CorpusFilter``: the paper's engine as a pipeline stage, kernel B1 on the
card) -> packed batches -> the microbatched train step -> async checkpoints
-> restart on failure.  On the card (the default device), at full width:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 100 --batch 16 --seq 4096 --microbatches 4

``--layers N`` keeps the arch's widths and cuts its depth to N layers (a
quick run of the full-width path: ``chip_smoke.py`` drives the launcher
so).  On the CPU, at the reduced smoke width:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 20 --batch 8 --seq 256

On a ("data", "model") mesh, one process a rank (here four ranks, 2 x 2):

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch tinyllama-1.1b --mesh-data 2 \\
      --mesh-model 2

(a caller's own ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
work too; ``--log-collectives`` prints each logged step's collectives).
The world initialises on NCCL where each rank has its own card and on
gloo otherwise (ranks sharing one card, or ``--device cpu``);
every rank reads the same filtered stream, the sharded step
(``training.train_loop``) takes each rank's rows, and rank 0 alone prints
and writes checkpoints.

The weights are random, from seed 0.  Host batches reach the device with
one pinned, non-blocking copy a step.  ``--resume`` restores the latest
checkpoint under ``--ckpt-dir`` onto this run's mesh (whatever mesh saved
it) and, unlike the JAX package's driver (which restarts the stream),
skips the batches the restored steps consumed, so a resumed run sees the
batches an uninterrupted run would.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config, reduce_for_smoke
from ..data import (CorpusConfig, CorpusFilter, LoaderConfig, data_stream,
                    generate_documents)
from ..distributed import sharding as shr
from ..distributed.fault_tolerance import RestartManager
from ..launch import mesh as lmesh
from ..training import (AdamWConfig, CheckpointManager, TrainOptions,
                        init_train_state, make_train_step)
from ..training.train_loop import (init_train_state_sharded, jit_train_step,
                                   state_shardings)


def corpus_batches(cfg, batch: int, seq: int, patterns, *, device,
                   docs=None):
    """The launcher's data: ``docs`` (default: the synthetic corpus, 10,000
    documents of ``4 * seq`` bytes from seed 1) through a ``CorpusFilter``
    of ``patterns`` on ``device`` (kernel B1 on the card), packed into
    ``[batch, seq]`` token and label blocks modulo the vocabulary.
    Returns (an iterator of host batches, the filter)."""
    if docs is None:
        docs = generate_documents(CorpusConfig(n_documents=10_000,
                                               doc_len=seq * 4, seed=1))
    filt = CorpusFilter(patterns, num_chunks=8, device=device)
    stream = data_stream(docs, LoaderConfig(batch_size=batch, seq_len=seq),
                         corpus_filter=filt)
    return ({"tokens": b["tokens"] % cfg.vocab_size,
             "labels": b["labels"] % cfg.vocab_size} for b in stream), filt


def batch_to_device(batch: dict, device) -> dict:
    """A host batch's tokens and labels on ``device``: one pinned,
    non-blocking copy on the card."""
    device = torch.device(device)
    host = torch.from_numpy(np.stack([batch["tokens"], batch["labels"]]))
    if device.type == "cuda":
        host = host.pin_memory()
    both = host.to(device, non_blocking=True)
    return {"tokens": both[0], "labels": both[1]}


def init_world(device: str):
    """Initialise the world of a multi-process run from the environment
    (``torch.distributed.run``'s, or the caller's): NCCL where each local
    rank has a card of its own, gloo otherwise.  Returns whether this call
    initialised it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    own_card = device == "cuda" and torch.cuda.device_count() >= local
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method="env://",
                            timeout=lmesh.GROUP_TIMEOUT)
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers at its widths "
                         "(0: the arch's depth)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--filter-patterns", nargs="*",
                    default=[r"SECRET-[0-9]+"])
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print a step line every this many steps")
    ap.add_argument("--log-collectives", action="store_true",
                    help="time each step's collectives on a mesh and print "
                         "them beside its step line (launch.mesh.MESH_STATS"
                         ": calls, bytes, host seconds and the largest "
                         "call's bytes by name and axes); the timing "
                         "synchronises the device around each collective")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    n_mesh = args.mesh_data * args.mesh_model
    mesh, ours = None, False
    if n_mesh > 1 or world > 1:
        if world != n_mesh:
            raise ValueError(f"--mesh-data {args.mesh_data} --mesh-model "
                             f"{args.mesh_model} takes {n_mesh} processes, "
                             f"the world has {world}")
        ours = init_world(args.device)
        mesh = lmesh.make_local_mesh(
            args.mesh_data, args.mesh_model,
            device=None if args.device == "cuda" else args.device)
        device = mesh.device
    else:
        device = torch.device(args.device)
    try:
        _train(args, cfg, mesh, device)
    finally:
        if ours:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, cfg, mesh, device) -> None:
    import torch.distributed as dist
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)

    batches, filt = corpus_batches(cfg, args.batch, args.seq,
                                   args.filter_patterns, device=device)

    opts = TrainOptions(
        num_microbatches=args.microbatches,
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps))
    if mesh is None:
        state = init_train_state(cfg, 0, device=device, opts=opts)
        step_fn = make_train_step(cfg, None, opts)
        shardings = None
    else:
        state = init_train_state_sharded(cfg, 0, mesh, opts)
        rows = torch.empty((args.batch, args.seq), device="meta")
        bspecs = shr.batch_specs({"tokens": rows, "labels": rows}, mesh,
                                 args.batch)
        step_fn = jit_train_step(cfg, mesh, state, bspecs, opts)
        shardings = state_shardings(state, mesh)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume:
        t0 = time.perf_counter()
        state, start = mgr.restore(state, shardings)
        say(f"resumed from step {start} in "
            f"{time.perf_counter() - t0:.2f} s")
        batches = itertools.islice(batches, start, None)

    log_coll = args.log_collectives and mesh is not None
    if log_coll:
        lmesh.time_collectives(True)

    def one_step(st, i):
        if log_coll:
            lmesh.reset_mesh_stats()
        st, metrics = step_fn(st, batch_to_device(next(batches), device))
        if i % args.log_every == 0:
            say(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e}")
            if log_coll:
                say(f"collectives step {i}: "
                    f"{json.dumps(dict(sorted(lmesh.MESH_STATS.items())))}")
        return st

    def save(st, step):
        t0 = time.perf_counter()
        mgr.save(st, step)
        say(f"checkpoint step {step}: save blocked "
            f"{time.perf_counter() - t0:.2f} s")

    rm = RestartManager(save_fn=save,
                        restore_fn=lambda: mgr.restore(state, shardings))
    t0 = time.time()
    state, at = rm.run(state, start, args.steps, one_step,
                       checkpoint_every=args.ckpt_every)
    if at % args.ckpt_every:      # the loop saved a multiple already
        save(state, at)
    mgr.wait()
    dt = time.time() - t0
    say(f"done: {at} steps in {dt:.1f}s "
        f"({args.batch * args.seq * (at - start) / max(dt, 1e-9):.0f} "
        f"tok/s); filter dropped {filt.stats.dropped}/"
        f"{filt.stats.scanned} docs, model-speedup "
        f"{filt.stats.model_speedup:.2f}x")


if __name__ == "__main__":
    main()
