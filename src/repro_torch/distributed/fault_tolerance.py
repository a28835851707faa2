"""Fault tolerance: restart policy and straggler tracking.

The port of the JAX package's ``distributed/fault_tolerance.py``:

  * **Retry with restore** — ``RestartManager`` wraps a step loop, catches
    failures, restores the latest saved state and resumes; the streaming
    scheduler runs every tick dispatch under it.
  * **Elastic re-mesh** — ``reshard_tree`` places a host-side checkpoint
    tree under new shardings on a ``DeviceMesh``, whatever mesh it was saved
    from (``training.checkpoint.restore_checkpoint(shardings=...)`` and the
    sharded restore of session snapshots ride it).
  * **Straggler mitigation** — the paper's own mechanism (Eq. 1/5): per-host
    throughput is profiled (core/profiling.py) and the weighted partitioner
    sizes host input shards; persistently slow hosts get proportionally less
    data instead of gating every step.  ``StragglerPolicy`` tracks EWMA step
    times and triggers re-profiling + re-partitioning past a threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from ..core.partition import capacity_weights, weighted_partition

__all__ = ["RestartManager", "reshard_tree", "StragglerPolicy"]


class RestartManager:
    """Retry-with-restore wrapper around a training step loop."""

    def __init__(self, save_fn: Callable[[Any, int], None],
                 restore_fn: Callable[[], tuple[Any, int]],
                 max_restarts: int = 3):
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.restarts = 0
        self.failures: list[tuple[int, str]] = []

    def run(self, state, start_step: int, n_steps: int,
            step_fn: Callable[[Any, int], Any],
            checkpoint_every: int = 50):
        step = start_step
        while step < n_steps:
            try:
                state = step_fn(state, step)
                step += 1
                if step % checkpoint_every == 0:
                    self.save_fn(state, step)
            except Exception as exc:  # noqa: BLE001 — any worker fault
                self.failures.append((step, repr(exc)))
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self.restore_fn()
        return state, step


def _is_sharding(s: Any) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import LMMesh
    return (isinstance(s, tuple) and len(s) == 2
            and isinstance(s[0], (DeviceMesh, LMMesh)))


def reshard_tree(host_tree: Any, shardings: Any) -> Any:
    """Place a host-side (numpy or tensor) checkpoint tree under new
    shardings.

    ``shardings`` mirrors the tree's dicts, lists and tuples; each leaf's
    sharding is ``(DeviceMesh, placements)`` and the leaf becomes
    ``torch.distributed.tensor.distribute_tensor(leaf, mesh, placements)``
    (a ``None`` sharding leaves the leaf as it is).  On an LM mesh
    (``launch.mesh.LMMesh``) each rank keeps its block of the leaf on its
    own device, a ``DTensor`` of the mesh's device type; no collective
    runs, since every rank holds the whole tree.  It works across mesh
    shape changes, since the tree is whole on the host: the elastic path
    (a snapshot taken on one mesh restored on another).  Placement is
    collective: call it on every rank of the mesh with the same tree.
    """
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ..launch.mesh import LMMesh

    def place(x, s):
        if s is None:
            return x
        if _is_sharding(s):
            mesh, placements = s
            t = (x.detach() if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x)))   # 0-d stays 0-d
            if isinstance(mesh, LMMesh):
                from .sharding import local_block
                block = local_block(t, placements, mesh).to(
                    mesh.device, copy=True)
                return mesh.dtensor(block, placements, tuple(t.shape))
            return distribute_tensor(t, mesh, list(placements))
        if isinstance(x, dict):
            return {k: place(v, s[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v, si) for v, si in zip(x, s))
        raise ValueError(f"no sharding for a leaf of type {type(x).__name__}")

    return place(host_tree, shardings)


@dataclasses.dataclass
class StragglerPolicy:
    """EWMA step-time tracking -> re-profile + re-partition trigger."""

    n_workers: int
    threshold: float = 1.3     # worker slower than 1.3x fleet median
    alpha: float = 0.2
    ewma: Optional[np.ndarray] = None

    def update(self, per_worker_times: np.ndarray) -> bool:
        t = np.asarray(per_worker_times, dtype=np.float64)
        self.ewma = t if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * t
        return bool((self.ewma / np.median(self.ewma)).max() > self.threshold)

    def capacities(self) -> np.ndarray:
        """Observed per-worker capacities (1 / EWMA time) — the Eq. 1 inputs.

        Feed straight into ``Matcher.rebalance``: the streaming scheduler
        does exactly that when ``update`` trips, so a degraded device's
        decayed timing becomes a proportionally smaller chunk of every
        bucket (paper Eq. 5) without re-running offline calibration.
        """
        if self.ewma is None:
            raise ValueError("no step times observed yet")
        return 1.0 / np.maximum(self.ewma, 1e-9)

    def rebalanced_shards(self, n_items: int, m: int = 1):
        """New weighted partition from observed speeds (paper Eqs. 1/5)."""
        return weighted_partition(n_items, capacity_weights(self.capacities()),
                                  m)
