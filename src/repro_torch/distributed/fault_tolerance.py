"""Fault tolerance: restart policy and straggler tracking.

The port of the JAX package's ``distributed/fault_tolerance.py``:

  * **Retry with restore** — ``RestartManager`` wraps a step loop, catches
    failures, restores the latest saved state and resumes; the streaming
    scheduler runs every tick dispatch under it.
  * **Elastic re-mesh** — ``reshard_tree`` waits for the sharded tier
    (ROADMAP A14) and raises.
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


def reshard_tree(host_tree: Any, shardings: Any) -> Any:
    """Place a host-side checkpoint tree under new shardings: not ported yet
    (the sharded tier, ROADMAP A14)."""
    raise NotImplementedError("reshard_tree is not ported yet (ROADMAP A14)")


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
