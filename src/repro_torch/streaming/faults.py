"""Deterministic fault injection for the streaming runtime.

A production streaming tier fails in three distinct ways, and a recovery
layer is only trustworthy when every one of them is exercised on demand:

  * a **tick dispatch raises** — device loss, OOM, a preempted host.  The
    ``"pre"`` phase models the fused call failing before any result landed;
    the ``"post"`` phase models the nastier case where the failure surfaces
    *after* cursors were already updated, so recovery must restore them from
    their pre-tick snapshots or segments get double-composed;
  * a **device degrades** — it still answers, slower.  ``delay_s`` adds
    per-device seconds to the observed tick timings that feed the
    ``StragglerPolicy`` EWMA (``MicroBatchScheduler._feed_straggler``);
  * a **capacity measurement is corrupted** — ``capacity_skew`` multiplies
    the observed per-device times, standing in for a host whose profiled
    capacity no longer reflects reality.

``FaultPlan`` schedules all three by tick index, so every recovery path of
the scheduler (retry-with-restore, requeue-on-giveup, EWMA-triggered
rebalance) runs deterministically in tests and CI (``tools/faultbench.py``).
The scheduler consumes the plan through exactly two hooks — ``maybe_fail``
around the dispatch and ``device_times`` on the observed timings — so a plan
can be attached to any ``MicroBatchScheduler`` without touching its logic.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = ["InjectedFault", "FaultPlan"]


class InjectedFault(RuntimeError):
    """A scheduled dispatch failure (stands in for device loss / OOM)."""


@dataclasses.dataclass
class FaultPlan:
    """Tick-indexed fault schedule consumed by ``MicroBatchScheduler``.

    ``kill[t] = n`` fails the first ``n`` dispatch attempts of tick ``t``
    before the fused call runs; ``kill_post[t] = n`` fails them *after* the
    cursors were updated (the double-compose hazard).  ``delay_s[t]`` is a
    per-device [D] array of extra seconds and ``capacity_skew[t]`` a [D]
    multiplier (> 1 = slower), both folded into the timings the straggler
    EWMA sees.  ``injected`` counts faults actually raised.
    """

    kill: Mapping[int, int] = dataclasses.field(default_factory=dict)
    kill_post: Mapping[int, int] = dataclasses.field(default_factory=dict)
    delay_s: Mapping[int, Sequence[float]] = dataclasses.field(
        default_factory=dict)
    capacity_skew: Mapping[int, Sequence[float]] = dataclasses.field(
        default_factory=dict)
    injected: int = 0

    def maybe_fail(self, tick: int, attempt: int, phase: str) -> None:
        """Raise ``InjectedFault`` if the schedule kills this attempt.

        ``phase`` is ``"pre"`` (before the fused dispatch) or ``"post"``
        (after cursors were committed — recovery must roll them back).
        """
        if phase not in ("pre", "post"):
            raise ValueError(f"unknown fault phase {phase!r}")
        plan = self.kill if phase == "pre" else self.kill_post
        if attempt < int(plan.get(tick, 0)):
            self.injected += 1
            raise InjectedFault(
                f"injected {phase}-dispatch fault (tick {tick}, "
                f"attempt {attempt})")

    def device_times(self, tick: int, base: np.ndarray) -> np.ndarray:
        """Per-device observed times for one tick: base + delays, skewed."""
        t = np.asarray(base, np.float64).copy()
        delay = self.delay_s.get(tick)
        if delay is not None:
            t = t + np.asarray(delay, np.float64)
        skew = self.capacity_skew.get(tick)
        if skew is not None:
            t = t * np.asarray(skew, np.float64)
        return t
