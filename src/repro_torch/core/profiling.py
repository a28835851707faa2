"""Offline capacity profiling (paper Sec. 4.1 step 1, Eq. 1).

On heterogeneous fleets the partitioner needs per-worker matching
capacities ``m_k`` (symbols/us).  The paper measures several partial
matching runs and takes the *median*; so does ``profile_capacity``, against
a benchmark DFA, with the sequential matcher (``sequential_state``: kernel
B6 with one lane on a card, a host loop on the CPU).  ``profile_workers``
turns capacities into the Eq. 1 weights that ``SpecDFAEngine(weights=...)``
takes; ``synthetic_capacities`` makes a skewed fleet for benchmarks and
tests.  The shape autotuner and the observed-traffic profile of the JAX
package's module are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .automata import DFA, random_dfa
from .engine import sequential_state
from .engine.plan import resolve_device
from .partition import capacity_weights

__all__ = ["profile_capacity", "profile_workers", "synthetic_capacities",
           "calibrated_capacities", "clear_calibration_cache"]


def profile_capacity(dfa: DFA | None = None, *, n_symbols: int = 200_000,
                     repeats: int = 5, seed: int = 0, devices=None,
                     device=None) -> float | np.ndarray:
    """Median symbols/us of the sequential matcher (paper Sec. 4.1 step 1).

    With ``devices=None`` (the default): one measurement on ``device`` (the
    card unless the caller names another; raises without one), returned as
    a float.  With ``devices=`` a sequence of torch devices: the same
    benchmark run timed per device (table and symbol stream placed there)
    and a [D] symbols/us array returned, ready for ``profile_workers``.
    On a card every timed run ends in ``torch.cuda.synchronize()``.
    """
    rng = np.random.default_rng(seed)
    if dfa is None:
        dfa = random_dfa(64, 16, rng=rng)
    table_np = np.asarray(dfa.table, np.int32)
    classes_np = rng.integers(0, dfa.n_classes, size=n_symbols, dtype=np.int32)

    def measure(device) -> float:
        dev = resolve_device(device)
        table = torch.as_tensor(table_np, device=dev)
        classes = torch.as_tensor(classes_np, device=dev)

        def run():
            sequential_state(table, classes, dfa.start)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        run()  # warmup (and the kernel build, on a card)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return n_symbols / (float(np.median(times)) * 1e6)

    if devices is None:
        return measure(device)
    return np.array([measure(d) for d in devices], dtype=np.float64)


# (device set, benchmark signature) -> measured [D] capacities: one timed
# benchmark per device set per process; ``refresh`` re-measures.
_CALIBRATION_CACHE: dict[tuple, np.ndarray] = {}


def _calibration_key(devices, dfa: DFA | None, n_symbols: int, repeats: int,
                     seed: int) -> tuple:
    # a custom benchmark DFA changes what is being measured -> its content
    # hashes into the key; the default benchmark is pinned by its parameters
    sig = ("default",) if dfa is None else (
        dfa.table.shape, dfa.table.tobytes(), int(dfa.start))
    return (tuple(str(d) for d in devices), sig, int(n_symbols),
            int(repeats), int(seed))


def calibrated_capacities(devices, dfa: DFA | None = None, *,
                          n_symbols: int = 200_000, repeats: int = 5,
                          seed: int = 0, refresh: bool = False) -> np.ndarray:
    """Cached ``profile_capacity`` over a device set (one measurement per
    (device set, benchmark) pair per process).

    ``refresh=True`` forces a re-measurement and replaces the cache entry.
    Returns a copy; mutating the result never corrupts the cache.
    """
    key = _calibration_key(devices, dfa, n_symbols, repeats, seed)
    if refresh or key not in _CALIBRATION_CACHE:
        _CALIBRATION_CACHE[key] = np.asarray(
            profile_capacity(dfa, n_symbols=n_symbols, repeats=repeats,
                             seed=seed, devices=list(devices)), np.float64)
    return _CALIBRATION_CACHE[key].copy()


def clear_calibration_cache() -> None:
    """Drop every cached calibration (tests; full cluster restart)."""
    _CALIBRATION_CACHE.clear()


def profile_workers(capacities: np.ndarray | list[float]) -> np.ndarray:
    """Eq. 1 weights from measured capacities (one entry per worker)."""
    return capacity_weights(np.asarray(capacities, dtype=np.float64))


def synthetic_capacities(n_workers: int, *, ratio: float = 1.41,
                         n_fast: int | None = None) -> np.ndarray:
    """Deliberately skewed capacity profile for benchmarks and tests.

    ``n_fast`` workers run at ``ratio``x the base speed - 1.41 is the paper's
    measured gap between its two EC2 instance generations (Table 3); the
    default skews half the fleet.  Feed the result to ``profile_workers``
    to exercise the capacity-balanced partition without a real
    heterogeneous fleet.
    """
    if n_workers < 1:
        raise ValueError("need at least one worker")
    if n_fast is None:
        n_fast = n_workers // 2
    if not 0 <= n_fast <= n_workers:
        raise ValueError("n_fast out of range")
    return np.array([ratio] * n_fast + [1.0] * (n_workers - n_fast),
                    dtype=np.float64)
