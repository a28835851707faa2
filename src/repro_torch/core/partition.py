"""Weighted input partitioning (paper Eqs. 1–7, Sec. 4.1).

Chunk 0 is matched from q0 only; chunks 1..P-1 are matched speculatively for
``m`` states (``m = |Q|`` basic / ``I_max,r`` optimized).  To equalize work,
chunk 0 is ``m``x longer (Eq. 2); processor capacity weights ``w_k`` (Eq. 1)
scale every chunk.  This is the paper's failure-freedom mechanism: total
symbols matched per processor are equal, so the parallel run can never lose to
the sequential one by more than the merge epsilon.

Used at the *host/data-pipeline* level, where shards may be ragged.  Device-
level SPMD matching uses uniform chunks with masked speculative lanes (see
DESIGN.md §2); both partitioners live here so the equations are in one place.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Partition", "weighted_partition", "uniform_partition", "capacity_weights"]


@dataclasses.dataclass
class Partition:
    start: np.ndarray  # [P] int64, inclusive
    end: np.ndarray    # [P] int64, exclusive
    m: int             # states matched per speculative chunk

    @property
    def sizes(self) -> np.ndarray:
        return self.end - self.start

    def work(self) -> np.ndarray:
        """Symbols matched per processor (speculative chunks match m states)."""
        w = self.sizes.astype(np.float64).copy()
        w[1:] *= self.m
        return w


def capacity_weights(m_k: np.ndarray) -> np.ndarray:
    """Eq. 1: normalize measured capacities by the mean capacity."""
    m_k = np.asarray(m_k, dtype=np.float64)
    if (m_k <= 0).any():
        raise ValueError("capacities must be positive")
    return m_k / m_k.mean()


def weighted_partition(n: int, weights: np.ndarray, m: int) -> Partition:
    """Eqs. 5–7 with m = |Q| or I_max,r; returns [start, end) per processor.

    Degenerate chunks (size 0) are legal for tiny inputs; the matcher treats
    them as identity L-vectors.
    """
    w = np.asarray(weights, dtype=np.float64)
    p = w.shape[0]
    if p < 1:
        raise ValueError("need at least one processor")
    if m < 1:
        raise ValueError("m must be >= 1")
    if p == 1:
        return Partition(start=np.array([0]), end=np.array([n]), m=m)
    # Eq. 5
    l0 = n * m / (w[0] * m + w[1:].sum())
    start = np.zeros(p, dtype=np.int64)
    end = np.zeros(p, dtype=np.int64)
    # Eq. 6/7; boundary_k = L0 * (w0 + (1/m) * sum_{1<=i<=k} w_i).  Cumulate
    # the weights first and multiply by L0 once: the running-sum form
    # ``acc += l0 * w_i / m`` drifts by ulps, enough to disagree with
    # ``uniform_partition`` by one symbol under equal capacities (the
    # degradation is exact with this formulation — tests rely on it).
    bounds = l0 * (w[0] + np.concatenate([[0.0], np.cumsum(w[1:])]) / m)
    prev = 0
    for k in range(p):
        start[k] = prev
        end[k] = n if k == p - 1 else min(n, int(np.floor(bounds[k])))
        end[k] = max(end[k], start[k])
        prev = end[k]
    return Partition(start=start, end=end, m=m)


def uniform_partition(n: int, p: int, m: int) -> Partition:
    """Equal-size chunks (paper Fig. 3; also the SPMD device-level layout)."""
    edges = np.linspace(0, n, p + 1).astype(np.int64)
    return Partition(start=edges[:-1], end=edges[1:], m=m)
