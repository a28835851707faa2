"""Helpers the traffic generators share: seeded streams, stratified lengths
and planting strings into byte buffers.

Every generator gives each seed the same set of sizes: a call's document
lengths are one fixed stratified grid, shuffled by the seed, so seeds change
the bytes and their order and never the amount of work.
"""

from __future__ import annotations

import numpy as np


def streams(seed: int, n: int) -> list[np.random.Generator]:
    """``n`` independent generators drawn from ``seed`` (any whole number)."""
    seq = np.random.SeedSequence([abs(int(seed)), int(int(seed) < 0)])
    return [np.random.default_rng(s) for s in seq.spawn(n)]


def stratified_lengths(rng: np.random.Generator, n: int, lo: int,
                       hi: int) -> np.ndarray:
    """``n`` lengths on the midpoints of ``n`` equal strata of [lo, hi], in
    an order drawn from ``rng``: uniform in [lo, hi], the same set for
    every seed."""
    grid = lo + np.floor((hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)
    return rng.permutation(grid)


def plant(buf: np.ndarray, text: bytes, pos: int) -> None:
    """Write ``text`` into ``buf`` at ``pos``."""
    buf[pos:pos + len(text)] = np.frombuffer(text, np.uint8)


def plant_across_boundary(rng: np.random.Generator, buf: np.ndarray,
                          text: bytes, stride: int) -> bool:
    """Write ``text`` so that it spans a multiple of ``stride``: at least one
    byte before the boundary and one at or after it.  False (nothing
    written) where the buffer holds no such place."""
    n, m = buf.shape[0], len(text)
    if m < 2:
        return False
    last = (n - 1) // stride  # boundaries at stride, 2 * stride, ...
    bounds = stride * np.arange(1, last + 1)
    bounds = bounds[bounds + m - 1 <= n]
    if bounds.size == 0:
        return False
    b = int(rng.choice(bounds))
    plant(buf, text, b - int(rng.integers(1, m)))
    return True
