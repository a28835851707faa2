"""L-vector algebra (paper Sec. 4.1, Eqs. 8–9) and merge strategies.

An L-vector for chunk i is the map ``L_i[j] = delta*(q_j, chunk_i)``.  L-vectors
compose associatively: ``(L_i ; L_j)[q] = L_j[L_i[q]]`` (function composition,
Eq. 9), with identity ``L_id[q] = q``.  This monoid is what makes every merge
strategy — sequential (Eq. 8), binary-tree reduction and a log-depth scan —
produce the same result.

Two representations:
  * full maps   [Q]        — compose with a gather; used by merges.
  * compressed  [I_max]    — per-chunk result for candidate initial states only
                              (the lookahead-optimized matcher's output).
Compressed vectors merge with ``merge_compressed`` which walks chunks carrying
one state, using the candidate inverse index (sink-safe).  Keyed ``[K, S]``
lane maps scan with ``merge_scan_lanes_torch``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.ref import compose_lanes_torch

__all__ = [
    "identity_lvec", "compose", "compose_torch", "merge_sequential",
    "merge_tree", "merge_scan_lanes_torch", "merge_compressed",
]


def identity_lvec(q: int) -> np.ndarray:
    return np.arange(q, dtype=np.int32)


def compose(l1: np.ndarray, l2: np.ndarray) -> np.ndarray:
    """Eq. 9: first apply l1 then l2 (numpy host form)."""
    return l2[l1]


def compose_torch(l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Eq. 9 on tensors; supports leading batch dims on both operands."""
    return torch.gather(l2, -1, l1.long())


def merge_sequential(lvecs: np.ndarray, start: int) -> int:
    """Eq. 8: fold full maps left-to-right from the known start state."""
    s = int(start)
    for i in range(lvecs.shape[0]):
        s = int(lvecs[i, s])
    return s


def merge_tree(lvecs: np.ndarray) -> np.ndarray:
    """Binary-tree reduction of full maps (the parallel reduction of [19])."""
    maps = [lvecs[i] for i in range(lvecs.shape[0])]
    if not maps:
        raise ValueError("no maps")
    while len(maps) > 1:
        nxt = []
        for i in range(0, len(maps) - 1, 2):
            nxt.append(compose(maps[i], maps[i + 1]))
        if len(maps) % 2:
            nxt.append(maps[-1])
        maps = nxt
    return maps[0]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Axis-0 interleave: ``out[0::2] = even``, ``out[1::2] = odd``."""
    out = even.new_empty((even.shape[0] + odd.shape[0], *even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def merge_scan_lanes_torch(
    lane_maps: torch.Tensor,   # [..., N, K, S] candidate-keyed lane maps
    entry_keys: torch.Tensor,  # [..., N] boundary key of each map's entry row
    cand_index: torch.Tensor,  # [n_keys + 1, Q] inverse candidate map (pad row -1)
    sinks: torch.Tensor,       # [K] per-pattern sink state (-1 = none)
    *,
    pad_key: int,
    axis: int = 0,
) -> torch.Tensor:
    """All-prefix composition of candidate-keyed [K, S] lane maps.

    Each scan element is a segment's restricted transition map (lane s of
    pattern k holds delta*(candidates[key][k, s], segment)) together with
    the boundary key that selects its candidate entry row.  Composition
    locates the left map's carried states inside the right map's candidate
    row via ``cand_index`` (Eq. 11); a missing candidate is the pattern's
    sink by construction.  Keys equal to ``pad_key`` compose as the
    identity, so runs may be padded on the right to a fixed N.
    ``out[..., i, :, :]`` is the composition of maps 0..i; element 0's key
    is never read.

    A log-depth scan over ``axis`` in the odd/even recursion of
    ``jax.lax.associative_scan`` (pairs combine, the half-length scan
    recurses, the even prefixes combine its results with the remaining
    elements), so every lane — pad lanes included, whose passthrough values
    depend on the evaluation order — equals that scan's.  The combine is
    ``kernels.ref.compose_lanes_torch``; a combined pair keeps the left key.
    """
    keys = torch.as_tensor(entry_keys).to(torch.int32)
    lanes = torch.as_tensor(lane_maps).to(torch.int32)
    axis = axis % keys.ndim
    cidx = torch.as_tensor(cand_index).to(lanes.device, torch.int32)
    sk = torch.as_tensor(sinks).to(lanes.device, torch.int32)

    def combine(al, ak, bl, bk):
        return compose_lanes_torch(al, bl, bk, cidx, sk,
                                   pad_key=pad_key), ak

    def scan(l, k):
        n = l.shape[0]
        if n < 2:
            return l, k
        rl, rk = combine(l[0:n - 1:2], k[0:n - 1:2], l[1::2], k[1::2])
        ol, ok = scan(rl, rk)
        if n % 2 == 0:
            el, ek = combine(ol[:-1], ok[:-1], l[2::2], k[2::2])
        else:
            el, ek = combine(ol, ok, l[2::2], k[2::2])
        el = torch.cat([l[:1], el])
        ek = torch.cat([k[:1], ek])
        return _interleave(el, ol), _interleave(ek, ok)

    out, _ = scan(lanes.movedim(axis, 0), keys.movedim(axis, 0))
    return out.movedim(0, axis)


def merge_compressed(
    lvecs: np.ndarray,        # [C, I_max] final state per candidate lane
    cand_index: np.ndarray,   # [n_classes, Q] inverse candidate map
    lookahead_cls: np.ndarray,  # [C] reverse-lookahead class per chunk (c>=1)
    start: int,
    sink: int,
) -> int:
    """Fold compressed per-chunk results from the known start state.

    Chunk 0's result lives in lane 0.  For chunk i>0 the carried state q is
    located inside the chunk's candidate list via cand_index; by construction
    (Eq. 11) q is always a candidate unless q is the sink, which is absorbing.
    """
    s = int(lvecs[0, 0]) if lvecs.shape[0] else int(start)
    for i in range(1, lvecs.shape[0]):
        if sink >= 0 and s == sink:
            return sink
        lane = int(cand_index[int(lookahead_cls[i]), s])
        if lane < 0:
            raise AssertionError(
                "carried state not in candidate set — lookahead tables are wrong")
        s = int(lvecs[i, lane])
    return s
