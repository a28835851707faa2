"""Structural-DFA lookahead analysis (paper Sec. 4.2/4.3).

``I_sigma`` (Eq. 11): states with an incoming transition labelled sigma,
excluding the sink q_e.  ``I_max = max_sigma |I_sigma|`` (Eq. 12).

For ``r`` reverse-lookahead symbols, ``I_{s1..sr}`` (Eq. 13) is the image of Q
under the suffix string.  The paper's Algorithm 4 enumerates all |Sigma|^r
suffixes — O(|Sigma|^r · |Q|).  We additionally implement an exact *deduped
image BFS* (beyond-paper): level k holds the set of **distinct** images
``delta*(Q, w), |w| = k``; distinct-image counts are typically tiny, so the
cost is O(levels · distinct_images · |Sigma| · |Q|) independent of |Sigma|^r.
Lemma 1 (monotone non-increase of I_max,r) is property-tested in tests/.

Runtime tables: ``candidates[sigma, I_max]`` padded candidate lists used by the
speculative matcher to decide which states to match per chunk, given the chunk's
reverse lookahead symbol.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .automata import DFA, PackedDFA

__all__ = ["LookaheadTables", "PackedLookaheadTables", "i_sigma_sets",
           "i_sigma2_sets", "i_max_r", "build_lookahead_tables",
           "build_packed_lookahead_tables"]


def i_sigma_sets(dfa: DFA) -> list[set[int]]:
    """Eq. 11 for every class sigma; the sink is excluded per the paper."""
    sets: list[set[int]] = []
    for c in range(dfa.n_classes):
        tgts = set(int(t) for t in dfa.table[:, c])
        tgts.discard(dfa.sink)
        sets.append(tgts)
    return sets


def _image(dfa: DFA, states: frozenset[int], cls: int) -> frozenset[int]:
    return frozenset(int(dfa.table[s, cls]) for s in states)


def i_max_r(dfa: DFA, r: int, *, method: str = "dedup",
            max_images: int = 100_000) -> list[int]:
    """Return [I_max,1 .. I_max,r].

    method="enum" is the paper's Algorithm 4 (exponential in r);
    method="dedup" is the exact distinct-image BFS (beyond-paper).
    Both exclude the sink from counts.
    """
    sink = dfa.sink

    def count(s: frozenset[int]) -> int:
        return len(s - {sink}) if sink >= 0 else len(s)

    if method == "enum":
        out: list[int] = []
        level: list[frozenset[int]] = [frozenset(range(dfa.n_states))]
        for _ in range(r):
            nxt: list[frozenset[int]] = []
            for s in level:
                for c in range(dfa.n_classes):
                    nxt.append(_image(dfa, s, c))
            out.append(max(1, max(count(s) for s in nxt)))
            level = nxt
        return out

    if method != "dedup":
        raise ValueError(f"unknown method {method!r}")
    # Bitmask images + exact subset pruning.  Applying delta_sigma to a set
    # never grows it, and images of subsets stay subsets, so only inclusion-
    # maximal image sets can realize the level maximum — pruning them is
    # EXACT, and collapses the level width from |Sigma|^r to typically a
    # handful of sets (the beyond-paper improvement over Algorithm 4).
    q = dfa.n_states
    sink_bit = (1 << dfa.sink) if dfa.sink >= 0 else 0

    def popcount_no_sink(mask: int) -> int:
        return (mask & ~sink_bit).bit_count()

    # per class: state -> target bit
    tgt_bits = [[1 << int(dfa.table[s, c]) for s in range(q)]
                for c in range(dfa.n_classes)]

    def image_mask(mask: int, c: int) -> int:
        out_m = 0
        bits = tgt_bits[c]
        m = mask
        while m:
            low = m & -m
            out_m |= bits[low.bit_length() - 1]
            m ^= low
        return out_m

    def prune_maximal(masks: set[int]) -> list[int]:
        ordered = sorted(masks, key=lambda m: -m.bit_count())
        kept: list[int] = []
        for m in ordered:
            if not any(m & ~k == 0 for k in kept):
                kept.append(m)
            if len(kept) >= max_images:
                break
        return kept

    out = []
    level = [(1 << q) - 1]
    for _ in range(r):
        nxt = {image_mask(m, c) for m in level for c in range(dfa.n_classes)}
        level = prune_maximal(nxt)
        # clamp to 1: a chunk always matches at least one state, even for
        # degenerate DFAs whose every symbol leads to the sink
        out.append(max(1, max(popcount_no_sink(m) for m in level)))
    return out


@dataclasses.dataclass
class LookaheadTables:
    """Device-ready candidate tables for the speculative matcher (r = 1).

    candidates[c, j]  : j-th candidate initial state for lookahead class c,
                        padded with the sink (or state 0 if no sink) to I_max.
    cand_count[c]     : |I_c|.
    i_max             : max_c |I_c|  (the paper's I_max).
    cand_index[c, q]  : inverse map — position of state q in candidates[c],
                        or -1 if q not in I_c.  Used by the merge step to look
                        up the propagated state inside a chunk's L-vector.
    """

    candidates: np.ndarray  # [n_classes, i_max] int32
    cand_count: np.ndarray  # [n_classes] int32
    cand_index: np.ndarray  # [n_classes, Q] int32
    i_max: int
    gamma: float  # I_max / |Q|, the paper's structural property


def i_sigma2_sets(dfa: DFA) -> list[set[int]]:
    """Eq. 13 for every 2-symbol suffix (paper Algorithm 4, r = 2).

    Index layout: suffix (c1, c2) -> c1 * n_classes + c2, where c2 is the
    chunk's last symbol (matched second).
    """
    n = dfa.n_classes
    sets: list[set[int]] = [set() for _ in range(n * n)]
    tbl = dfa.table
    for c1 in range(n):
        mid = np.unique(tbl[:, c1])
        for c2 in range(n):
            tg = set(int(t) for t in tbl[mid, c2])
            tg.discard(dfa.sink)
            sets[c1 * n + c2] = tg
    return sets


@dataclasses.dataclass
class PackedLookaheadTables:
    """Eq. 11/13 candidate tables for a ``PackedDFA``, keyed by boundary keys.

    A *boundary key* generalizes the paper's reverse-lookahead class to
    ``r`` symbols of suffix context: for ``r = 1`` the key is the joint class
    of the boundary byte itself (Eq. 11, ``n_keys == n_classes``); for
    ``r = 2`` it is the pair index ``c_prev * n_classes + c_last`` (Eq. 13,
    ``n_keys == n_classes ** 2``) whose feasible image is typically far
    smaller, shrinking the shared lane width ``i_max`` — the dominant
    ``[B, K, S]`` streaming cost (PaREM, arXiv:1412.1741).

    The candidate axis is per *pattern*: lanes in the batched matcher are laid
    out ``[K, i_max]`` per chunk, and ``cand_index`` maps a packed state id to
    its lane inside its own pattern's candidate row (-1 if not a candidate —
    notably each pattern's sink).

    candidates[key, k, j] : j-th candidate packed state of pattern k for
                            boundary key ``key``, padded with pattern k's sink
                            (or its start if it has no dead state).
    cand_count[key, k]    : |I_key^k|.
    cand_index[key, q]    : lane of packed state q in its pattern's row, or -1.
    i_max                 : max_{key,k} |I_key^k| — the shared lane width.
    gamma                 : worst per-pattern I_max / (|Q_k| - has_sink).
    r                     : reverse-lookahead depth of the key space (1 or 2).
    n_keys                : boundary-key count (``n_classes ** r``); the pad
                            key (identity merge) is ``n_keys`` itself.
    """

    candidates: np.ndarray  # [n_keys, K, i_max] int32
    cand_count: np.ndarray  # [n_keys, K] int32
    cand_index: np.ndarray  # [n_keys, Q_total] int32
    i_max: int
    gamma: float
    r: int = 1
    n_keys: int = 0  # derived from candidates when left at 0

    def __post_init__(self):
        if self.n_keys == 0:
            self.n_keys = int(self.candidates.shape[0])


def _packed_candidate_sets(packed: PackedDFA, r: int) -> list[list[list[int]]]:
    """[n_keys][K] sorted candidate state lists for boundary keys of depth r.

    r=1: ``I_c^k`` = targets of pattern k's states under class c (Eq. 11).
    r=2: ``I_{c1,c2}^k`` = the image of pattern k's states under the suffix
    string (c1, c2) — mirror of ``i_sigma2_sets`` per pattern slice (Eq. 13).
    Sinks are excluded per the paper.
    """
    n_cls, k_pat = packed.n_classes, packed.n_patterns
    slices = [packed.pattern_slice(k) for k in range(k_pat)]
    sets: list[list[list[int]]] = []
    if r == 1:
        for c in range(n_cls):
            per_key = []
            for k in range(k_pat):
                tgts = set(int(t) for t in packed.table[slices[k], c])
                tgts.discard(int(packed.sinks[k]))
                per_key.append(sorted(tgts))
            sets.append(per_key)
        return sets
    # r == 2: key layout c1 * n_classes + c2 (c2 is the boundary byte itself,
    # matched second) — packed transitions never leave a pattern's slice, so
    # the one-step image ``mid`` stays per-pattern
    mids = [[np.unique(packed.table[slices[k], c1]) for k in range(k_pat)]
            for c1 in range(n_cls)]
    for c1 in range(n_cls):
        for c2 in range(n_cls):
            per_key = []
            for k in range(k_pat):
                tgts = set(int(t) for t in packed.table[mids[c1][k], c2])
                tgts.discard(int(packed.sinks[k]))
                per_key.append(sorted(tgts))
            sets.append(per_key)
    return sets


def build_packed_lookahead_tables(packed: PackedDFA,
                                  r: int = 1) -> PackedLookaheadTables:
    if r not in (1, 2):
        raise ValueError("packed runtime lookahead supports r in (1, 2); "
                         "use i_max_r for analysis at larger r")
    n_cls, k_pat, q_tot = packed.n_classes, packed.n_patterns, packed.n_states
    n_keys = n_cls ** r
    sets = _packed_candidate_sets(packed, r)
    i_max = max(1, max((len(s) for per in sets for s in per), default=1))
    pad = np.array([packed.sinks[k] if packed.sinks[k] >= 0 else packed.starts[k]
                    for k in range(k_pat)], np.int32)
    candidates = np.broadcast_to(pad[None, :, None],
                                 (n_keys, k_pat, i_max)).copy()
    cand_count = np.zeros((n_keys, k_pat), np.int32)
    cand_index = np.full((n_keys, q_tot), -1, np.int32)
    for key in range(n_keys):
        for k in range(k_pat):
            ordered = sets[key][k]
            cand_count[key, k] = len(ordered)
            for j, st in enumerate(ordered):
                candidates[key, k, j] = st
                cand_index[key, st] = j
    gamma = 0.0
    for k in range(k_pat):
        q_k = int(packed.offsets[k + 1] - packed.offsets[k])
        live = max(q_k - (1 if packed.sinks[k] >= 0 else 0), 1)
        k_imax = max(1, int(cand_count[:, k].max(initial=0)))
        gamma = max(gamma, min(float(k_imax) / float(live), 1.0))
    return PackedLookaheadTables(candidates=candidates, cand_count=cand_count,
                                 cand_index=cand_index, i_max=i_max,
                                 gamma=gamma, r=r, n_keys=n_keys)


def build_lookahead_tables(dfa: DFA, *, r: int = 1) -> LookaheadTables:
    if r == 2:
        sets = i_sigma2_sets(dfa)
    elif r == 1:
        sets = i_sigma_sets(dfa)
    else:
        raise ValueError("runtime lookahead supports r in (1, 2); use "
                         "i_max_r for analysis at larger r")
    i_max = max((len(s) for s in sets), default=1)
    i_max = max(i_max, 1)
    n_rows, q = len(sets), dfa.n_states
    pad_state = dfa.sink if dfa.sink >= 0 else 0
    candidates = np.full((n_rows, i_max), pad_state, dtype=np.int32)
    cand_count = np.zeros(n_rows, dtype=np.int32)
    cand_index = np.full((n_rows, q), -1, dtype=np.int32)
    for c, s in enumerate(sets):
        ordered = sorted(s)
        cand_count[c] = len(ordered)
        for j, st in enumerate(ordered):
            candidates[c, j] = st
            cand_index[c, st] = j
    # count the real number of matched states; gamma per Eq. (18)
    gamma = float(i_max) / float(max(q - (1 if dfa.sink >= 0 else 0), 1))
    return LookaheadTables(candidates=candidates, cand_count=cand_count,
                           cand_index=cand_index, i_max=i_max, gamma=min(gamma, 1.0))
