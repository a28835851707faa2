"""Required-literal prefilter: per-document per-block "can-match" gating.

The port's copy of the JAX package's numpy module: the gate runs on the
host, before any device dispatch.

Thousands of patterns cannot all pay full-DFA cost on every document
(arXiv:1110.1716's insomnia argument).  The cheap gate used by production
engines (RE2 prefilters, Hyperscan literal factoring, cf. arXiv:1512.09228)
is a *required literal*: a byte string every match of a pattern must contain.
If a document does not contain the literal, the pattern's verdict is False
with no automaton run at all; if no pattern of a K-block survives the gate,
the whole block's dispatch is skipped.

The literal scan rides the streaming tier's Rabin-fingerprint algebra
(``streaming.ooo.fingerprint``): every length-L window of a document is
fingerprinted in one vectorized Horner pass mod the Mersenne prime 2^61-1
(the multiply-by-256 step splits into a shift/add pair so uint64 never
overflows), and window fingerprints are matched against the literal
fingerprints with a sorted lookup.  Collisions are one-sided: a colliding
window can only make a gated block *run* (sound false "may-match"), never
suppress a true match.

Extraction (``required_literal``) walks the parsed AST for mandatory
contiguous factors: single-byte literals chain into runs across ``Concat``,
exactly-repeated exact factors expand, alternations and optional parts
contribute nothing.  Patterns with no extractable literal leave their block
ungated — the gate is an optimization, never a semantics change.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np

from .regex import Alt, Concat, Lit, Node, Repeat, parse_regex

__all__ = ["required_literal", "window_fingerprints", "literal_fingerprint",
           "Prefilter"]

# Same modulus as streaming.ooo.fingerprint.FP_MOD (imported lazily below to
# keep core free of a load-time dependency on the streaming package).
_M61 = np.uint64((1 << 61) - 1)
_LO53 = np.uint64((1 << 53) - 1)


# -- required-literal extraction ---------------------------------------------

def _exact_run(node: Node) -> Optional[bytes]:
    """The exact byte string ``node`` always matches, or None.

    Only nodes whose every match is one fixed string qualify — these join
    contiguously with neighbouring exact parts inside a ``Concat``.
    """
    if isinstance(node, Lit):
        if len(node.byteset) == 1:
            return bytes([next(iter(node.byteset))])
        return None
    if isinstance(node, Repeat):
        if node.hi is not None and node.hi == node.lo:
            b = _exact_run(node.child)
            return b * node.lo if b is not None else None
        return None
    if isinstance(node, Concat):
        parts = [_exact_run(p) for p in node.parts]
        if all(p is not None for p in parts):
            return b"".join(parts)  # type: ignore[arg-type]
        return None
    if isinstance(node, Alt) and len(node.options) == 1:
        return _exact_run(node.options[0])
    return None


def _factors(node: Node) -> list[bytes]:
    """Byte strings guaranteed to appear contiguously in every match."""
    if isinstance(node, Lit):
        b = _exact_run(node)
        return [b] if b else []
    if isinstance(node, Alt):
        # a factor common to every branch would be sound; we keep the gate
        # simple and let alternations contribute nothing
        return []
    if isinstance(node, Repeat):
        if node.lo < 1:
            return []
        b = _exact_run(node.child)
        if b:
            # every match is >= lo contiguous copies of the exact child
            return [b * node.lo]
        return _factors(node.child)
    if isinstance(node, Concat):
        out: list[bytes] = []
        run = bytearray()
        for part in node.parts:
            b = _exact_run(part)
            if b is not None:
                run += b
                continue
            if run:
                out.append(bytes(run))
                run = bytearray()
            out.extend(_factors(part))
        if run:
            out.append(bytes(run))
        return out
    return []


def required_literal(pattern: str) -> Optional[bytes]:
    """Longest byte string every match of ``pattern`` must contain.

    Returns None when the pattern has no mandatory literal (or does not
    parse) — such patterns leave their block ungated.  Search wrappers
    (``.*(pat)``) factor identically to the bare pattern: the ``.*`` prefix
    is an optional repeat and contributes nothing.
    """
    try:
        ast = parse_regex(pattern)
    except Exception:
        return None
    factors = _factors(ast)
    if not factors:
        return None
    return max(factors, key=len)


# -- vectorized Rabin window scan --------------------------------------------

def _mul256_mod(h: np.ndarray) -> np.ndarray:
    # h < 2^61: h*256 mod (2^61-1) == (h>>53) + ((h & (2^53-1)) << 8), folded
    # once — both terms fit uint64 and their sum is < 2^61 + 256.
    v = (h >> np.uint64(53)) + ((h & _LO53) << np.uint64(8))
    return np.where(v >= _M61, v - _M61, v)


def _add_mod(h: np.ndarray, b: np.ndarray) -> np.ndarray:
    v = h + b  # < 2^61 + 255, no uint64 overflow
    return np.where(v >= _M61, v - _M61, v)


def window_fingerprints(data: np.ndarray, length: int) -> np.ndarray:
    """Rabin fingerprints of every ``length``-byte window of ``data``.

    Bit-identical to ``streaming.ooo.fingerprint.segment_fingerprint`` of
    each window (big-endian Horner mod 2^61-1), but computed for all
    ``n - length + 1`` windows in ``length`` vectorized passes.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    if length <= 0 or n < length:
        return np.zeros(0, dtype=np.uint64)
    h = np.zeros(n - length + 1, dtype=np.uint64)
    for j in range(length):
        h = _mul256_mod(h)
        h = _add_mod(h, data[j:n - length + 1 + j].astype(np.uint64))
    return h


def literal_fingerprint(literal: bytes) -> int:
    """Fingerprint of a literal, via the streaming tier's scalar reference."""
    from ..streaming.ooo.fingerprint import segment_fingerprint
    return segment_fingerprint(literal)


# -- the per-block gate ------------------------------------------------------

class Prefilter:
    """Vectorized per-document per-block "can-possibly-match" gate.

    ``block_literals[b][i]`` is pattern i-of-block-b's required literal (or
    None).  A block is *gated* iff every one of its patterns has a literal;
    a document can possibly match a gated block only if it contains at least
    one of the block's literals.  Ungated blocks always report True.
    """

    def __init__(self, block_literals: Sequence[Sequence[Optional[bytes]]]):
        self.block_literals = tuple(tuple(ls) for ls in block_literals)
        self.n_blocks = len(self.block_literals)
        self.gated = np.array(
            [len(ls) > 0 and all(l is not None for l in ls)
             for ls in self.block_literals], dtype=bool)
        # Distinct literals of the gated blocks, grouped by length for the
        # window scan; each gated block keeps the flat indices of its own.
        lit_index: dict[bytes, int] = {}
        self._block_lit_idx: list[np.ndarray] = []
        for b, ls in enumerate(self.block_literals):
            if not self.gated[b]:
                self._block_lit_idx.append(np.zeros(0, dtype=np.int64))
                continue
            idx = [lit_index.setdefault(l, len(lit_index)) for l in ls]
            self._block_lit_idx.append(np.unique(np.array(idx, np.int64)))
        self.literals = tuple(sorted(lit_index, key=lit_index.get))
        self.n_literals = len(self.literals)
        # by length: (L, sorted unique fps, per-literal map into the uniques)
        self._by_len: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        by_len: dict[int, list[int]] = {}
        for i, lit in enumerate(self.literals):
            by_len.setdefault(len(lit), []).append(i)
        for L, ids in sorted(by_len.items()):
            fps = np.array([literal_fingerprint(self.literals[i])
                            for i in ids], dtype=np.uint64)
            uniq, inv = np.unique(fps, return_inverse=True)
            self._by_len.append((L, uniq, inv, np.array(ids, np.int64)))
        self.min_len = min(by_len) if by_len else 0

    @classmethod
    def from_pattern_set(cls, pattern_set) -> "Prefilter":
        """Build from a ``core.patterns.PatternSet`` (duck-typed: needs
        ``n_blocks`` and ``block_regexes``; DFA-sourced patterns have no
        regex and leave their block ungated)."""
        return cls([
            [required_literal(r) if r is not None else None
             for r in pattern_set.block_regexes(b)]
            for b in range(pattern_set.n_blocks)])

    def _present_literals(self, arr: np.ndarray) -> np.ndarray:
        """[n_literals] bool: which literals (by fingerprint) ``arr`` contains."""
        present = np.zeros(self.n_literals, dtype=bool)
        for L, uniq, inv, ids in self._by_len:
            wf = window_fingerprints(arr, L)
            if wf.size == 0:
                continue
            pos = np.searchsorted(uniq, wf)
            pos_c = np.minimum(pos, uniq.size - 1)
            hit_uniq = np.zeros(uniq.size, dtype=bool)
            hit_uniq[pos_c[uniq[pos_c] == wf]] = True
            present[ids] = hit_uniq[inv]
        return present

    def can_match(self, arrs: Sequence[np.ndarray],
                  lengths: np.ndarray | None = None) -> np.ndarray:
        """[B, n_blocks] bool: False only when *no* pattern of the block can
        possibly match the document (all required literals absent)."""
        b = len(arrs)
        can = np.ones((b, self.n_blocks), dtype=bool)
        if not self.gated.any():
            return can
        gated_ids = np.flatnonzero(self.gated)
        for di, arr in enumerate(arrs):
            present = self._present_literals(np.asarray(arr, dtype=np.uint8))
            for bi in gated_ids:
                idx = self._block_lit_idx[bi]
                can[di, bi] = bool(present[idx].any())
        return can

    def signature(self) -> str:
        """Content hash of the gate tables (part of the checkpoint
        pattern-set signature: a changed literal table silently re-gates
        restored traffic, so restores must refuse it)."""
        h = hashlib.sha1()
        for ls in self.block_literals:
            h.update(b"[")
            for l in ls:
                if l is None:
                    h.update(b"~;")
                else:
                    h.update(str(len(l)).encode() + b":" + l + b";")
            h.update(b"]")
        return h.hexdigest()

    def __repr__(self) -> str:
        return (f"Prefilter(n_blocks={self.n_blocks}, "
                f"gated={int(self.gated.sum())}, "
                f"n_literals={self.n_literals})")
