"""Rabin fingerprints over byte segments (after arXiv:1512.09228).

A segment's fingerprint is its byte string read as a base-256 polynomial
modulo the Mersenne prime 2^61 - 1:

    fp(b_0 .. b_{n-1}) = (sum_i b_i * 256^(n-1-i)) mod (2^61 - 1)

computed via CPython's bignum (``int.from_bytes`` + one ``%``), so hashing
is C-speed rather than a per-byte Python loop.  The payoff is the algebra:
fingerprints *compose* exactly like the transition maps they tag —

    fp(a || b) = (fp(a) * 256^len(b) + fp(b)) mod p

— so the out-of-order tier can (a) key every buffered segment map by
``(seq_no, fp, n_bytes)`` and drop duplicate deliveries from at-least-once
transports without re-matching or double-composing, and (b) maintain a
whole-stream fingerprint incrementally as gaps close, giving a cheap
equality witness that the bytes sequenced out of order are the bytes an
in-order reader would have seen (``OooStream.stream_fingerprint``).

Like any polynomial fingerprint, ``fp`` alone does not see leading zero
bytes (``fp(b"\\x00a") == fp(b"a")``); every comparison here therefore
pairs the fingerprint with the byte count, which restores uniqueness of
the pair up to hash collisions (~2^-61 per comparison, non-adversarial).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = ["FP_MOD", "segment_fingerprint", "compose_fingerprints",
           "FingerprintWindow"]

FP_MOD = (1 << 61) - 1  # Mersenne prime modulus


def segment_fingerprint(data: bytes | np.ndarray) -> int:
    """Rabin fingerprint of one segment (0 for the empty segment)."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        data = np.asarray(data, np.uint8).tobytes()
    return int.from_bytes(data, "big") % FP_MOD


def compose_fingerprints(fp_a: int, fp_b: int, len_b: int) -> int:
    """Fingerprint of the concatenation a || b from the parts.

    ``len_b`` is b's byte count (the shift amount); composition is
    associative with identity ``(0, 0)``, mirroring Eq. 9 map composition.
    """
    return (fp_a * pow(256, int(len_b), FP_MOD) + fp_b) % FP_MOD


class FingerprintWindow:
    """Bounded LRU map of ``(fingerprint, n_bytes, boundary_key)`` -> value.

    The cross-stream dedup window: many real feeds replay the *same content*
    on different streams (fan-out topics, mirrored shards, at-least-once
    transports re-partitioning), and a segment's candidate-keyed ``[K, S]``
    transition map depends only on its bytes and its entry boundary key —
    not on which stream carried it.  ``OooStreamMatcher`` therefore caches
    matched maps here (``OooPolicy.cross_stream_dedup_window`` entries) and
    reuses them across streams instead of re-matching, a *compute* dedup:
    every stream still folds its own copy of the bytes, so decisions stay
    bit-identical — only the device work disappears.

    The window pairs the fingerprint with the byte count (leading-zero
    blindness, see module docstring) and the boundary key (the map is keyed
    on its Eq. 11 entry).  It is deliberately **ephemeral**: checkpoints
    persist per-stream state only, and a restored matcher simply refills
    the window as traffic flows.
    """

    __slots__ = ("capacity", "_entries", "hits", "misses")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, fp: int, n_bytes: int, key: int):
        """The cached value, or None; a hit refreshes LRU recency."""
        k = (int(fp), int(n_bytes), int(key))
        val = self._entries.get(k)
        if val is None:
            self.misses += 1
            return None
        self._entries.move_to_end(k)
        self.hits += 1
        return val

    def put(self, fp: int, n_bytes: int, key: int, value) -> None:
        k = (int(fp), int(n_bytes), int(key))
        self._entries[k] = value
        self._entries.move_to_end(k)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
