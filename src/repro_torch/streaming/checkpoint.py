"""Streaming checkpoint identity.

Only the full-set signature is here so far: ``BlockedStreamMatcher`` stamps
it over every child ``StreamMatcher`` (``snapshot_signature``).  Session
snapshot/restore (``sessions_tree`` and the atomic-publish format) are
ROADMAP A8.
"""

from __future__ import annotations

import hashlib

__all__ = ["pattern_set_signature"]


def pattern_set_signature(pattern_set, prefilter=None) -> str:
    """Content hash of a full K-blocked pattern set (+ prefilter tables).

    A packed table's signature covers exactly one table; a blocked
    streaming runtime snapshots one tree per block, and each block's tree
    must refuse restore when *any* part of the set changed — a hot-swapped
    sibling block, a different blocking layout, or a changed required-
    literal table would all silently re-gate or re-interpret restored
    traffic.  ``prefilter`` is the ``core.prefilter.Prefilter`` in force, or
    None when gating is off.
    """
    h = hashlib.sha1()
    h.update(f"k_blk={pattern_set.k_blk};".encode())
    for sig in pattern_set.block_signatures:
        h.update(sig.encode())
    h.update(b"|pf:")
    if prefilter is not None:
        h.update(prefilter.signature().encode())
    return h.hexdigest()
