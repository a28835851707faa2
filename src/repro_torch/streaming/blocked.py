"""K-blocked streaming: per-block ``StreamMatcher``s behind one session.

The batched side of the pattern-set scale tier fans documents over
``core.engine.BlockedMatcher``'s per-block matchers; this module is the
streaming side.  A ``BlockedStreamMatcher`` keeps one child ``StreamMatcher``
per block — sharing the blocked matcher's buckets and one
``TickPolicy`` — and a ``BlockedStreamSession`` holds the aligned per-block
child sessions, so ``open`` / ``feed`` / ``flush`` / ``close`` look exactly
like the single-table runtime while each block's cursors stay local to its
own table (packed state ids are block-local; ``close`` re-offsets finals by
the set's ``state_bases`` into the global [K] result).

Hot swaps are where blocking earns its keep mid-stream: ``swap_patterns``
leaves unchanged blocks' children — lowerings *and* live cursors —
completely untouched (their streams keep their full byte history,
bit-identically), while changed blocks re-open their sessions' cursors at
the new starts (the ``StreamMatcher.swap_patterns`` carry rules, applied per
block).

Snapshots write one tree per block (``block_<bbb>/``) with the full-set
``pattern_set_signature`` stamped over every tree, so a restore is refused
when *any* part of the set changed — a swapped sibling block or a different
prefilter table, not merely the restored block's own content.  The layout
is the JAX package's: a snapshot moves between the two packages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import numpy as np

from ..core.engine.blocked import BlockedMatcher
from ..core.patterns import PatternSet
from . import StreamMatcher
from .checkpoint import pattern_set_signature
from .cursor import open_cursor
from .scheduler import SchedulerStats, TickPolicy
from .session import StreamResult, StreamSession

__all__ = ["BlockedStreamMatcher", "BlockedStreamSession"]


class BlockedStreamSession:
    """Handle over one logical stream's aligned per-block child sessions."""

    __slots__ = ("sid", "owner", "parts", "closed", "segments_fed")

    def __init__(self, sid: int, owner, parts: list[StreamSession]):
        self.sid = sid
        self.owner = owner
        self.parts = parts
        self.closed = False
        self.segments_fed = 0

    @property
    def pending_bytes(self) -> int:
        return max(p.pending_bytes for p in self.parts)

    @property
    def byte_count(self) -> int:
        """Bytes absorbed into the cursors (excludes unflushed pending)."""
        return max(p.byte_count for p in self.parts)

    def feed(self, data: bytes | np.ndarray, *, flush: bool = False) -> None:
        self.owner.feed(self, data, flush=flush)

    def close(self) -> StreamResult:
        return self.owner.close(self)


class BlockedStreamMatcher:
    """Streaming front end over a multi-block pattern set.

    ``source`` is a ``BlockedMatcher`` (sharing its buckets and lowerings),
    a ``PatternSet``, or anything ``PatternSet`` accepts (then ``k_blk`` /
    ``search`` / ``prefilter`` and the remaining ``Matcher`` kwargs apply:
    ``backend``, ``device``, ``num_chunks``, the sharded backend's mesh
    keywords, ...).  The same bit-identity contract
    as ``StreamMatcher`` holds per block: a closed stream's [K] verdict
    equals ``BlockedMatcher.membership_batch`` on the concatenated bytes.

    The streaming path runs every block on every fed byte — the prefilter
    gate needs whole documents and so applies to batch scans, not to
    incremental feeds (a stream's bytes are not known until close).
    """

    def __init__(self, source: Union[BlockedMatcher, PatternSet, Sequence,
                                     dict], *,
                 policy: Optional[TickPolicy] = None,
                 k_blk: Optional[int] = None, search: bool = True,
                 prefilter: bool = True, **matcher_kwargs):
        if isinstance(source, BlockedMatcher):
            if matcher_kwargs or k_blk is not None:
                raise ValueError("matcher kwargs conflict with a pre-built "
                                 "BlockedMatcher")
            self.blocked = source
        else:
            self.blocked = BlockedMatcher(source, k_blk=k_blk, search=search,
                                          prefilter=prefilter,
                                          **matcher_kwargs)
        self._policy = policy
        self._sms: list[StreamMatcher] = [
            StreamMatcher(m, policy=policy) for m in self.blocked.matchers]
        self._stamp_signature()
        self._sessions: dict[int, BlockedStreamSession] = {}
        self._next_sid = 0
        self._snapshot_step = 0

    def _stamp_signature(self) -> None:
        sig = pattern_set_signature(self.blocked.pattern_set,
                                    self.blocked.prefilter)
        for sm in self._sms:
            sm.snapshot_signature = sig

    # -- shape ---------------------------------------------------------------

    @property
    def pattern_set(self) -> PatternSet:
        return self.blocked.pattern_set

    @property
    def n_patterns(self) -> int:
        return self.blocked.n_patterns

    @property
    def n_blocks(self) -> int:
        return self.blocked.n_blocks

    # -- session lifecycle ---------------------------------------------------

    def open(self) -> BlockedStreamSession:
        """Open one logical stream: aligned child sessions on every block."""
        parts = [sm.open() for sm in self._sms]
        sid = self._next_sid
        self._next_sid += 1
        sess = BlockedStreamSession(sid, self, parts)
        self._sessions[sid] = sess
        return sess

    def feed(self, session: BlockedStreamSession, data: bytes | np.ndarray,
             *, flush: bool = False) -> None:
        """Admit the stream's next segment to every block's child."""
        if session.closed:
            raise ValueError("stream session is closed")
        if session.owner is not self:
            raise ValueError("session belongs to a different matcher")
        session.segments_fed += 1
        for sm, part in zip(self._sms, session.parts):
            sm.feed(part, data)
        if flush:
            self.flush()

    def flush(self) -> int:
        """Tick every block; returns the max streams advanced in any block."""
        return max((sm.flush() for sm in self._sms), default=0)

    def close(self, session: BlockedStreamSession) -> StreamResult:
        """Flush and fan every block's [k_blk] verdict into one [K] result."""
        if session.closed:
            raise ValueError("stream session is already closed")
        if session.owner is not self:
            raise ValueError("session belongs to a different matcher")
        ps = self.pattern_set
        results = [sm.close(part)
                   for sm, part in zip(self._sms, session.parts)]
        session.closed = True
        self._sessions.pop(session.sid, None)
        accepted = np.concatenate([r.accepted for r in results])
        finals = np.concatenate(
            [r.final_states + int(ps.state_bases[bi])
             for bi, r in enumerate(results)]).astype(np.int32)
        return StreamResult(accepted=accepted, final_states=finals,
                            byte_count=max(r.byte_count for r in results),
                            segments_fed=session.segments_fed)

    # -- hot pattern swap ----------------------------------------------------

    def swap_patterns(self, source, *, k_blk: Optional[int] = None,
                      search: Optional[bool] = None) -> dict:
        """Swap the set at a tick boundary; unchanged blocks carry cursors.

        Pending bytes flush through the old tables first.  Then
        ``BlockedMatcher.swap_patterns`` rebuilds only changed blocks, and
        per block:

        * **unchanged** — the child ``StreamMatcher`` (lowerings *and*
          every live cursor) is untouched: its streams keep their
          full byte history bit-identically across the swap;
        * **changed in place** — the child's open cursors re-open at the
          new starts (``StreamMatcher`` carry rules: swapped patterns see
          only post-swap bytes, byte counts persist, eviction resets);
        * **added** — a fresh child with sessions aligned to every open
          stream;
        * **dropped** — trailing children discarded with their cursors.

        Returns the ``BlockedMatcher`` report dict.
        """
        if any(sm.scheduler.pending_streams for sm in self._sms):
            self.flush()
        info = self.blocked.swap_patterns(source, k_blk=k_blk, search=search)
        for bi in info["rebuilt"]:
            if bi < len(self._sms):
                self._sms[bi]._reset_open_cursors()
            else:
                self._sms.append(self._adopt_block(bi))
        if info["dropped"]:
            del self._sms[len(self.blocked.matchers):]
        for sess in self._sessions.values():
            del sess.parts[len(self.blocked.matchers):]
        self._stamp_signature()
        return info

    def _adopt_block(self, bi: int) -> StreamMatcher:
        """Child for a block added by a swap: every open stream gets an
        aligned session whose cursor starts at the new block's starts (the
        block has seen none of the stream's earlier bytes — same rule as a
        changed block) with the stream's byte count carried."""
        sm = StreamMatcher(self.blocked.matchers[bi], policy=self._policy)
        sm._next_sid = self._next_sid
        for sid in sorted(self._sessions):
            sess = self._sessions[sid]
            part = StreamSession(sid, sm, dataclasses.replace(
                open_cursor(sm.matcher.dev),
                byte_count=sess.parts[0].cursor.byte_count))
            part.segments_fed = sess.parts[0].segments_fed
            sm._sessions[sid] = part
            sess.parts.append(part)
        return sm

    # -- failover ------------------------------------------------------------

    def snapshot(self, directory: str, *, step: Optional[int] = None) -> str:
        """Publish one tree per block under ``directory/block_<b>/``.

        Every tree carries the full-set ``pattern_set_signature`` (blocking
        layout + every block's tables + prefilter literals), so restore
        refuses the whole snapshot when any part of the set changed.
        """
        if step is None:
            step = self._snapshot_step
        self._snapshot_step = step + 1
        for bi, sm in enumerate(self._sms):
            sm.snapshot(os.path.join(directory, f"block_{bi:03d}"), step=step)
        return directory

    def restore(self, directory: str, *, step: Optional[int] = None
                ) -> list[BlockedStreamSession]:
        """Rebuild logical sessions from a per-block snapshot.

        Each block's tree re-verifies the full-set signature; a stream must
        restore on every block (a snapshot with mismatched session sets
        across blocks is refused as corrupt).
        """
        per_block = [sm.restore(os.path.join(directory, f"block_{bi:03d}"),
                                step=step)
                     for bi, sm in enumerate(self._sms)]
        by_sid: dict[int, list[Optional[StreamSession]]] = {}
        for bi, parts in enumerate(per_block):
            for p in parts:
                by_sid.setdefault(p.sid, [None] * self.n_blocks)[bi] = p
        restored = []
        for sid in sorted(by_sid):
            parts = by_sid[sid]
            if any(p is None for p in parts):
                missing = [bi for bi, p in enumerate(parts) if p is None]
                raise ValueError(
                    f"snapshot is inconsistent: stream {sid} is missing from "
                    f"block(s) {missing}")
            sess = BlockedStreamSession(sid, self, parts)  # type: ignore[arg-type]
            sess.segments_fed = parts[0].segments_fed
            self._sessions[sid] = sess
            restored.append(sess)
        self._next_sid = max(self._next_sid,
                             max(by_sid, default=-1) + 1)
        self._snapshot_step = max(self._snapshot_step,
                                  (step if step is not None
                                   else self._snapshot_step))
        return restored

    # -- introspection -------------------------------------------------------

    @property
    def stats(self) -> SchedulerStats:
        """Summed scheduler stats across all blocks' children."""
        agg = SchedulerStats()
        for sm in self._sms:
            st = sm.stats
            for f in dataclasses.fields(SchedulerStats):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(st, f.name))
        return agg

    @property
    def block_stats(self) -> list[SchedulerStats]:
        return [sm.stats for sm in self._sms]

    def perf_report(self) -> dict:
        return self.blocked.perf_report()
