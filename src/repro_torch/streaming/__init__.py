"""Streaming match runtime of the port: resumable cursors, micro-batched
scheduling and the out-of-order ingestion tier.

    cursor.py     ``MatchCursor`` / ``segment_result`` / ``merge`` — the pure
                  Eq. 8 composition that makes matching resumable, bit-
                  identical to one-shot matching under any segmentation.
                  ``merge`` is the host reference of the device merge
                  (``Matcher.advance_cursors``); ``merge_calls`` counts host
                  merges, and the streaming data paths leave it flat.
    scheduler.py  ``MicroBatchScheduler`` + ``TickPolicy`` — an admission
                  queue that coalesces pending segments from many streams
                  and dispatches one round per tick through
                  ``Matcher.advance_segments`` / ``advance_cursors``, under
                  retry-with-restore (``RetryPolicy``).
    session.py    ``StreamResult`` (a closed stream's decision) and
                  ``StreamSession``.
    faults.py     ``FaultPlan`` — deterministic fault injection for the
                  scheduler's recovery paths.
    checkpoint.py session snapshot/restore on ``training/checkpoint.py``'s
                  atomic-publish format: because a cursor's [K, S] lane
                  state is a complete composable summary (Eq. 8), a stream
                  frozen here resumes anywhere — on the other backend, on
                  the CPU, or in the JAX package — bit-identically
                  (``StreamMatcher.snapshot`` / ``restore``).
    blocked.py    ``BlockedStreamMatcher``: one child ``StreamMatcher`` per
                  block of a ``PatternSet`` behind one session handle, hot-
                  swapped block by block.
    ooo/          ``OooStreamMatcher``: segments arrive in any order, are
                  matched first as candidate-keyed maps and folded into the
                  exact cursor when gaps close (``Matcher.compose_lane_maps``);
                  its snapshots also keep the parked segments.

``StreamMatcher`` below is the in-order facade:

    sm = StreamMatcher([compile_regex(r".*SECRET-[0-9]+")], device="cpu")
    s = sm.open()
    s.feed(chunk)            # admits; the scheduler decides when to dispatch
    res = s.close()          # flushes; [K] accept flags + final states

    sm.snapshot(directory)   # failover point: every open stream, atomically
    StreamMatcher(...).restore(directory)   # resumes them, bit-identically
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.engine.facade import Matcher
from .checkpoint import (load_sessions_tree, pattern_set_signature,
                         save_sessions_tree, sessions_tree, table_signature,
                         unpack_cursor)
from .cursor import (ENTRY_EXACT, MatchCursor, SegmentResult, counting_merges,
                     merge, merge_calls, open_cursor, open_lane_cursor,
                     reset_merge_calls, segment_result)
from .faults import FaultPlan, InjectedFault
from .ooo import (OooIntegrityError, OooPolicy, OooStats, OooStream,
                  OooStreamMatcher, ReorderBufferFull, SequenceGapError,
                  segment_fingerprint)
from .scheduler import (MicroBatchScheduler, RetryPolicy, SchedulerStats,
                        TickPolicy)
from .session import StreamResult, StreamSession

__all__ = ["StreamMatcher", "StreamSession", "StreamResult", "TickPolicy",
           "RetryPolicy", "SchedulerStats", "MicroBatchScheduler",
           "MatchCursor", "SegmentResult", "ENTRY_EXACT", "open_cursor",
           "open_lane_cursor", "segment_result", "merge", "merge_calls",
           "reset_merge_calls", "counting_merges", "FaultPlan",
           "InjectedFault", "table_signature", "pattern_set_signature",
           "sessions_tree", "save_sessions_tree", "load_sessions_tree",
           "unpack_cursor",
           "BlockedStreamMatcher", "BlockedStreamSession",
           "OooStreamMatcher", "OooStream", "OooStats", "OooPolicy",
           "ReorderBufferFull", "SequenceGapError", "OooIntegrityError",
           "segment_fingerprint"]


class StreamMatcher:
    """Resumable, continuously micro-batched matching over byte streams.

    ``source`` is anything ``core.engine.Matcher`` accepts (a DFA, a
    ``PackedDFA``, a sequence of DFAs) — or an existing ``Matcher``, whose
    buckets, backend and device are then shared with whole-document
    matching.

    **Bit-identity guarantee**: a closed stream's [K] ``accepted`` /
    ``final_states`` equal ``Matcher.membership_batch`` on the stream's
    concatenated bytes, regardless of how the bytes were split across
    ``feed`` calls — on either backend ("cuda" / "local").

    ``policy`` sets the tick policy (default: eager flush; see
    ``TickPolicy`` — ``max_batch`` pending streams, ``max_delay`` feed
    events, or a ``max_delay_s`` wall-clock deadline).  Remaining keyword
    arguments (``backend=``, ``num_chunks=``, ``batch_tile=``, ``device=``,
    ...) construct the underlying ``Matcher`` (on the card unless
    ``device`` says otherwise).  When the matcher is built here,
    ``num_chunks`` defaults to 1 (batched sequential scan, the seq
    lowering): with many concurrent streams the *row* axis already
    saturates the device, and per-segment chunk speculation would add
    C x S redundant lanes per stream.  Pass ``num_chunks>1`` (or a
    pre-built ``Matcher``) for few heavy streams, where in-segment
    speculation is the only parallelism.
    """

    def __init__(self, source, *, policy: TickPolicy | None = None,
                 clock=None, retry: RetryPolicy | None = None,
                 straggler=None, fault_plan: FaultPlan | None = None,
                 lane_ticks: bool = False, **matcher_kwargs):
        if isinstance(source, Matcher):
            if matcher_kwargs:
                raise ValueError("matcher kwargs conflict with a pre-built "
                                 f"Matcher: {sorted(matcher_kwargs)}")
            self.matcher = source
        else:
            matcher_kwargs.setdefault("num_chunks", 1)
            self.matcher = Matcher(source, **matcher_kwargs)
        # clock (default time.monotonic) feeds the max_delay_s deadline;
        # simulated event loops and tests inject their own.  retry /
        # straggler / fault_plan configure the scheduler's fault-tolerance
        # layer (see scheduler.py docstring).
        sched_kwargs = dict(retry=retry, straggler=straggler,
                            fault_plan=fault_plan, lane_ticks=lane_ticks)
        if clock is not None:
            sched_kwargs["clock"] = clock
        self.scheduler = MicroBatchScheduler(self.matcher, policy,
                                             **sched_kwargs)
        self._next_sid = 0
        self._sessions: dict[int, StreamSession] = {}
        self._snapshot_step = 0
        # snapshot identity override: a BlockedStreamMatcher stamps the
        # full-set pattern_set_signature here so each per-block snapshot
        # refuses restore when *any* sibling block (or the prefilter)
        # changed, not merely this block's own table
        self.snapshot_signature: str | None = None

    # -- session lifecycle ---------------------------------------------------

    def open(self) -> StreamSession:
        """Open a stream at byte position 0 (exact cursor at the starts)."""
        sid = self._next_sid
        self._next_sid += 1
        session = StreamSession(sid, self, open_cursor(self.matcher.dev))
        self._sessions[sid] = session
        return session

    def open_at(self, entry_class: int) -> StreamSession:
        """Open a candidate-keyed stream *mid-flight*: its bytes start at an
        unknown position whose preceding boundary key is ``entry_class``.

        Requires ``lane_ticks=True``.  The session's cursor stays a [K, S]
        restricted transition map across ticks (``Matcher.advance_cursors``
        advances it without collapsing), so ``close_map`` can hand back a
        ``SegmentResult`` composable onto whatever prefix eventually lands —
        the scheduler half of the out-of-order tier (``streaming.ooo`` owns
        sequencing).
        """
        if not self.scheduler.lane_ticks:
            raise ValueError("open_at requires StreamMatcher(..., "
                             "lane_ticks=True)")
        sid = self._next_sid
        self._next_sid += 1
        session = StreamSession(sid, self,
                                open_lane_cursor(self.matcher.dev,
                                                 entry_class))
        self._sessions[sid] = session
        return session

    def close_map(self, session: StreamSession) -> SegmentResult:
        """Close a candidate-keyed session; returns its accumulated
        restricted transition map (everything fed, as one composable
        ``SegmentResult`` keyed on the session's ``entry_class``)."""
        if session.closed:
            raise ValueError("stream session is already closed")
        if session.owner is not self:
            raise ValueError("session belongs to a different StreamMatcher")
        if session.cursor.exact:
            raise ValueError("session is exact (opened at byte 0); use "
                             "close() for its final decision")
        if session.pending_bytes:
            self.scheduler.tick()
        session.closed = True
        self._sessions.pop(session.sid, None)
        cur = session.cursor
        return SegmentResult(lane_states=cur.lane_states.copy(),
                             entry_class=cur.entry_class,
                             n_bytes=cur.byte_count,
                             last_class=cur.last_class)

    def feed(self, session: StreamSession, data: bytes | np.ndarray, *,
             flush: bool = False) -> None:
        """Admit the stream's next segment; dispatch is up to the policy
        (``flush=True`` forces a tick after admission)."""
        if session.closed:
            raise ValueError("stream session is closed")
        if session.owner is not self:
            raise ValueError("session belongs to a different StreamMatcher")
        buf = (bytes(data) if isinstance(data, (bytes, bytearray))
               else np.asarray(data, np.uint8).tobytes())
        session.segments_fed += 1
        # empty segments route through too: they are a no-op for this stream
        # but still a feed event, so queued streams' max_delay / max_delay_s
        # deadlines advance (the scheduler never parks a zero-byte segment)
        self.scheduler.enqueue(session, buf)
        if flush:
            self.scheduler.tick()

    def flush(self) -> int:
        """Force one tick over everything pending; returns streams advanced."""
        return self.scheduler.tick()

    def close(self, session: StreamSession) -> StreamResult:
        """Flush the stream's pending bytes and return its final decision."""
        if session.closed:
            raise ValueError("stream session is already closed")
        if session.owner is not self:
            raise ValueError("session belongs to a different StreamMatcher")
        if session.pending_bytes:
            # one tick drains the whole queue, so closing one stream still
            # coalesces every other pending stream into the same device round
            self.scheduler.tick()
        session.closed = True
        self._sessions.pop(session.sid, None)
        states = session.cursor.states
        return StreamResult(
            accepted=self.matcher.packed.accepting[states].copy(),
            final_states=states.copy(),
            byte_count=session.cursor.byte_count,
            segments_fed=session.segments_fed)

    # -- hot pattern swap ----------------------------------------------------

    def _reset_open_cursors(self) -> None:
        """Re-open every live session's cursor at the new pattern starts.

        The post-swap carry for *changed* tables: old packed state ids mean
        nothing under the new table, so swapped patterns see only bytes fed
        after the swap.  ``byte_count`` keeps counting (a stream property);
        ``segments_fed`` persists on the session; eviction state resets so
        admission re-evaluates under the new tables
        (``MicroBatchScheduler.reopen``).
        """
        for sess in self._sessions.values():
            fresh = open_cursor(self.matcher.dev)
            sess.cursor = dataclasses.replace(
                fresh, byte_count=sess.cursor.byte_count)
            self.scheduler.reopen(sess)

    def swap_patterns(self, source) -> bool:
        """Hot-swap the pattern set at a tick boundary; True iff changed.

        * **Identical tables** (same ``packed_signature``): a no-op — returns
          False and in-flight cursors carry over bit-identically.
        * **Changed tables**: pending bytes first flush through the *old*
          tables (the tick boundary), then ``Matcher.swap_patterns`` rebuilds
          the device tables and every open exact session re-opens at the new
          starts (``_reset_open_cursors``).
        * **Candidate-keyed sessions** (``open_at``): refused while any is
          open — a [K, S] restricted map cannot be re-keyed onto different
          tables; close them (``close_map``) first.

        ``BlockedStreamMatcher.swap_patterns`` keeps unchanged blocks'
        cursors mid-stream while sibling blocks swap.
        """
        lanes = [s for s in self._sessions.values() if not s.cursor.exact]
        if lanes:
            raise ValueError(
                f"{len(lanes)} candidate-keyed session(s) are open; their "
                "[K, S] maps cannot be re-keyed onto new tables — close_map "
                "them before swap_patterns")
        if self.scheduler.pending_streams:
            self.scheduler.tick()
        if not self.matcher.swap_patterns(source):
            return False
        self._reset_open_cursors()
        return True

    # -- failover ------------------------------------------------------------

    def snapshot(self, directory: str, *, step: int | None = None) -> str:
        """Atomically publish every open session's state to ``directory``.

        The snapshot covers cursor lane states, absorbed flags, byte counts,
        boundary classes *and* unflushed pending bytes — the complete
        per-stream state (the Eq. 8 composition makes the cursor a full
        summary of everything already matched).  Writes go through
        ``training/checkpoint.py``'s atomic publish (``step_<N>.tmp`` then
        rename), so a writer killed mid-snapshot leaves only a ``.tmp``
        directory that restore ignores.  Returns the published path.
        """
        sessions = sorted((s for s in self._sessions.values() if not s.closed),
                          key=lambda s: s.sid)
        tree = sessions_tree(sessions, self.matcher.packed, self._next_sid,
                             signature=self.snapshot_signature)
        if step is None:
            step = self._snapshot_step
        self._snapshot_step = step + 1
        return save_sessions_tree(directory, tree, step)

    def restore(self, directory: str, *,
                step: int | None = None) -> list[StreamSession]:
        """Rebuild sessions from the latest (or ``step``-th) snapshot.

        The restoring matcher may run either backend on any device, and the
        snapshot may come from the JAX package: the tree is host numpy and
        the cursors' state ids are the packed table's.  Restored sessions
        with pending bytes are re-admitted to the scheduler (no feed event
        is counted — their bytes were accounted when originally fed); the
        next tick matches them on this matcher's own lowerings.  Refuses a
        snapshot taken against a different packed pattern set, or one whose
        session ids collide with sessions already open here.
        """
        tree, step = load_sessions_tree(
            directory, self.matcher, step=step,
            expect_signature=self.snapshot_signature)
        sids = [int(s) for s in tree["sid"]]
        clash = [sid for sid in sids if sid in self._sessions]
        if clash:
            raise ValueError(
                f"snapshot session ids {clash[:5]} are already open on this "
                "StreamMatcher; restore into a fresh matcher (or close the "
                "colliding sessions first)")
        off = tree["pending_off"]
        restored = []
        for i, sid in enumerate(sids):
            sess = StreamSession(sid, self, unpack_cursor(tree, i))
            sess.segments_fed = int(tree["segments_fed"][i])
            sess._evicted = bool(tree["evicted"][i])
            sess._pending = bytearray(
                tree["pending"][int(off[i]):int(off[i + 1])].tobytes())
            self._sessions[sid] = sess
            self.scheduler.readmit(sess)
            restored.append(sess)
        self._next_sid = max(self._next_sid, int(tree["next_sid"]))
        self._snapshot_step = max(self._snapshot_step, step + 1)
        return restored

    # -- introspection -------------------------------------------------------

    @property
    def stats(self) -> SchedulerStats:
        return self.scheduler.stats

    @property
    def n_patterns(self) -> int:
        return self.matcher.n_patterns


# imported last: blocked.py builds on StreamMatcher above
from .blocked import BlockedStreamMatcher, BlockedStreamSession  # noqa: E402
