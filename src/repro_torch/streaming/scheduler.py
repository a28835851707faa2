"""Micro-batching scheduler: many independent streams, one device tick.

Unbounded byte streams (log tails, token-by-token decodes, chunked uploads)
arrive asynchronously and in tiny pieces — the worst case for a runtime
whose efficiency comes from fused, batched device calls.  The scheduler
closes that gap:

  * an **admission queue** collects pending segments per ``StreamSession``;
    multiple ``feed`` calls to the same stream between ticks *coalesce* into
    one segment (one scan instead of many);
  * a **tick** drains the queue: every pending stream contributes its
    coalesced segment and its cursor's entry states, and one
    ``Matcher.advance_segments`` call advances them all — segments share the
    planner's sticky pow2 shape buckets and ``batch_tile`` device tiles with
    whole-document matching, on either backend (cuda / local);
  * streams whose cursor is **fully absorbed** are *evicted from admission*:
    their bytes are accounted at ``enqueue`` time and they never enter the
    queue again, so a long-lived serving tier pays nothing — not even queue
    traversal — for decided streams (absorbing states self-loop on every
    class, so skipping is exact; ``SchedulerStats.evicted`` counts sessions
    dropped this way, once each);
  * a **tick is fully on-device**: one ``Matcher.advance_segments`` call
    composes every pending stream's cursor with its coalesced segment (the
    entry seed *is* the Eq. 8 composition), and cursors update from the
    batch result's precomputed arrays — zero per-stream host merges or
    table lookups (``streaming.cursor.merge_calls`` is the regression
    counter; the candidate-keyed batch variant is
    ``Matcher.advance_cursors``);
  * **tick policies** bound latency: eager flush (the default), or a tick
    fires when ``max_batch`` streams have pending data, the oldest pending
    segment has waited ``max_delay`` feed events, or it has waited
    ``max_delay_s`` wall-clock seconds — whichever comes first.  ``flush()``
    forces one.  Deadlines are evaluated at admission time (the scheduler
    owns no timer thread); an async serving loop enforces ``max_delay_s``
    between arrivals by calling ``flush()`` from its own timer.

Around the tick sits the **fault-tolerance layer** (see
docs/architecture.md, "Failover"):

  * a **dispatch that raises** (device loss, OOM, an injected fault) is
    retried under a bounded backoff through
    ``distributed.fault_tolerance.RestartManager``: affected cursors are
    restored from their pre-tick snapshots (``MatchCursor`` is frozen, so
    the held references *are* the snapshot), and the identical segments are
    re-dispatched — possibly onto a rebalanced layout.  When retries are
    exhausted, every segment goes back into admission (``_requeue``) before
    the failure propagates: no byte lost, none double-composed;
  * **degraded capacity rebalancing**: per-tick device timings feed a
    ``StragglerPolicy`` EWMA; when a device's decayed time drifts past the
    threshold, the matcher re-derives its capacity-weighted chunk layouts
    (``Matcher.rebalance``) strictly *between* ticks — the in-flight tick
    always completes on the layout it started with;
  * a ``FaultPlan`` (``streaming.faults``) injects kills, delays and
    capacity corruption by tick index, so all of the above runs
    deterministically in tests and ``tools/faultbench.py``.

``SchedulerStats.occupancy`` is real segments per padded device row — the
measure of how well micro-batching fills the fused calls (benchmarks
``--only stream_throughput`` tracks it against the one-shot baseline).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.engine.facade import Matcher
from ..distributed.fault_tolerance import RestartManager, StragglerPolicy
from .faults import FaultPlan

__all__ = ["TickPolicy", "RetryPolicy", "SchedulerStats",
           "MicroBatchScheduler"]


@dataclasses.dataclass(frozen=True)
class TickPolicy:
    """When the scheduler dispatches the admission queue.

    max_batch   : dispatch as soon as this many streams have pending
                  segments.
    max_delay   : max number of subsequent ``feed`` events a pending segment
                  may wait before a forced dispatch; 0 disables the
                  event-count deadline.
    max_delay_s : max wall-clock seconds the oldest pending segment may wait
                  before a forced dispatch; ``None`` disables the wall-clock
                  deadline.  Checked when segments are admitted (the
                  scheduler owns no timer — an async loop calls ``flush()``
                  on its own timer to bound latency between arrivals).

    With ``max_delay == 0`` and ``max_delay_s is None`` (the default) the
    policy is *eager*: every feed dispatches immediately.  Otherwise a tick
    fires on whichever deadline — batch, event-count or wall-clock — trips
    first.
    """

    max_batch: int = 64
    max_delay: int = 0
    max_delay_s: float | None = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_delay < 0:
            raise ValueError("max_delay must be >= 0")
        if self.max_delay_s is not None and self.max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")

    @property
    def eager(self) -> bool:
        return self.max_delay == 0 and self.max_delay_s is None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry of a failed tick dispatch (device loss, OOM).

    max_retries    : dispatch attempts allowed *after* the first failure
                     (0 = fail fast: first raise propagates, segments
                     requeued).
    backoff_s      : sleep before the first retry; each further retry
                     multiplies by ``backoff_factor``, capped at
                     ``max_backoff_s``.  0 disables sleeping (tests, and
                     schedulers whose caller owns pacing).
    """

    max_retries: int = 2
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")

    def delay(self, retry_index: int) -> float:
        """Sleep before retry ``retry_index`` (0-based), bounded."""
        return min(self.backoff_s * self.backoff_factor ** retry_index,
                   self.max_backoff_s)


@dataclasses.dataclass
class SchedulerStats:
    ticks: int = 0            # device dispatch rounds
    feeds: int = 0            # feed() calls admitted
    empty_feeds: int = 0      # zero-byte feeds (no-ops that advance deadlines)
    segments: int = 0         # coalesced segments actually matched
    absorbed_skips: int = 0   # segments skipped: cursor fully absorbed
    evicted: int = 0          # sessions dropped from admission (absorbed)
    bytes_fed: int = 0
    bytes_matched: int = 0    # excludes absorbed skips
    bucket_calls: int = 0     # fused device dispatches across all ticks
    rows_dispatched: int = 0  # tile-padded device rows (occupancy denom)
    early_exits: int = 0      # segments retired by the absorbing early exit
    dispatch_failures: int = 0  # dispatch attempts that raised (any cause)
    retries: int = 0          # re-dispatches after a failed attempt
    failed_ticks: int = 0     # ticks abandoned after max_retries (requeued)
    requeued_segments: int = 0  # segments returned to admission on giveup
    rebalances: int = 0       # capacity re-layouts applied between ticks

    @property
    def occupancy(self) -> float:
        """Real segments per padded device row (1.0 = perfectly full tiles)."""
        return self.segments / max(self.rows_dispatched, 1)

    @property
    def coalescing(self) -> float:
        """feed() calls folded into each matched segment (>= 1.0)."""
        return self.feeds / max(self.segments + self.absorbed_skips, 1)


class MicroBatchScheduler:
    """Admission queue + tick dispatch over a ``Matcher`` facade.

    ``clock`` (default ``time.monotonic``) timestamps pending segments for
    the ``max_delay_s`` wall-clock deadline; tests and simulated event loops
    may inject their own.  ``retry`` bounds the retry-with-restore loop
    around a failed dispatch; ``straggler`` (a
    ``distributed.fault_tolerance.StragglerPolicy``) turns per-tick device
    timings into between-tick capacity rebalances on a sharded matcher
    (each rank's tick time is gathered over the mesh first, so every rank
    trips and rebalances on the same [D] times; single-device matchers
    never rebalance);
    ``fault_plan`` (``streaming.faults.FaultPlan``) injects deterministic
    failures, delays and capacity corruption; ``sleep`` is the backoff
    sleeper (injectable for tests).
    """

    def __init__(self, matcher: Matcher, policy: TickPolicy | None = None,
                 *, clock=time.monotonic, retry: RetryPolicy | None = None,
                 straggler: StragglerPolicy | None = None,
                 fault_plan: FaultPlan | None = None, sleep=time.sleep,
                 lane_ticks: bool = False):
        self.matcher = matcher
        self.policy = policy or TickPolicy()
        # lane_ticks=True admits candidate-keyed sessions (opened mid-flight
        # via StreamMatcher.open_at): their cursors stay [K, S] lane maps
        # across ticks — advanced through Matcher.advance_cursors instead of
        # collapsing to exact states every tick — so a session's accumulated
        # map remains composable onto whatever prefix eventually lands (the
        # out-of-order tier's "match first, sequence later")
        self.lane_ticks = bool(lane_ticks)
        self.retry = retry or RetryPolicy()
        self.straggler = straggler
        self.fault_plan = fault_plan
        self._clock = clock
        self._sleep = sleep
        # sid -> session; dict preserves admission order, and re-feeding an
        # already-queued session keeps its (oldest) position — so the first
        # entry always carries the oldest pending_since for the latency test
        self._queue: dict[int, object] = {}
        self._feed_seq = 0
        self.stats = SchedulerStats()
        self.failures: list[tuple[int, str]] = []  # (tick index, repr(exc))

    @property
    def pending_streams(self) -> int:
        return len(self._queue)

    def enqueue(self, session, data: bytes) -> None:
        """Admit one segment; may trigger a tick per the policy.

        Fully-absorbed sessions are **evicted** instead of admitted: no byte
        can move any of their lanes (absorbing states self-loop on every
        class), so their segments are accounted into the cursor's byte count
        right here and the session never occupies a queue slot — ``close()``
        stays bit-identical, the serving tier just stops paying for decided
        streams.
        """
        self._feed_seq += 1
        self.stats.feeds += 1
        self.stats.bytes_fed += len(data)
        if not data and not session._pending:
            # empty segment: a no-op for this stream — it must not occupy a
            # queue slot (a pending-since stamp with zero bytes would trip
            # max_delay forever and inflate max_batch) — but it is still a
            # feed event, so every queued stream's max_delay / max_delay_s
            # deadline check must run
            self.stats.empty_feeds += 1
            if self._should_tick():
                self.tick()
            return
        if bool(session.cursor.absorbed.all()):
            buf = bytes(session._pending) + data
            session._pending = bytearray()
            session._pending_since = None
            session._pending_wall = None
            self._queue.pop(session.sid, None)
            if buf:
                last_class = self.matcher.dev.advance_key(
                    session.cursor.last_class, buf)
                session.cursor = session.cursor.skipped(len(buf), last_class)
                self.stats.absorbed_skips += 1
            if not session._evicted:
                session._evicted = True
                self.stats.evicted += 1
            # the feed still counts as an event for everyone else's deadline:
            # a queued live stream may now have waited max_delay feed events
            # (or max_delay_s seconds), so the policy check must still run
            if self._should_tick():
                self.tick()
            return
        session._pending += data
        if session._pending_since is None:
            session._pending_since = self._feed_seq
            session._pending_wall = self._clock()
        self._queue[session.sid] = session
        if self._should_tick():
            self.tick()

    def _should_tick(self) -> bool:
        if not self._queue:
            return False
        if self.policy.eager:
            return True
        if len(self._queue) >= self.policy.max_batch:
            return True
        oldest = next(iter(self._queue.values()))
        if self.policy.max_delay > 0 and \
                self._feed_seq - oldest._pending_since >= self.policy.max_delay:
            return True
        return (self.policy.max_delay_s is not None
                and self._clock() - oldest._pending_wall
                >= self.policy.max_delay_s)

    def reopen(self, session) -> None:
        """Clear a session's eviction state after a hot pattern swap.

        ``StreamMatcher.swap_patterns`` re-opens cursors at the *new*
        pattern starts, so a session evicted as fully absorbed under the old
        tables is live again — admission must re-evaluate it.  If it
        re-absorbs under the new tables it is evicted (and counted in
        ``stats.evicted``) anew; the eager-eviction invariant above is per
        table generation, not per stream lifetime.
        """
        session._evicted = False

    def readmit(self, session) -> None:
        """Re-admit a restored session's unflushed pending bytes.

        The snapshot/restore path (``StreamMatcher.restore``) rebuilds
        sessions whose pending segments were frozen mid-flight; re-admission
        counts no feed event — the bytes were accounted when originally fed
        — and triggers no tick (the caller decides when to flush).
        """
        if not session._pending:
            return
        if session._pending_since is None:
            session._pending_since = self._feed_seq
            session._pending_wall = self._clock()
        self._queue[session.sid] = session

    def tick(self) -> int:
        """Drain the queue in one coalesced device round; returns the number
        of streams advanced (matched or skipped).

        The round is fully on-device: segment matching *and* the Eq. 8
        cursor composition happen inside ``advance_segments``'s fused bucket
        calls (the entry seed is the composition), and every cursor updates
        from the batch result's arrays — no per-stream host merges
        (``streaming.cursor.merge`` stays untouched; ``merge_calls`` proves
        it) and no per-stream table lookups (absorbed flags come from
        ``SegmentBatchResult.absorbed`` rows).

        A dispatch that raises is retried with cursors restored from their
        pre-tick snapshots (``_dispatch_tick``); when retries are exhausted
        the segments return to admission and the failure propagates — the
        queue never loses a byte.
        """
        if not self._queue:
            return 0
        # failed ticks don't increment stats.ticks, but their dispatch round
        # still consumed a tick index — keep indices unique so a FaultPlan
        # schedule never re-fires on the requeued round
        tick_idx = self.stats.ticks + self.stats.failed_ticks
        sessions = list(self._queue.values())
        self._queue.clear()
        live, segs, entries = [], [], []
        lanes, lane_segs, lane_entries, lane_keys = [], [], [], []
        for s in sessions:
            data = bytes(s._pending)
            s._pending = bytearray()
            s._pending_since = None
            s._pending_wall = None
            if not data:
                continue
            last_class = self.matcher.dev.advance_key(s.cursor.last_class, data)
            if bool(s.cursor.absorbed.all()):
                # enqueue-time eviction keeps absorbed sessions out of the
                # queue, so this only catches sessions absorbed *by the
                # current drain order*; skipping the scan is bit-identical
                s.cursor = s.cursor.skipped(len(data), last_class)
                self.stats.absorbed_skips += 1
                continue
            if s.cursor.exact:
                live.append((s, len(data), last_class))
                segs.append(data)
                entries.append(s.cursor.states)
            else:
                if not self.lane_ticks:
                    raise ValueError(
                        "candidate-keyed session admitted without "
                        "lane_ticks=True (open mid-flight streams via "
                        "StreamMatcher(..., lane_ticks=True).open_at)")
                lanes.append((s, len(data), last_class))
                lane_segs.append(data)
                lane_entries.append(s.cursor.lane_states)
                lane_keys.append(s.cursor.last_class)
        if live or lanes:
            res, lres = self._dispatch_tick(tick_idx, live, segs, entries,
                                            lanes, lane_segs, lane_entries,
                                            lane_keys)
            self.stats.segments += len(live) + len(lanes)
            for r in (res, lres):
                if r is None:
                    continue
                self.stats.bytes_matched += int(r.lengths.sum())
                self.stats.bucket_calls += r.bucket_calls
                self.stats.rows_dispatched += r.padded_rows
                self.stats.early_exits += r.early_exits
        self.stats.ticks += 1
        return len(sessions)

    # -- fault-tolerant dispatch ---------------------------------------------

    def _dispatch_tick(self, tick_idx: int, live, segs, entries,
                       lanes=(), lane_segs=(), lane_entries=(),
                       lane_keys=()):
        """One fused dispatch round under retry-with-restore semantics.

        The pre-tick cursors are the snapshot — ``MatchCursor`` is frozen,
        so holding the references is a complete, immutable copy.  The fused
        calls *and* the cursor commits run as one ``RestartManager`` step
        (exact sessions through ``advance_segments``, candidate-keyed
        lane-tick sessions through ``advance_cursors``): a raise anywhere
        (device loss inside a fused call, or a post-commit fault) restores
        every affected cursor from its snapshot via the manager's
        ``restore_fn``, applies the bounded backoff, lets the straggler
        monitor rebalance the layout, and re-dispatches the identical
        segments — so a retried segment is composed exactly once.  When
        ``RetryPolicy.max_retries`` is exhausted the segments are requeued
        into admission (no byte lost) and the failure propagates, cursors
        restored.
        """
        lanes = list(lanes)
        all_live = list(live) + lanes
        snapshots = [s.cursor for (s, _, _) in all_live]
        entry = np.stack(entries).astype(np.int32) if live else None
        lentry = (np.stack(lane_entries).astype(np.int32) if lanes else None)
        lkeys = np.asarray(lane_keys, np.int32) if lanes else None
        state = {"attempt": 0}
        box: dict[str, object] = {}

        def step_fn(st, _step):
            attempt = state["attempt"]
            state["attempt"] += 1
            if self.fault_plan is not None:
                self.fault_plan.maybe_fail(tick_idx, attempt, "pre")
            t0 = self._clock()
            res = lres = None
            if live:
                res = self.matcher.advance_segments(segs, entry)
            if lanes:
                lres = self.matcher.advance_cursors(lane_segs, lentry, lkeys)
            wall = self._clock() - t0
            if live:
                for i, (s, n, last_class) in enumerate(live):
                    s.cursor = s.cursor.advanced(res.final_states[i], n,
                                                 last_class, self.matcher.dev,
                                                 absorbed=res.absorbed[i])
            for i, (s, n, last_class) in enumerate(lanes):
                s.cursor = s.cursor.advanced_lanes(lres.lane_states[i], n,
                                                   last_class,
                                                   lres.absorbed[i])
            if self.fault_plan is not None:
                # post-commit fault: cursors are already updated — recovery
                # MUST roll them back or the retry double-composes
                self.fault_plan.maybe_fail(tick_idx, attempt, "post")
            box["res"], box["lres"], box["wall"] = res, lres, wall
            return st

        def restore_fn():
            for (s, _, _), cur in zip(all_live, snapshots):
                s.cursor = cur
            retry_idx = state["attempt"] - 1  # per-dispatch backoff index
            self.stats.retries += 1
            # a failed attempt is itself a degradation signal: feed the
            # straggler EWMA so the retry can land on a rebalanced layout
            self._feed_straggler(tick_idx, None)
            delay = self.retry.delay(retry_idx)
            if delay > 0:
                self._sleep(delay)
            return None, 0

        mgr = RestartManager(lambda _state, _step: None, restore_fn,
                             max_restarts=self.retry.max_retries)
        try:
            mgr.run(None, 0, 1, step_fn)
        except Exception:
            # retries exhausted: cursors back to their snapshots, segments
            # back into admission ahead of anything fed later — the caller
            # sees the failure, the queue sees no loss
            for (s, _, _), cur in zip(all_live, snapshots):
                s.cursor = cur
            self._requeue(all_live, list(segs) + list(lane_segs))
            self.stats.failed_ticks += 1
            raise
        finally:
            self.stats.dispatch_failures += len(mgr.failures)
            self.failures.extend((tick_idx, msg) for _, msg in mgr.failures)
        self._feed_straggler(tick_idx, float(box["wall"]))
        return box["res"], box["lres"]

    def _requeue(self, live, segs) -> None:
        """Return a failed tick's segments to the head of admission."""
        requeued: dict[int, object] = {}
        for (s, _, _), data in zip(live, segs):
            # anything fed between the failed dispatch and this requeue sits
            # in s._pending already — the failed segment goes back in front
            s._pending = bytearray(data) + s._pending
            if s._pending_since is None:
                s._pending_since = self._feed_seq
                s._pending_wall = self._clock()
            requeued[s.sid] = s
            self.stats.requeued_segments += 1
        requeued.update(self._queue)
        self._queue = requeued

    def _feed_straggler(self, tick_idx: int, wall: float | None) -> None:
        """Feed per-device timings into the EWMA; rebalance on a trip.

        Runs strictly *between* dispatches (after a tick completes, or
        between retry attempts) — an in-flight fused call always finishes on
        the layout it started with.  Without a fault plan the single wall
        measurement spreads uniformly (real per-host telemetry would slot in
        here); a ``FaultPlan`` overlays its scheduled delays and capacity
        corruption, which is how degraded-capacity recovery is exercised
        deterministically.  On a sharded matcher each rank's own wall
        time is all-gathered over the mesh (row-major), so the [D] times,
        the trip and the new capacities are the same on every rank.
        """
        if self.straggler is None:
            return
        m = self.matcher
        if m.backend != "sharded" or m.n_devices < 2:
            return  # single-device layouts are uniform: nothing to rebalance
        from ..core.profiling import mesh_gather_values
        n = m.n_devices
        own = max(wall if wall is not None else 1e-3, 1e-9) / n
        base = mesh_gather_values(m.executor.mesh, [own],
                                  m.device).reshape(-1)
        times = (self.fault_plan.device_times(tick_idx, base)
                 if self.fault_plan is not None else base)
        if self.straggler.update(times):
            m.rebalance(self.straggler.capacities())
            self.stats.rebalances += 1
