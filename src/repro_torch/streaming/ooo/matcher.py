"""Out-of-order ingestion front-end: match first, sequence later.

``OooStreamMatcher`` accepts segments tagged ``(stream, seq_no)`` in any
arrival order, from any number of producers, with at-least-once delivery —
and produces results bit-identical to feeding every stream in order:

  * **match first** — an out-of-sequence segment whose boundary key is
    known (producer ``prev_tail`` hint, or chained from a buffered
    predecessor) is matched *immediately* as an independent candidate-keyed
    ``[K, S]`` transition map, batched across streams through the fused
    ``Matcher.advance_cursors`` path; its raw payload is dropped on the
    spot (the map is a complete composable summary — SFA, arXiv:1405.0562);
  * **sequence later** — the moment a stream's sequence gap closes, the
    contiguous run of buffered maps folds into the exact cursor in ONE
    device call (``Matcher.compose_lane_maps``: the compose kernel on the
    card — not one compose per segment); in-order arrivals never park and
    ride the plain exact path (``advance_segments``), so zero reordering
    costs zero overhead;
  * **duplicates dedup** — every delivery is keyed by its Rabin
    fingerprint; a re-delivered ``seq_no`` with identical content drops, a
    conflicting one raises (``OooIntegrityError``).  Nothing is ever
    double-composed.  With ``OooPolicy.cross_stream_dedup_window`` > 0, the
    same content arriving on *different* streams (fan-out topics, mirrored
    shards) is also deduped — as a compute dedup: the already-matched map
    is reused (``fingerprint.FingerprintWindow``), every stream still folds
    its own copy, decisions stay bit-identical;
  * **memory is bounded** — per-stream ``OooPolicy`` caps with
    ``ReorderBufferFull`` backpressure to the admission path.

No composition ever happens on the host: ``streaming.cursor.merge_calls``
stays untouched by feed/flush/close, exactly like the in-order scheduler
tick.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core.engine.facade import Matcher
from ..cursor import open_cursor
from ..session import StreamResult
from .buffer import (BufferedSegment, OooIntegrityError, OooPolicy,
                     ReorderBufferFull, SequenceGapError)
from .fingerprint import FingerprintWindow, segment_fingerprint
from .sequencer import Sequencer

__all__ = ["OooStreamMatcher", "OooStream", "OooStats"]

# raw tail bytes retained per segment: enough to chain boundary keys for
# any supported lookahead depth (DeviceTables.advance_key reads <= 2 bytes)
_TAIL_BYTES = 2


@dataclasses.dataclass
class OooStats:
    arrivals: int = 0           # feed() deliveries (incl. duplicates)
    duplicates: int = 0         # deliveries dropped by fingerprint dedup
    cross_stream_hits: int = 0  # maps reused from the cross-stream window
    ooo_arrivals: int = 0       # non-duplicate deliveries ahead of frontier
    bytes_fed: int = 0
    spec_matched: int = 0       # segments matched ahead of sequencing
    match_rounds: int = 0       # advance_cursors dispatch rounds
    exact_segments: int = 0     # frontier segments folded via the exact path
    exact_rounds: int = 0       # advance_segments dispatch rounds
    gap_closes: int = 0         # contiguous buffered runs folded
    scan_folds: int = 0         # compose_lane_maps dispatches (batched runs)
    scan_fold_segments: int = 0 # buffered maps folded through the scan
    absorbed_skips: int = 0     # segments never matched (cursor absorbed)
    flushes: int = 0
    bucket_calls: int = 0       # fused match dispatches (both paths)
    rows_dispatched: int = 0    # tile-padded device rows (occupancy denom)
    peak_buffered_segments: int = 0  # max parked in any one stream's buffer
    peak_buffered_bytes: int = 0     # max unmatched payload bytes, one stream

    @property
    def occupancy(self) -> float:
        """Real matched segments per padded device row."""
        return ((self.spec_matched + self.exact_segments)
                / max(self.rows_dispatched, 1))

    @property
    def scan_batch(self) -> float:
        """Mean buffered maps folded per compose dispatch."""
        return self.scan_fold_segments / max(self.scan_folds, 1)


class OooStream:
    """Per-stream handle: carries the stream id, delegates to the owner."""

    __slots__ = ("sid", "owner")

    def __init__(self, sid: int, owner: "OooStreamMatcher"):
        self.sid = sid
        self.owner = owner

    def feed(self, seq_no: int, data, *, prev_tail: bytes | None = None,
             flush: bool = False) -> None:
        self.owner.feed(self, seq_no, data, prev_tail=prev_tail, flush=flush)

    def close(self) -> StreamResult:
        return self.owner.close(self)

    @property
    def _sq(self) -> Sequencer:
        return self.owner._streams[self.sid]

    @property
    def next_seq(self) -> int:
        """The frontier: lowest sequence number not yet folded."""
        return self._sq.next_seq

    @property
    def buffered_segments(self) -> int:
        return len(self._sq.buf)

    @property
    def buffered_bytes(self) -> int:
        """Unmatched raw payload bytes currently parked."""
        return self._sq.buf.payload_bytes

    @property
    def byte_count(self) -> int:
        """Bytes folded into the exact cursor so far."""
        return self._sq.cursor.byte_count

    @property
    def stream_fingerprint(self) -> int:
        """Composed Rabin fingerprint of all folded bytes, in order."""
        return self._sq.stream_fp

    def early_accepts(self) -> np.ndarray:
        """[K] patterns already *decided to accept*, sequencing incomplete.

        Pattern ``k`` is decided when its states are accepting AND absorbing
        either on the exact cursor, or on **every candidate lane of some
        buffered matched map** — the suffix run guarantees the match no
        matter which bytes eventually fill the gap.  This is the match-first
        payoff for intrusion detection: alert on a segment from the future.
        """
        return self.owner._early_accepts(self._sq)


class OooStreamMatcher:
    """Out-of-order streaming facade over a ``Matcher``.

    ``source`` is anything ``Matcher`` accepts, or a pre-built ``Matcher``
    (shared compiled buckets).  ``policy`` is an ``OooPolicy``; remaining
    keyword arguments construct the matcher (``num_chunks`` defaults to 1,
    as in ``StreamMatcher`` — the stream/row axis is the parallelism).

    Drives the engine directly (``advance_cursors`` for speculative
    matching, ``advance_segments`` for the in-order frontier,
    ``compose_lane_maps`` for bulk gap closes) rather than through
    ``MicroBatchScheduler`` — sequencing, not tick latency, is the control
    problem here.  The scheduler's candidate-keyed twin is
    ``StreamMatcher(lane_ticks=True)`` + ``open_at``/``close_map``.
    """

    def __init__(self, source, *, policy: OooPolicy | None = None,
                 **matcher_kwargs):
        if isinstance(source, Matcher):
            if matcher_kwargs:
                raise ValueError("matcher kwargs conflict with a pre-built "
                                 f"Matcher: {sorted(matcher_kwargs)}")
            self.matcher = source
        else:
            matcher_kwargs.setdefault("num_chunks", 1)
            self.matcher = Matcher(source, **matcher_kwargs)
        self.policy = policy or OooPolicy()
        self.stats = OooStats()
        # cross-stream compute dedup: identical (fp, n_bytes, boundary key)
        # content on *different* streams reuses the matched [K, S] map
        # instead of re-dispatching; ephemeral (never checkpointed)
        self._xwindow = (FingerprintWindow(
            self.policy.cross_stream_dedup_window)
            if self.policy.cross_stream_dedup_window else None)
        self._streams: dict[int, Sequencer] = {}
        self._next_sid = 0
        self._snapshot_step = 0
        self._since_flush = 0   # accepted arrivals since the last flush

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> OooStream:
        """Open a stream; its segments number 0, 1, 2, ... in stream order
        but may arrive in any order."""
        sid = self._next_sid
        self._next_sid += 1
        self._streams[sid] = Sequencer(sid, open_cursor(self.matcher.dev),
                                       self.policy)
        return OooStream(sid, self)

    def feed(self, stream: OooStream, seq_no: int, data, *,
             prev_tail: bytes | None = None, flush: bool = False) -> None:
        """Deliver one segment of one stream, in whatever order it arrived.

        ``prev_tail`` optionally carries the <= 2 raw bytes immediately
        preceding the segment in stream order (producers shipping from a
        contiguous source have them for free): it lets the segment be
        matched speculatively *before* any of its predecessors land.
        Without it the entry key resolves by chaining from buffered
        predecessors, or the segment waits for the frontier (exact path).

        Raises ``ReorderBufferFull`` (backpressure; nothing mutated — the
        transport redelivers later) and ``OooIntegrityError`` (conflicting
        duplicate content, or a ``prev_tail`` contradicting the actual
        predecessor bytes).
        """
        sq = self._sequencer(stream)
        seq = int(seq_no)
        if seq < 0:
            raise ValueError(f"seq_no must be >= 0, got {seq}")
        buf = (bytes(data) if isinstance(data, (bytes, bytearray))
               else np.asarray(data, np.uint8).tobytes())
        self.stats.arrivals += 1
        self.stats.bytes_fed += len(buf)
        fp = segment_fingerprint(buf)
        if sq.is_duplicate(seq, fp, len(buf)):
            self.stats.duplicates += 1
            if flush:
                self.flush()
            return
        if seq != sq.next_seq:
            self.stats.ooo_arrivals += 1
        hint = -1
        if prev_tail is not None:
            if seq == 0 and len(prev_tail):
                raise ValueError("segment 0 has no preceding bytes; "
                                 "prev_tail must be empty")
            hint = self.matcher.dev.advance_key(-1, prev_tail)
        absorbed = bool(sq.cursor.absorbed.all())
        seg = BufferedSegment(
            seq=seq, n_bytes=len(buf), fp=fp, tail=buf[-_TAIL_BYTES:],
            # absorbed streams skip matching entirely: only the tail (for
            # boundary-key chaining) and byte accounting survive
            data=(buf if buf and not absorbed else None),
            hint_key=hint)
        try:
            sq.buf.admit(seg, stream_id=sq.sid,
                         bypass_caps=(seq == sq.next_seq))
        except ReorderBufferFull:
            # a flush may close gaps and drain the buffer; one retry, then
            # the backpressure propagates to the transport
            self.flush()
            sq.buf.admit(seg, stream_id=sq.sid,
                         bypass_caps=(seq == sq.next_seq))
        sq.segments_fed += 1
        self._since_flush += 1
        self.stats.peak_buffered_segments = max(
            self.stats.peak_buffered_segments, len(sq.buf))
        self.stats.peak_buffered_bytes = max(
            self.stats.peak_buffered_bytes, sq.buf.payload_bytes)
        if flush or self._since_flush >= self.policy.match_batch:
            self.flush()

    def close(self, stream: OooStream) -> StreamResult:
        """Flush, require a gapless sequence, and return the final decision
        — bit-identical to in-order feeding of the same segments."""
        sq = self._sequencer(stream)
        self.flush()
        if len(sq.buf):
            parked = sorted(sq.buf.segments)
            raise SequenceGapError(
                f"stream {sq.sid} closed with sequence gaps: seq "
                f"{sq.next_seq} never arrived ({len(parked)} segment(s) "
                f"parked beyond it: {parked[:8]}{'...' if len(parked) > 8 else ''})")
        sq.closed = True
        self._streams.pop(sq.sid, None)
        states = sq.cursor.states
        return StreamResult(
            accepted=self.matcher.packed.accepting[states].copy(),
            final_states=states.copy(),
            byte_count=sq.cursor.byte_count,
            segments_fed=sq.segments_fed)

    # -- failover ------------------------------------------------------------

    def snapshot(self, directory: str, *, step: int | None = None) -> str:
        """Persist every open stream — exact cursors AND the parked future
        (buffered payloads, matched maps, key chains, dedup windows) — as
        one atomically-published checkpoint step."""
        from .checkpoint import ooo_tree, save_ooo_tree

        if step is None:
            step = self._snapshot_step
        self._snapshot_step = step + 1
        return save_ooo_tree(directory, ooo_tree(self), step, self.matcher)

    def restore(self, directory: str, *, step: int | None = None) -> list:
        """Re-open the streams of the latest complete snapshot; returns the
        ``OooStream`` handles in snapshot order.  Device and package
        agnostic: a snapshot taken on either backend, on the card or the
        CPU, or by the JAX package restores on any matcher with the same
        packed tables and resolved lookahead depth."""
        from .checkpoint import load_ooo_tree, restore_streams

        tree, got_step = load_ooo_tree(directory, self, step=step)
        self._snapshot_step = max(self._snapshot_step, got_step + 1)
        return restore_streams(self, tree)

    # -- the flush loop ------------------------------------------------------

    def flush(self) -> None:
        """Run speculative matching + gap closing to quiescence.

        Each iteration batches across every open stream: one
        ``advance_cursors`` round matches all newly-keyed buffered segments,
        one ``advance_segments`` round advances all in-order frontiers, and
        one ``compose_lane_maps`` round folds all closed gaps (one
        compose dispatch for the whole batch of contiguous runs).
        Iterates because each round can unlock the next — a fold advances a
        frontier, which keys a chain, which matches more segments.
        """
        self.stats.flushes += 1
        self._since_flush = 0
        dev = self.matcher.dev
        while True:
            progress = False
            # round 1: speculative matching of newly keyed segments
            batch: list[tuple[Sequencer, BufferedSegment]] = []
            for sq in self._streams.values():
                for seg in sq.resolve_keys(dev):
                    batch.append((sq, seg))
            if batch:
                self._match_batch(batch)
                progress = True
            # round 2: classify each stream's frontier
            skip_runs, exact_runs, fold_runs = [], [], []
            for sq in self._streams.values():
                kind, run = self._frontier_run(sq)
                if kind == "skip":
                    skip_runs.append((sq, run))
                elif kind == "exact":
                    exact_runs.append((sq, run))
                elif kind == "fold":
                    fold_runs.append((sq, run))
            for sq, run in skip_runs:
                self._commit_skip(sq, run)
            if exact_runs:
                self._exact_round(exact_runs)
            if fold_runs:
                self._fold_round(fold_runs)
            progress |= bool(skip_runs or exact_runs or fold_runs)
            if not progress:
                return

    def _frontier_run(self, sq: Sequencer):
        """Classify the maximal homogeneous run starting at the frontier.

        ``skip``  — cursor fully absorbed: every contiguous parked segment
                    folds with pure host accounting (no device work);
        ``fold``  — matched maps (and empties): one scan-compose row;
        ``exact`` — unmatched payloads (and empties): concatenate and ride
                    ``advance_segments``, exactly like in-order streaming.
        """
        buf = sq.buf
        first = buf.get(sq.next_seq)
        if first is None:
            return None, []
        run: list[BufferedSegment] = []
        s = sq.next_seq
        if bool(sq.cursor.absorbed.all()):
            while (seg := buf.get(s)) is not None:
                run.append(seg)
                s += 1
            return "skip", run
        if first.matched or first.n_bytes == 0:
            while ((seg := buf.get(s)) is not None
                   and (seg.matched or seg.n_bytes == 0)):
                run.append(seg)
                s += 1
            return "fold", run
        while ((seg := buf.get(s)) is not None and not seg.matched
               and (seg.data is not None or seg.n_bytes == 0)):
            run.append(seg)
            s += 1
        return "exact", run

    def _match_batch(self, batch) -> None:
        """Match keyed buffered segments independently, one fused round.

        Each row enters at the Eq. 11 candidates of its entry key (an
        identity lane map), so the result lanes ARE the segment's restricted
        transition map; the raw payload is released on the spot.  With a
        cross-stream dedup window, content already matched under the same
        (fingerprint, n_bytes, boundary key) — on *any* stream — reuses the
        cached map and skips the dispatch entirely (the maps are read-only
        from here on, so sharing one array across streams is safe).  The
        dedup also collapses duplicates *within* the round, so fan-out
        topics feeding N mirrored streams dispatch each segment once, not
        N times.
        """
        followers: dict = {}
        if self._xwindow is not None:
            misses = []
            for sq, seg in batch:
                lanes = self._xwindow.get(seg.fp, seg.n_bytes, seg.entry_key)
                if lanes is not None:
                    seg.lanes = lanes
                    sq.buf.release_payload(seg)
                    self.stats.cross_stream_hits += 1
                    continue
                fkey = (seg.fp, seg.n_bytes, seg.entry_key)
                if fkey in followers:
                    # same content, same round: ride the leader's dispatch
                    followers[fkey].append((sq, seg))
                    self.stats.cross_stream_hits += 1
                else:
                    followers[fkey] = []
                    misses.append((sq, seg))
            batch = misses
            if not batch:
                return
        cands = self.matcher.dev.tables.candidates
        segs = [seg.data for _, seg in batch]
        lanes = np.ascontiguousarray(
            cands[[seg.entry_key for _, seg in batch]], np.int32)
        keys = np.array([seg.entry_key for _, seg in batch], np.int32)
        res = self.matcher.advance_cursors(segs, lanes, keys)
        for i, (sq, seg) in enumerate(batch):
            seg.lanes = np.asarray(res.lane_states[i], np.int32)
            sq.buf.release_payload(seg)
            if self._xwindow is not None:
                self._xwindow.put(seg.fp, seg.n_bytes, seg.entry_key,
                                  seg.lanes)
                for sq2, seg2 in followers[(seg.fp, seg.n_bytes,
                                            seg.entry_key)]:
                    seg2.lanes = seg.lanes
                    sq2.buf.release_payload(seg2)
        self.stats.spec_matched += len(batch)
        self.stats.match_rounds += 1
        self.stats.bucket_calls += res.bucket_calls
        self.stats.rows_dispatched += res.padded_rows

    def _exact_round(self, runs) -> None:
        """Advance in-order frontiers: one ``advance_segments`` dispatch."""
        payloads = [b"".join(seg.data or b"" for seg in run)
                    for _, run in runs]
        live = [(sq, run, pay) for (sq, run), pay in zip(runs, payloads)
                if pay]
        if live:
            entry = np.stack([sq.cursor.states for sq, _, _ in live])
            res = self.matcher.advance_segments([p for _, _, p in live],
                                                entry.astype(np.int32))
            self.stats.exact_rounds += 1
            self.stats.bucket_calls += res.bucket_calls
            self.stats.rows_dispatched += res.padded_rows
            for i, (sq, run, pay) in enumerate(live):
                last = self.matcher.dev.advance_key(sq.cursor.last_class, pay)
                sq.cursor = sq.cursor.advanced(res.final_states[i], len(pay),
                                               last, self.matcher.dev,
                                               absorbed=res.absorbed[i])
        for sq, run in runs:
            self._retire_run(sq, run)
            self.stats.exact_segments += len(run)

    def _fold_round(self, runs) -> None:
        """Close gaps: fold every stream's contiguous matched run in ONE
        ``compose_lane_maps`` dispatch."""
        dev = self.matcher.dev
        k = self.matcher.packed.n_patterns
        s = dev.i_max
        rows = []  # (sq, run, maps) — runs with at least one non-empty map
        for sq, run in runs:
            maps = [seg for seg in run if seg.n_bytes > 0]
            # the entry-key chain from the exact cursor is authoritative:
            # a spec-matched map whose key contradicts it means a corrupt
            # prev_tail hint slipped past resolve-time checking
            last = sq.cursor.last_class
            for seg in maps:
                if seg.entry_key != last:
                    raise OooIntegrityError(
                        f"stream {sq.sid} seq {seg.seq}: map keyed on "
                        f"boundary {seg.entry_key}, but the preceding bytes "
                        f"key it on {last}")
                last = dev.advance_key(last, seg.tail)
            if maps:
                rows.append((sq, run, maps))
            else:
                self._retire_run(sq, run)  # all-empty run: pure accounting
        if not rows:
            return
        n = 1 + max(len(maps) for _, _, maps in rows)
        b = len(rows)
        lane_maps = np.zeros((b, n, k, s), np.int32)
        keys = np.full((b, n), dev.pad_key, np.int32)
        for i, (sq, _, maps) in enumerate(rows):
            # element 0 seeds the scan with the exact cursor broadcast to
            # lane width (its key is never read); pads on the right are
            # identities, so ragged runs share one compiled scan
            lane_maps[i, 0] = sq.cursor.states[:, None]
            for j, seg in enumerate(maps):
                lane_maps[i, 1 + j] = seg.lanes
                keys[i, 1 + j] = seg.entry_key
        out = self.matcher.compose_lane_maps(lane_maps, keys)
        for i, (sq, run, maps) in enumerate(rows):
            n_bytes = sum(seg.n_bytes for seg in run)
            last = sq.cursor.last_class
            for seg in run:
                last = dev.advance_key(last, seg.tail) if seg.n_bytes else last
            # composed lanes agree across the lane axis (the seed was exact):
            # collapse via lane 0
            sq.cursor = sq.cursor.advanced(out[i, :, 0], n_bytes, last, dev)
            self._retire_run(sq, run)
            self.stats.scan_fold_segments += len(maps)
        self.stats.scan_folds += 1
        self.stats.gap_closes += len(rows)

    def _commit_skip(self, sq: Sequencer, run) -> None:
        """Fold a fully-absorbed stream's run: byte/key accounting only."""
        dev = self.matcher.dev
        last = sq.cursor.last_class
        n_bytes = 0
        for seg in run:
            last = dev.advance_key(last, seg.tail) if seg.n_bytes else last
            n_bytes += seg.n_bytes
        if n_bytes:
            sq.cursor = sq.cursor.skipped(n_bytes, last)
        self._retire_run(sq, run)
        self.stats.absorbed_skips += len(run)

    def _retire_run(self, sq: Sequencer, run) -> None:
        """Pop a folded run from the buffer and advance the frontier."""
        for seg in run:
            sq.buf.pop(seg.seq)
            sq.next_seq = seg.seq + 1
            sq.record_folded(seg)

    # -- introspection -------------------------------------------------------

    def _sequencer(self, stream: OooStream) -> Sequencer:
        if stream.owner is not self:
            raise ValueError("stream belongs to a different OooStreamMatcher")
        sq = self._streams.get(stream.sid)
        if sq is None or sq.closed:
            raise ValueError("stream is closed")
        return sq

    def _early_accepts(self, sq: Sequencer) -> np.ndarray:
        packed = self.matcher.packed
        absorbing = self.matcher.dev.absorbing
        states = sq.cursor.states
        decided = packed.accepting[states] & absorbing[states]
        for seg in sq.buf.segments.values():
            if seg.matched:
                decided |= (packed.accepting[seg.lanes].all(axis=1)
                            & absorbing[seg.lanes].all(axis=1))
        return decided

    @property
    def open_streams(self) -> int:
        return len(self._streams)

    @property
    def n_patterns(self) -> int:
        return self.matcher.n_patterns
