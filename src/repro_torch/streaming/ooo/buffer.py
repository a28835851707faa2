"""Per-stream reorder buffer: bounded parking for out-of-sequence segments.

A stream's segments carry ``(seq_no, bytes)`` and may arrive in any order,
more than once.  Segments ahead of the stream's frontier (the next
unfolded ``seq_no``) park here as ``BufferedSegment`` records; the matcher
replaces each record's raw payload with its candidate-keyed ``[K, S]``
transition map as soon as the segment's entry key is known (match first),
and the sequencer drains contiguous runs into the exact cursor when the
gap closes (sequence later).

Memory is bounded two ways, both per stream (``OooPolicy``):

  * ``max_buffered_segments`` caps parked records — matched maps are
    fixed-size ``[K, S]`` int32, so this bounds map memory;
  * ``max_buffered_bytes`` caps *raw payload* bytes held (payloads are
    dropped the moment a segment is matched, so a fast matcher keeps this
    near zero even under heavy reordering).

Hitting either cap raises ``ReorderBufferFull`` — the backpressure signal
to the admission path: the transport should redeliver after the frontier
advances.  Frontier segments (``seq_no == next_seq``) bypass the caps;
they strictly drain the buffer at the next flush, so refusing them could
deadlock a full buffer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["OooPolicy", "BufferedSegment", "ReorderBuffer",
           "ReorderBufferFull", "OooIntegrityError", "SequenceGapError"]


class ReorderBufferFull(RuntimeError):
    """A stream's reorder buffer is at capacity (backpressure, not failure).

    The segment was **not** admitted; nothing was mutated.  Deliver the
    stream's missing frontier segments (``OooStream.next_seq``) or flush,
    then redeliver.
    """

    def __init__(self, msg: str, *, stream_id: int, seq_no: int):
        super().__init__(msg)
        self.stream_id = stream_id
        self.seq_no = seq_no


class OooIntegrityError(ValueError):
    """Conflicting deliveries: same ``seq_no``, different content — or a
    ``prev_tail`` hint that contradicts the bytes that actually precede the
    segment.  Retrying cannot help; the transport is corrupting data."""


class SequenceGapError(RuntimeError):
    """A stream was closed while sequence numbers are still missing."""


@dataclasses.dataclass(frozen=True)
class OooPolicy:
    """Bounds and batching knobs of the out-of-order ingestion tier.

    max_buffered_segments : per-stream cap on parked segments (bounds the
                            ``[K, S]`` map memory of matched segments).
    max_buffered_bytes    : per-stream cap on *unmatched* raw payload bytes.
    dedup_window          : folded ``seq_no``s (behind the frontier) whose
                            ``(fingerprint, n_bytes)`` are retained so late
                            duplicate deliveries verify instead of erroring;
                            older late arrivals are dropped unverified.
    match_batch           : arrivals with a known entry key accumulated
                            before an automatic flush batches them into one
                            ``Matcher.advance_cursors`` dispatch (1 =
                            match every arrival eagerly).
    cross_stream_dedup_window : entries of the *global* (fingerprint,
                            n_bytes, boundary key) -> matched-map LRU shared
                            across streams (``fingerprint
                            .FingerprintWindow``): identical content fed on
                            different streams reuses the already-matched
                            ``[K, S]`` map instead of re-dispatching —
                            compute dedup, never drop dedup, so every
                            stream's decisions stay bit-identical.  0
                            (default) disables; the window is ephemeral
                            across checkpoints.
    """

    max_buffered_segments: int = 1024
    max_buffered_bytes: int = 1 << 22
    dedup_window: int = 256
    match_batch: int = 32
    cross_stream_dedup_window: int = 0

    def __post_init__(self):
        if self.max_buffered_segments < 1:
            raise ValueError("max_buffered_segments must be >= 1")
        if self.max_buffered_bytes < 1:
            raise ValueError("max_buffered_bytes must be >= 1")
        if self.dedup_window < 0:
            raise ValueError("dedup_window must be >= 0")
        if self.match_batch < 1:
            raise ValueError("match_batch must be >= 1")
        if self.cross_stream_dedup_window < 0:
            raise ValueError("cross_stream_dedup_window must be >= 0")


@dataclasses.dataclass
class BufferedSegment:
    """One parked segment of one stream.

    ``data`` holds the raw payload only while the segment is unmatched;
    matching replaces it with ``lanes`` (the segment's restricted transition
    map) and releases the bytes.  ``tail`` keeps the last <= 2 raw bytes —
    enough to chain boundary keys through ``DeviceTables.advance_key`` for
    any supported lookahead depth r — so successors can resolve their entry
    keys (and the fold can maintain ``last_class``) without the payload.
    ``entry_key`` is the boundary key the map is keyed on (-1 while
    unknown); ``hint_key`` is the producer-supplied ``prev_tail`` derivation
    used both to match before the predecessor lands and to cross-check the
    chain (mismatch = ``OooIntegrityError``).
    """

    seq: int
    n_bytes: int
    fp: int
    tail: bytes
    data: bytes | None
    entry_key: int = -1
    hint_key: int = -1
    lanes: np.ndarray | None = None    # [K, S] int32 once matched

    @property
    def matched(self) -> bool:
        return self.lanes is not None


class ReorderBuffer:
    """seq_no-keyed parking lot of one stream, capacity-enforced."""

    def __init__(self, policy: OooPolicy):
        self.policy = policy
        self.segments: dict[int, BufferedSegment] = {}
        self.payload_bytes = 0  # raw (unmatched) payload held

    def __len__(self) -> int:
        return len(self.segments)

    def get(self, seq: int) -> BufferedSegment | None:
        return self.segments.get(seq)

    def admit(self, seg: BufferedSegment, *, stream_id: int,
              bypass_caps: bool = False) -> None:
        """Park one segment; raises ``ReorderBufferFull`` (nothing mutated)
        when a cap would be exceeded and ``bypass_caps`` is False (frontier
        segments bypass — they strictly drain the buffer)."""
        pol = self.policy
        held = len(seg.data) if seg.data is not None else 0
        if not bypass_caps:
            if len(self.segments) + 1 > pol.max_buffered_segments:
                raise ReorderBufferFull(
                    f"stream {stream_id}: reorder buffer at "
                    f"{len(self.segments)} segments "
                    f"(max_buffered_segments={pol.max_buffered_segments}); "
                    f"deliver the frontier or flush, then redeliver seq "
                    f"{seg.seq}", stream_id=stream_id, seq_no=seg.seq)
            if self.payload_bytes + held > pol.max_buffered_bytes:
                raise ReorderBufferFull(
                    f"stream {stream_id}: reorder buffer holds "
                    f"{self.payload_bytes} unmatched payload bytes "
                    f"(max_buffered_bytes={pol.max_buffered_bytes}); "
                    f"deliver the frontier or flush, then redeliver seq "
                    f"{seg.seq}", stream_id=stream_id, seq_no=seg.seq)
        self.segments[seg.seq] = seg
        self.payload_bytes += held

    def release_payload(self, seg: BufferedSegment) -> None:
        """Drop a segment's raw payload (it has been matched into lanes)."""
        if seg.data is not None:
            self.payload_bytes -= len(seg.data)
            seg.data = None

    def pop(self, seq: int) -> BufferedSegment:
        seg = self.segments.pop(seq)
        if seg.data is not None:
            self.payload_bytes -= len(seg.data)
        return seg
