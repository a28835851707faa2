"""Per-stream sequencing state: frontier tracking + entry-key resolution.

One ``Sequencer`` per open out-of-order stream.  It owns the stream's
exact ``MatchCursor`` (the composed prefix up to the frontier), the
``ReorderBuffer`` of parked future segments, the duplicate-verification
window, and the composed whole-stream Rabin fingerprint.

The entry-key chain is what makes "match first" possible: a buffered
segment can be matched speculatively (``Matcher.advance_cursors`` from the
Eq. 11 candidates of its entry key) as soon as its boundary key is known,
which happens through either

  * a producer ``prev_tail`` hint — the <= r bytes preceding the segment,
    carried by the transport (``advance_key(-1, prev_tail)``), or
  * its predecessor: once segment ``n-1`` is buffered with a known entry
    key, ``n``'s key is ``advance_key(entry(n-1), tail(n-1))`` — one pass
    in ascending ``seq_no`` order propagates whole chains.

When both sources exist they must agree (``OooIntegrityError`` otherwise —
the hint claims bytes that contradict what actually precedes the segment).
Segments whose key never resolves before they reach the frontier simply
fall back to the exact path there: sound, merely less speculative.
"""

from __future__ import annotations

from ..cursor import MatchCursor
from .buffer import (BufferedSegment, OooIntegrityError, OooPolicy,
                     ReorderBuffer)
from .fingerprint import compose_fingerprints

__all__ = ["Sequencer"]


class Sequencer:
    """Sequencing state of one out-of-order stream."""

    __slots__ = ("sid", "cursor", "next_seq", "buf", "folded_fp",
                 "stream_fp", "segments_fed", "closed")

    def __init__(self, sid: int, cursor: MatchCursor, policy: OooPolicy):
        self.sid = sid
        self.cursor = cursor
        self.next_seq = 0
        self.buf = ReorderBuffer(policy)
        # seq -> (fingerprint, n_bytes) of already-folded segments, kept for
        # policy.dedup_window seqs behind the frontier so late duplicate
        # deliveries verify instead of erroring
        self.folded_fp: dict[int, tuple[int, int]] = {}
        self.stream_fp = 0     # Rabin fp of all folded bytes, in order
        self.segments_fed = 0  # distinct (non-duplicate) arrivals accepted
        self.closed = False

    # -- duplicate delivery --------------------------------------------------

    def is_duplicate(self, seq: int, fp: int, n_bytes: int) -> bool:
        """True when ``seq`` was already delivered (drop the copy).

        Verifies content against the recorded ``(fingerprint, n_bytes)``
        pair — a mismatch means the transport delivered *different* bytes
        under one sequence number (``OooIntegrityError``).  Folded seqs
        older than the dedup window are assumed duplicates unverified.
        """
        if seq < self.next_seq:
            rec = self.folded_fp.get(seq)
            if rec is not None and rec != (fp, n_bytes):
                raise OooIntegrityError(
                    f"stream {self.sid} seq {seq}: duplicate delivery with "
                    f"different content (fp {fp}/{n_bytes}B vs recorded "
                    f"{rec[0]}/{rec[1]}B)")
            return True
        seg = self.buf.get(seq)
        if seg is not None:
            if (seg.fp, seg.n_bytes) != (fp, n_bytes):
                raise OooIntegrityError(
                    f"stream {self.sid} seq {seq}: duplicate delivery with "
                    f"different content (fp {fp}/{n_bytes}B vs buffered "
                    f"{seg.fp}/{seg.n_bytes}B)")
            return True
        return False

    # -- entry-key chains ----------------------------------------------------

    def resolve_keys(self, dev) -> list[BufferedSegment]:
        """Propagate entry keys through the buffer; returns segments that
        are now speculatively matchable (key known, payload unmatched).

        One ascending pass suffices: a segment's key comes from its hint or
        from its immediate predecessor's ``out key``
        (``advance_key(entry, tail)`` — computable from the buffered tail
        even for matched segments whose payload is gone).  The frontier
        segment's key is the cursor's ``last_class`` when the cursor has
        absorbed enough history for a boundary key.
        """
        matchable = []
        for seq in sorted(self.buf.segments):
            seg = self.buf.segments[seq]
            if seg.entry_key < 0:
                derived = -1
                if seq == self.next_seq:
                    derived = int(self.cursor.last_class) \
                        if self.cursor.last_class >= 0 else -1
                else:
                    pred = self.buf.get(seq - 1)
                    if pred is not None and pred.entry_key >= 0:
                        derived = dev.advance_key(pred.entry_key, pred.tail)
                if seg.hint_key >= 0:
                    if derived >= 0 and derived != seg.hint_key:
                        raise OooIntegrityError(
                            f"stream {self.sid} seq {seq}: prev_tail hint "
                            f"keys the segment on boundary {seg.hint_key}, "
                            f"but the preceding bytes key it on {derived}")
                    seg.entry_key = seg.hint_key if derived < 0 else derived
                elif derived >= 0:
                    seg.entry_key = derived
            # the frontier segment is never matched speculatively: it folds
            # through the cheaper exact path (advance_segments) in the same
            # flush — its resolved key above only seeds successors' chains
            if (seg.entry_key >= 0 and seq != self.next_seq
                    and not seg.matched and seg.data is not None
                    and seg.n_bytes):
                matchable.append(seg)
        return matchable

    # -- fold bookkeeping ----------------------------------------------------

    def record_folded(self, seg: BufferedSegment) -> None:
        """Account one segment folded into the cursor (in sequence order)."""
        self.stream_fp = compose_fingerprints(self.stream_fp, seg.fp,
                                              seg.n_bytes)
        window = self.buf.policy.dedup_window
        if window > 0:
            self.folded_fp[seg.seq] = (seg.fp, seg.n_bytes)
            floor = self.next_seq - window
            if len(self.folded_fp) > window:
                for old in [s for s in self.folded_fp if s < floor]:
                    del self.folded_fp[old]
