"""Resumable match cursors: Eq. 8 composition across segment boundaries.

The paper's merge (Eq. 8) is associative: a chunk's contribution to the
final state is a *function* from entry states to exit states, keyed by the
reverse-lookahead class of the byte just before the chunk, and functions
compose.  That is exactly the property Simultaneous Finite Automata
(Sin'ya et al., arXiv:1405.0562) exploit — and it means a membership test
never has to see the whole input at once.

Two representations of a stream prefix live here:

  * a **collapsed (exact) cursor** — ``entry_class == ENTRY_EXACT`` with one
    lane per pattern holding the exact packed state after the prefix.  This
    is what ``StreamMatcher`` sessions carry: streams are fed from their true
    beginning, so the exact state is always known and the device's
    segment-entry path (``Matcher.advance_segments``) continues it directly.
  * a **speculative lane cursor** — ``lane_states [K, S]`` holding the exit
    state of the prefix under each Eq. 11 candidate entry state of
    ``entry_class`` (the SFA-style restricted transition map).  This is what
    an *independently matched* segment produces (``segment_result``): it can
    be computed before the preceding bytes are known and composed later.

``merge`` is the pure Eq. 8 composition of a cursor with a segment's map.
It is exact by the paper's argument: the cursor's state ``q`` was produced
by reading a byte of class ``c = seg.entry_class``, so ``q`` has an incoming
``c``-transition and is a candidate of ``I_c`` — unless ``q`` is the
pattern's sink, which is absorbing and stays the sink.  Feeding a document
through any segmentation is therefore bit-identical to one-shot matching
(property-tested in tests/test_streaming.py).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from ..core.engine.plan import DeviceTables
from ..kernels.ref import cursor_merge_ref

__all__ = ["ENTRY_EXACT", "MatchCursor", "SegmentResult", "open_cursor",
           "open_lane_cursor", "segment_result", "merge", "merge_calls",
           "reset_merge_calls", "counting_merges"]

ENTRY_EXACT = -1  # lane axis is exact (one true lane), not candidate-keyed

# Host merges performed since import — the streaming data paths must leave
# this untouched (composition happens on device: ``Matcher.advance_segments``
# fuses the entry seed, ``Matcher.advance_cursors`` the lane composition,
# ``Matcher.compose_lane_maps`` the out-of-order gap close).
_MERGE_CALLS = 0


def merge_calls() -> int:
    """Host-side ``merge`` invocations so far (regression counter)."""
    return _MERGE_CALLS


def reset_merge_calls() -> int:
    """Zero the counter; returns the value it had.

    Tests must not couple through import-lifetime state: reset the counter
    (or use ``counting_merges``) before asserting ``merge_calls() == 0``,
    so the assertion measures only the test's own data path.
    """
    global _MERGE_CALLS
    prev = _MERGE_CALLS
    _MERGE_CALLS = 0
    return prev


@contextlib.contextmanager
def counting_merges():
    """Scoped view of the counter: yields a callable returning the number of
    host merges performed since entering the context.

        with counting_merges() as merged:
            ... tick path ...
        assert merged() == 0
    """
    start = _MERGE_CALLS
    yield lambda: _MERGE_CALLS - start


@dataclasses.dataclass(frozen=True)
class SegmentResult:
    """One segment's restricted transition map, matched independently.

    ``lane_states[k, j]`` is pattern ``k``'s exit state when the segment is
    entered in ``candidates[entry_class, k, j]`` (or in its start state for
    ``entry_class == ENTRY_EXACT``, where the lane axis has width 1).
    """

    lane_states: np.ndarray  # [K, S] int32 exit states per entry lane
    entry_class: int         # joint class keying the lane axis, or ENTRY_EXACT
    n_bytes: int
    last_class: int          # boundary key after the segment (r-byte suffix
                             # window, ``DeviceTables.advance_key``);
                             # ENTRY_EXACT when the segment is empty


@dataclasses.dataclass(frozen=True)
class MatchCursor:
    """Resumable per-stream matching state (pure host data, pattern-packed).

    ``absorbed[k]`` means every lane of pattern ``k`` sits in an absorbing
    state: no further byte can move it, so a scheduler may skip matching the
    stream's remaining segments entirely (stream-level early exit).
    ``byte_count`` and ``last_class`` persist across segment boundaries;
    ``last_class`` keys the candidate row of the next independent segment.
    """

    lane_states: np.ndarray  # [K, S] int32 (S == 1 for exact cursors)
    entry_class: int         # ENTRY_EXACT or the joint class keying the lanes
    absorbed: np.ndarray     # [K] bool
    byte_count: int
    last_class: int          # ENTRY_EXACT before any byte was absorbed

    @property
    def exact(self) -> bool:
        return self.entry_class == ENTRY_EXACT

    @property
    def states(self) -> np.ndarray:
        """Exact [K] packed states (collapsed cursors only)."""
        if not self.exact:
            raise ValueError("cursor is candidate-keyed; merge it onto an "
                             "exact prefix before reading states")
        return self.lane_states[:, 0]

    def accepted(self, tables: DeviceTables) -> np.ndarray:
        """[K] accept flags of the exact current states."""
        return tables.packed.accepting[self.states]

    def advanced(self, final_states: np.ndarray, n_bytes: int,
                 last_class: int, tables: DeviceTables,
                 absorbed: np.ndarray | None = None) -> "MatchCursor":
        """Collapsed successor from a device segment result (the scheduler's
        fast path: ``Matcher.advance_segments`` already composed on device).

        ``absorbed`` takes the batch result's precomputed [K] flags
        (``SegmentBatchResult.absorbed`` rows) so a tick performs zero
        per-stream table lookups; omitted, they are derived here.
        """
        if not self.exact:
            raise ValueError("device continuation requires an exact cursor")
        if n_bytes == 0:
            return self
        st = np.asarray(final_states, np.int32).reshape(-1, 1)
        if absorbed is None:
            absorbed = tables.absorbing[st].all(axis=1)
        return MatchCursor(lane_states=st, entry_class=ENTRY_EXACT,
                           absorbed=np.asarray(absorbed, bool).reshape(-1),
                           byte_count=self.byte_count + int(n_bytes),
                           last_class=int(last_class))

    def advanced_lanes(self, lane_states: np.ndarray, n_bytes: int,
                       last_class: int,
                       absorbed: np.ndarray) -> "MatchCursor":
        """Candidate-keyed successor from a device cursor result — the
        lane-tick scheduler path (``Matcher.advance_cursors`` rows).

        The cursor stays keyed on its original ``entry_class`` across ticks
        (its restricted transition map just grew by one segment), so it
        remains composable onto whatever prefix eventually lands.
        """
        if self.exact:
            raise ValueError("exact cursors continue via advanced(); "
                             "advanced_lanes extends candidate-keyed maps")
        if n_bytes == 0:
            return self
        return MatchCursor(lane_states=np.asarray(lane_states, np.int32),
                           entry_class=self.entry_class,
                           absorbed=np.asarray(absorbed, bool).reshape(-1),
                           byte_count=self.byte_count + int(n_bytes),
                           last_class=int(last_class))

    def skipped(self, n_bytes: int, last_class: int) -> "MatchCursor":
        """Account bytes the scheduler never matched (fully absorbed)."""
        return dataclasses.replace(self, byte_count=self.byte_count + int(n_bytes),
                                   last_class=int(last_class))


def open_cursor(tables: DeviceTables) -> MatchCursor:
    """Fresh exact cursor at the packed pattern starts (zero bytes read)."""
    starts = tables.packed.starts.astype(np.int32).reshape(-1, 1)
    return MatchCursor(lane_states=starts.copy(), entry_class=ENTRY_EXACT,
                       absorbed=tables.absorbing[starts].all(axis=1),
                       byte_count=0, last_class=ENTRY_EXACT)


def open_lane_cursor(tables: DeviceTables, entry_class: int) -> MatchCursor:
    """Identity candidate-keyed cursor: zero bytes read, keyed on
    ``entry_class``.

    Its lane map is the identity on the Eq. 11 candidate row itself — lane
    ``(k, j)`` holds ``candidates[entry_class, k, j]`` — so composing it
    under any prefix ending in ``entry_class`` is a no-op.  This is how a
    stream opens *mid-flight* (an out-of-order segment run, a lane-tick
    scheduler session): match first, compose onto the exact prefix later.
    """
    cls = int(entry_class)
    if not 0 <= cls < tables.n_keys:
        raise ValueError(f"entry_class must be a boundary key in "
                         f"[0, {tables.n_keys}), got {cls}")
    lanes = tables.tables.candidates[cls].astype(np.int32).copy()
    return MatchCursor(lane_states=lanes, entry_class=cls,
                       absorbed=tables.absorbing[lanes].all(axis=1),
                       byte_count=0, last_class=cls)


def segment_result(tables: DeviceTables, data: bytes | np.ndarray,
                   entry_class: int = ENTRY_EXACT) -> SegmentResult:
    """Match one segment independently of whatever precedes it.

    For ``entry_class == ENTRY_EXACT`` the segment is matched from the
    pattern starts (only composable onto a zero-byte cursor); otherwise it is
    matched speculatively from every Eq. 11 candidate of ``entry_class`` —
    computable before the preceding bytes are known, exactly like a
    speculative chunk of the in-document pipeline.
    """
    packed = tables.packed
    arr = (np.frombuffer(data, np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, np.uint8))
    cls = packed.classes_of(arr)
    if entry_class == ENTRY_EXACT:
        states = packed.starts.astype(np.int32).reshape(-1, 1).copy()
    else:
        states = tables.tables.candidates[entry_class].astype(np.int32).copy()
    for c in cls:
        states = packed.table[states, int(c)]
    return SegmentResult(lane_states=states.astype(np.int32),
                         entry_class=int(entry_class), n_bytes=int(arr.size),
                         last_class=(tables.advance_key(entry_class, arr)
                                     if arr.size else ENTRY_EXACT))


def merge(cursor: MatchCursor, seg: SegmentResult, *,
          tables: DeviceTables) -> MatchCursor:
    """Pure Eq. 8 composition: extend ``cursor`` by one matched segment.

    For every cursor lane state ``q``: look up ``q``'s lane in the segment's
    candidate row (``cand_index[seg.entry_class, q]``), take the segment's
    exit state there; a missing ``q`` is the pattern's absorbing sink; and a
    ``pad``-free empty segment passes the cursor through unchanged.  The
    composition itself is ``kernels.ref.cursor_merge_ref`` at batch size 1 —
    the numpy host reference of the device merge
    (``Matcher.advance_cursors`` runs the same composition batched on
    device; the scheduler's tick path never calls this function, see
    ``merge_calls``).
    """
    global _MERGE_CALLS
    _MERGE_CALLS += 1
    if seg.n_bytes == 0:
        return cursor
    if seg.entry_class == ENTRY_EXACT:
        if cursor.byte_count != 0:
            raise ValueError("an exact-entry segment only composes onto a "
                             "zero-byte cursor; match it with entry_class = "
                             "the cursor's last_class instead")
        lane_states = np.broadcast_to(
            seg.lane_states[:, :1], cursor.lane_states.shape).copy()
    else:
        if seg.entry_class != cursor.last_class:
            raise ValueError(
                f"segment keyed on class {seg.entry_class} cannot extend a "
                f"cursor whose last byte classified to {cursor.last_class}")
        lane_states = cursor_merge_ref(
            cursor.lane_states[None], seg.lane_states[None],
            np.array([seg.entry_class], np.int32),
            tables.tables.cand_index, tables.packed.sinks,
            pad_cls=tables.pad_key)[0]
    return MatchCursor(lane_states=lane_states,
                       entry_class=cursor.entry_class,
                       absorbed=tables.absorbing[lane_states].all(axis=1),
                       byte_count=cursor.byte_count + seg.n_bytes,
                       last_class=seg.last_class)
