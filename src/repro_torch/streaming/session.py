"""Stream sessions: the per-stream handle of the streaming match runtime.

A ``StreamSession`` is what ``StreamMatcher.open()`` returns — a resumable
cursor (``streaming.cursor.MatchCursor``) plus the session's slot in the
scheduler's admission queue.  Sessions are cheap (a few numpy scalars); a
serving tier holds one per live connection.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .cursor import MatchCursor

__all__ = ["StreamSession", "StreamResult"]


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Final outcome of a closed stream (mirrors one row of BatchResult)."""

    accepted: np.ndarray      # [K] bool per packed pattern
    final_states: np.ndarray  # [K] int32 packed states
    byte_count: int
    segments_fed: int         # feed() calls over the stream's lifetime

    def __bool__(self) -> bool:  # "did anything match?"
        return bool(self.accepted.any())


class StreamSession:
    """Handle for one open byte stream; all methods delegate to the owner.

    ``feed``/``close`` proxy ``StreamMatcher.feed``/``close`` so consumers
    can pass sessions around without the matcher.  ``states``/``accepted``
    read the cursor *as of the last tick* — call ``flush`` (or feed with
    ``flush=True``) first when the latest segment must be reflected.
    """

    __slots__ = ("sid", "owner", "cursor", "segments_fed", "closed",
                 "_pending", "_pending_since", "_pending_wall", "_evicted")

    def __init__(self, sid: int, owner, cursor: MatchCursor):
        self.sid = sid
        self.owner = owner
        self.cursor = cursor
        self.segments_fed = 0
        self.closed = False
        self._pending = bytearray()
        self._pending_since: int | None = None
        self._pending_wall: float | None = None  # max_delay_s admission stamp
        self._evicted = False  # counted once in SchedulerStats.evicted

    @property
    def pending_bytes(self) -> int:
        return len(self._pending)

    @property
    def byte_count(self) -> int:
        """Bytes absorbed into the cursor (excludes unflushed pending)."""
        return self.cursor.byte_count

    @property
    def states(self) -> np.ndarray:
        return self.cursor.states

    def accepted(self) -> np.ndarray:
        return self.cursor.accepted(self.owner.matcher.dev)

    def feed(self, data: bytes | np.ndarray, *, flush: bool = False) -> None:
        self.owner.feed(self, data, flush=flush)

    def close(self) -> StreamResult:
        return self.owner.close(self)
