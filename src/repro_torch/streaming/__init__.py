"""Streaming match runtime of the port: resumable cursors and the
out-of-order ingestion tier.

    cursor.py     ``MatchCursor`` / ``segment_result`` / ``merge`` — the pure
                  Eq. 8 composition that makes matching resumable, bit-
                  identical to one-shot matching under any segmentation.
                  ``merge`` is the host reference of the device merge
                  (``Matcher.advance_cursors``); ``merge_calls`` counts host
                  merges, and the streaming data paths leave it flat.
    session.py    ``StreamResult`` (a closed stream's decision) and
                  ``StreamSession``.
    ooo/          ``OooStreamMatcher``: segments arrive in any order, are
                  matched first as candidate-keyed maps and folded into the
                  exact cursor when gaps close (``Matcher.compose_lane_maps``).

Not ported yet (ROADMAP A8): the in-order ``StreamMatcher`` facade, the
micro-batch scheduler, fault injection, session checkpoints (and with them
``OooStreamMatcher.snapshot``/``restore``) and ``BlockedStreamMatcher``.
"""

from .cursor import (ENTRY_EXACT, MatchCursor, SegmentResult, counting_merges,
                     merge, merge_calls, open_cursor, open_lane_cursor,
                     reset_merge_calls, segment_result)
from .ooo import (OooIntegrityError, OooPolicy, OooStats, OooStream,
                  OooStreamMatcher, ReorderBufferFull, SequenceGapError,
                  segment_fingerprint)
from .session import StreamResult, StreamSession

__all__ = ["StreamSession", "StreamResult",
           "MatchCursor", "SegmentResult", "ENTRY_EXACT", "open_cursor",
           "open_lane_cursor", "segment_result", "merge", "merge_calls",
           "reset_merge_calls", "counting_merges",
           "OooStreamMatcher", "OooStream", "OooStats", "OooPolicy",
           "ReorderBufferFull", "SequenceGapError", "OooIntegrityError",
           "segment_fingerprint"]
