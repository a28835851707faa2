"""Out-of-order ingestion tier: match first, sequence later.

Segments tagged ``(stream, seq_no)`` arrive in any order (multi-producer
shippers, retrying transports, cloud object notifications) and are matched
*immediately* as independent candidate-keyed ``[K, S]`` transition maps;
sequencing happens later, when gaps close, by folding contiguous runs of
buffered maps into the exact cursor through one compose dispatch
(``Matcher.compose_lane_maps``: the hand-written compose kernel on the
card, a log-depth torch scan on ``backend="local"``).  The result is
bit-identical to feeding the stream in order — Eq. 9 composition is
associative, so arrival order is a scheduling detail, not a semantic one.

Layers (bottom up):

  * ``fingerprint`` — composable Rabin fingerprints: duplicate-delivery
    dedup and a whole-stream equality witness;
  * ``buffer``      — bounded per-stream reorder buffer (``OooPolicy`` caps,
    ``ReorderBufferFull`` backpressure);
  * ``sequencer``   — frontier tracking + entry-key chain resolution;
  * ``matcher``     — the ``OooStreamMatcher`` front-end driving the engine
    (``advance_cursors`` / ``advance_segments`` / ``compose_lane_maps``);
  * ``checkpoint``  — snapshot/restore of cursors *and* the parked future.
"""

from .buffer import (BufferedSegment, OooIntegrityError, OooPolicy,
                     ReorderBuffer, ReorderBufferFull, SequenceGapError)
from .fingerprint import (FP_MOD, compose_fingerprints, segment_fingerprint)
from .matcher import OooStats, OooStream, OooStreamMatcher
from .sequencer import Sequencer

__all__ = [
    "OooStreamMatcher", "OooStream", "OooStats", "OooPolicy",
    "ReorderBuffer", "ReorderBufferFull", "BufferedSegment", "Sequencer",
    "OooIntegrityError", "SequenceGapError",
    "FP_MOD", "segment_fingerprint", "compose_fingerprints",
]
