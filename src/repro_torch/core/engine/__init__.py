"""Layered plan/executor matching runtime on PyTorch.

    plan.py       Planner layer: spec-vs-seq split, sticky shape buckets,
                  uniform chunk layouts, ``DeviceTables`` and the
                  ``LanePlan`` every lowering runs.  Pure numpy apart from
                  the device tables.
    executors.py  ``LaneExecutor`` stages (classify, entry seed, segmented
                  early-exit scan, cursor merge, bulk compose) and
                  ``LocalExecutor``: the torch-eager lowering and the CUDA
                  kernel lowering.
    facade.py     ``Matcher``: ``membership_batch``, ``advance_segments``,
                  ``advance_cursors``, ``compose_lane_maps``;
                  ``BatchMatcher`` compat shim.
    baselines.py  The paper's per-document engine (Sec. 4.1, Eqs. 2-8,
                  Alg. 2/3 + the Holub-Stekr baseline, ``sequential_state``
                  / ``match_chunks_lanes``) with a pluggable matcher.
    spec.py       ``SpecDFAEngine`` shim: per-document modes inherit the
                  baselines, batched matching delegates to the facade.
"""

from .baselines import PaperSpecEngine
from .executors import LaneExecutor, LocalExecutor, NO_EXIT
from .facade import (BatchMatcher, BatchResult, CursorBatchResult, Matcher,
                     SegmentBatchResult)
from .plan import (ENTRY_LANES, ENTRY_STARTS, ENTRY_STATES, BucketPlan,
                   ChunkLayout, DeviceTables, LanePlan, MatchPlan, Planner,
                   next_pow2, resolve_device)
from .spec import (VPU_LANES, MatcherFn, MatchResult, SpecDFAEngine,
                   match_chunks_lanes, sequential_state)

__all__ = [
    "MatchResult", "BatchResult", "SegmentBatchResult", "CursorBatchResult",
    "SpecDFAEngine", "PaperSpecEngine", "BatchMatcher", "Matcher",
    "sequential_state", "match_chunks_lanes", "VPU_LANES", "MatcherFn",
    "resolve_device", "Planner", "MatchPlan", "BucketPlan", "ChunkLayout",
    "DeviceTables", "LanePlan", "ENTRY_STARTS", "ENTRY_STATES", "ENTRY_LANES",
    "next_pow2", "LaneExecutor", "LocalExecutor", "NO_EXIT",
]
