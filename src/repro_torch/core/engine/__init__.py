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
                  ``advance_cursors``, ``compose_lane_maps``.
"""

from .executors import LaneExecutor, LocalExecutor, NO_EXIT
from .facade import (BatchResult, CursorBatchResult, Matcher,
                     SegmentBatchResult)
from .plan import (ENTRY_LANES, ENTRY_STARTS, ENTRY_STATES, BucketPlan,
                   ChunkLayout, DeviceTables, LanePlan, MatchPlan, Planner,
                   next_pow2, resolve_device)

__all__ = [
    "BatchResult", "SegmentBatchResult", "CursorBatchResult", "Matcher",
    "resolve_device", "Planner", "MatchPlan", "BucketPlan", "ChunkLayout",
    "DeviceTables", "LanePlan", "ENTRY_STARTS", "ENTRY_STATES", "ENTRY_LANES",
    "next_pow2", "LaneExecutor", "LocalExecutor", "NO_EXIT",
]
