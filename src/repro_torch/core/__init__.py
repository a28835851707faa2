"""Core library of the PyTorch port: the speculative parallel DFA
membership test (host compile layer in numpy, matching engine in torch)."""

from .automata import (DFA, NFA, PackedDFA, make_search_dfa, pack_dfas,
                       packed_from_arrays, packed_signature, random_dfa)
from .determinize import compile_prosite, compile_regex, minimize, nfa_to_dfa
from .engine import (BatchMatcher, BatchResult, BlockedMatcher, ChunkLayout,
                     CursorBatchResult, DeviceTables, Matcher, MatchPlan,
                     MatchResult, MeshLayout, Planner, SegmentBatchResult,
                     ShardedExecutor, SpecDFAEngine, match_chunks_lanes,
                     sequential_state)
from .lookahead import (LookaheadTables, PackedLookaheadTables,
                        build_lookahead_tables, build_packed_lookahead_tables,
                        i_max_r, i_sigma_sets)
from .lvector import merge_scan_torch
from .partition import Partition, capacity_weights, uniform_partition, weighted_partition
from .patterns import (PCRE_PATTERNS, PROSITE_PATTERNS, PatternSet,
                       compile_pattern_suite)
from .prefilter import Prefilter, required_literal, window_fingerprints
from .profiling import profile_capacity, profile_workers, synthetic_capacities
from .regex import parse_regex, prosite_to_regex, regex_to_nfa

__all__ = [
    "DFA", "NFA", "PackedDFA", "make_search_dfa", "pack_dfas",
    "packed_from_arrays", "packed_signature", "random_dfa",
    "compile_regex", "compile_prosite", "minimize", "nfa_to_dfa",
    "MatchResult", "BatchResult", "SegmentBatchResult", "CursorBatchResult",
    "SpecDFAEngine", "BatchMatcher", "Matcher", "BlockedMatcher",
    "MatchPlan", "Planner", "ChunkLayout", "MeshLayout", "DeviceTables",
    "ShardedExecutor",
    "match_chunks_lanes", "sequential_state", "merge_scan_torch",
    "LookaheadTables", "PackedLookaheadTables", "build_lookahead_tables",
    "build_packed_lookahead_tables", "i_max_r", "i_sigma_sets",
    "Partition", "capacity_weights", "uniform_partition", "weighted_partition",
    "PCRE_PATTERNS", "PROSITE_PATTERNS", "PatternSet",
    "compile_pattern_suite",
    "Prefilter", "required_literal", "window_fingerprints",
    "profile_capacity", "profile_workers", "synthetic_capacities",
    "parse_regex", "prosite_to_regex", "regex_to_nfa",
]
