"""Core library of the PyTorch port: the speculative parallel DFA
membership test (host compile layer in numpy, matching engine in torch)."""

from .automata import (DFA, NFA, PackedDFA, make_search_dfa, pack_dfas,
                       packed_from_arrays, packed_signature, random_dfa)
from .determinize import compile_prosite, compile_regex, minimize, nfa_to_dfa
from .engine import (BatchResult, ChunkLayout, CursorBatchResult,
                     DeviceTables, Matcher, MatchPlan, Planner,
                     SegmentBatchResult)
from .lookahead import (LookaheadTables, PackedLookaheadTables,
                        build_lookahead_tables, build_packed_lookahead_tables,
                        i_max_r, i_sigma_sets)
from .partition import Partition, capacity_weights, uniform_partition, weighted_partition
from .patterns import (PCRE_PATTERNS, PROSITE_PATTERNS, PatternSet,
                       compile_pattern_suite)
from .regex import parse_regex, prosite_to_regex, regex_to_nfa

__all__ = [
    "DFA", "NFA", "PackedDFA", "make_search_dfa", "pack_dfas",
    "packed_from_arrays", "packed_signature", "random_dfa",
    "compile_regex", "compile_prosite", "minimize", "nfa_to_dfa",
    "BatchResult", "SegmentBatchResult", "CursorBatchResult", "Matcher",
    "MatchPlan", "Planner", "ChunkLayout", "DeviceTables",
    "LookaheadTables", "PackedLookaheadTables", "build_lookahead_tables",
    "build_packed_lookahead_tables", "i_max_r", "i_sigma_sets",
    "Partition", "capacity_weights", "uniform_partition", "weighted_partition",
    "PCRE_PATTERNS", "PROSITE_PATTERNS", "PatternSet",
    "compile_pattern_suite",
    "parse_regex", "prosite_to_regex", "regex_to_nfa",
]
