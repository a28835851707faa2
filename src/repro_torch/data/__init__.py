"""Data pipeline of the port: tokenizer, synthetic corpus, DFA filter,
packed loader (host numpy; the filter matches on the card)."""

from .corpus import (CorpusConfig, generate_bytes, generate_documents,
                     load_pattern_fixtures)
from .filter import CorpusFilter, FilterStats
from .loader import LoaderConfig, PackedBatcher, data_stream, host_shard
from .tokenizer import ByteTokenizer

__all__ = ["CorpusConfig", "generate_bytes", "generate_documents",
           "load_pattern_fixtures",
           "CorpusFilter", "FilterStats", "LoaderConfig", "PackedBatcher",
           "data_stream", "host_shard", "ByteTokenizer"]
