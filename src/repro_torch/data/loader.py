"""Sharded, packed batch loader with capacity-weighted host partitioning.

The paper's load-balancing scheme (Eqs. 1, 5–7) applied to data ingestion:
host shards of the corpus byte stream are sized by profiled per-host
throughput weights, so heterogeneous fleets (mixed card generations, noisy
cloud VMs — the paper's EC2 scenario) finish their scan+tokenize work
simultaneously.  Re-partitioning on updated weights is the straggler
mitigation hook (distributed/fault_tolerance.StragglerPolicy).  Batches are
host numpy int32 ``{"tokens", "labels"}``; moving them to the card is the
train loop's work.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from ..core.partition import weighted_partition
from .filter import CorpusFilter
from .tokenizer import ByteTokenizer

__all__ = ["LoaderConfig", "host_shard", "PackedBatcher", "data_stream"]


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0


def host_shard(n_bytes: int, weights: Sequence[float], host_id: int,
               m: int = 1) -> tuple[int, int]:
    """[start, end) byte range for this host under capacity weights."""
    part = weighted_partition(n_bytes, np.asarray(weights, np.float64), m)
    return int(part.start[host_id]), int(part.end[host_id])


class PackedBatcher:
    """Pack variable-length documents into dense [B, T+1] token blocks."""

    def __init__(self, cfg: LoaderConfig, tokenizer: Optional[ByteTokenizer] = None):
        self.cfg = cfg
        self.tok = tokenizer or ByteTokenizer()
        self._buf: list[int] = []

    def add_document(self, doc: bytes) -> None:
        self._buf.extend(self.tok.encode(doc).tolist())

    def ready(self) -> bool:
        need = self.cfg.batch_size * (self.cfg.seq_len + 1)
        return len(self._buf) >= need

    def next_batch(self) -> dict:
        b, t = self.cfg.batch_size, self.cfg.seq_len
        need = b * (t + 1)
        chunk = np.asarray(self._buf[:need], np.int32).reshape(b, t + 1)
        del self._buf[:need]
        return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


def data_stream(docs, cfg: LoaderConfig,
                corpus_filter: Optional[CorpusFilter] = None) -> Iterator[dict]:
    """documents -> (optional DFA filter) -> packed batches."""
    batcher = PackedBatcher(cfg)
    source = corpus_filter.filter(docs) if corpus_filter else iter(docs)
    for doc in source:
        batcher.add_document(doc)
        while batcher.ready():
            yield batcher.next_batch()
