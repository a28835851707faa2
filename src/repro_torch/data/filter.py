"""DFA corpus filtering — the paper's technique as a data-pipeline stage.

Quality/PII filtering of LM training corpora is regex scanning at TB scale:
exactly the "single long-running membership test" workload the paper targets.
``CorpusFilter`` compiles the block-list patterns to search DFAs; documents
are scanned either

  * **batched** (default, ``filter``/``scan_batch``): a whole document batch
    advances against *all* patterns in one fused device call per shape bucket
    via the packed-DFA ``Matcher`` (kernel B1 on the card) — lanes are
    chunks x candidates x patterns, and only one [B, K] decision array
    returns to the host; or
  * **per-document** (``document_ok``): each pattern's ``SpecDFAEngine`` runs
    in turn with an early exit on the first hit (remaining patterns are not
    scanned; ``FilterStats.patterns_scanned`` records how many were); on
    the card the engines match chunks with ``kernels.ops.spec_match`` (B6,
    or B8 + B7 where ``mxu_profitable``); or
  * **streaming** (``scan_stream``): documents arriving as interleaved byte
    chunks — a corpus being downloaded, log tails — are filtered *as the
    bytes land*: every open document rides a resumable cursor
    (``streaming.StreamMatcher``) and chunks from many documents coalesce
    into shared micro-batched device ticks.  Decisions are bit-identical to
    ``scan_batch`` on the assembled documents, and fully-matched documents
    stop being scanned at all (absorbed early exit).

At fleet scale the byte stream is split across hosts with the paper's
weighted partitioning (loader.py) and per-host scans use these engines.

A document is dropped when any pattern's search DFA reaches an accepting
(absorbing) state anywhere in the document.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

from ..core import (BlockedMatcher, Matcher, PatternSet, SpecDFAEngine,
                    compile_regex, make_search_dfa, pack_dfas)

__all__ = ["CorpusFilter", "FilterStats"]


@dataclasses.dataclass
class FilterStats:
    scanned: int = 0
    dropped: int = 0
    bytes_scanned: int = 0
    work_parallel: int = 0
    work_sequential: int = 0
    patterns_scanned: int = 0  # pattern engines actually run (early exit!)
    early_exits: int = 0       # per-doc path: scan stopped before the last
                               # pattern; batch path: docs retired by the
                               # absorbing-state early exit
    batch_calls: int = 0       # fused device dispatches used by the batch path
    time_steps: int = 0        # lane-parallel matching steps (batch path)

    @property
    def model_speedup(self) -> float:
        """Scalar-work speedup proxy (meaningful for the per-document path)."""
        return self.work_sequential / max(self.work_parallel, 1)

    @property
    def lane_speedup(self) -> float:
        """Lane-parallel model: symbols scanned per wall-clock matching step."""
        return self.work_sequential / max(self.time_steps, 1)


class CorpusFilter:
    """Block-list regex filter backed by the speculative DFA engine.

    ``num_chunks``/``mode``/``partition``/``lookahead_r`` configure the
    per-document engines; ``batch_tile``/``max_buckets``/``backend``/
    ``capacities``/``mesh``/``mesh_shape``/``devices`` configure the packed
    batch matcher facade (see ``core.engine.Matcher``: ``backend="cuda"``,
    the default, runs the fused kernels, ``"local"`` the torch-eager
    stages; ``backend="sharded"`` and the mesh keywords are not ported and
    raise as ``Matcher`` does).  ``device`` places the matcher and every
    engine: the card unless the caller names another.  Keep/drop decisions
    are [B] bool and bit-identical across backends and scan paths
    (``scan_batch`` / ``filter`` / ``scan_stream``).

    Large block lists ride the pattern-set scale tier: ``k_blk`` splits the
    K patterns into independently-determinized blocks behind a
    ``core.engine.BlockedMatcher`` (same [B, K] decisions, bounded
    per-block determinization) and ``prefilter`` gates whole blocks per
    batch by required-literal fingerprints — documents that cannot contain
    any of a block's literals never dispatch that block.  Both paths stay
    bit-identical on decisions; only the gated work is skipped.
    """

    def __init__(self, patterns: Iterable[str], *, num_chunks: int = 8,
                 mode: str = "lookahead", partition: str = "balanced",
                 lookahead_r: int = 1, batch_tile: int = 64,
                 max_buckets: int = 2, backend: str = "cuda",
                 capacities=None, mesh=None, mesh_shape=None,
                 devices=None, k_blk: int | None = None,
                 prefilter: bool = True, device=None):
        patterns = list(patterns)
        matcher_kwargs = dict(num_chunks=num_chunks, batch_tile=batch_tile,
                              max_buckets=max_buckets, backend=backend,
                              capacities=capacities, mesh=mesh,
                              mesh_shape=mesh_shape, devices=devices,
                              device=device)
        self.pattern_set: PatternSet | None = None
        if k_blk is not None and patterns:
            # PatternSet(search=True) compiles the identical search DFAs the
            # unblocked path builds below; reuse them for the per-doc engines
            self.pattern_set = PatternSet(patterns, k_blk=k_blk, search=True)
            self.dfas = list(self.pattern_set.dfas)
            self.batch = BlockedMatcher(self.pattern_set,
                                        prefilter=prefilter,
                                        **matcher_kwargs)
        else:
            self.dfas = [make_search_dfa(compile_regex(".*(" + pat + ")"))
                         for pat in patterns]
            # zero patterns = filter nothing, keep everything (no matcher)
            self.batch = (Matcher(pack_dfas(self.dfas), **matcher_kwargs)
                          if self.dfas else None)
        self.engines = [
            SpecDFAEngine(dfa, num_chunks=num_chunks, mode=mode,
                          partition=partition, lookahead_r=lookahead_r,
                          device=device)
            for dfa in self.dfas]
        self.stats = FilterStats()

    # -- per-document path (early exit across patterns) ---------------------

    def document_ok(self, doc: bytes) -> bool:
        self.stats.scanned += 1
        self.stats.bytes_scanned += len(doc)
        data = np.frombuffer(doc, np.uint8)
        hit = False
        for j, eng in enumerate(self.engines):
            res = eng.membership(data)
            self.stats.patterns_scanned += 1
            self.stats.work_parallel += res.work_parallel
            self.stats.work_sequential += res.work_sequential
            if res.accepted:
                hit = True
                if j < len(self.engines) - 1:
                    self.stats.early_exits += 1
                break
        if hit:
            self.stats.dropped += 1
        return not hit

    # -- batched path (all patterns at once, no per-doc sync) ---------------

    def scan_batch(self, docs: list[bytes]) -> np.ndarray:
        """[B] keep-mask for a document batch; one fused call per bucket.

        All K patterns are matched simultaneously (no early exit — the packed
        lanes cost the same whether or not an earlier pattern hit), so
        ``patterns_scanned`` grows by B * K.
        """
        if not docs:
            return np.zeros(0, dtype=bool)
        if self.batch is None:  # no patterns: keep everything
            self.stats.scanned += len(docs)
            self.stats.bytes_scanned += int(sum(len(d) for d in docs))
            return np.ones(len(docs), dtype=bool)
        res = self.batch.membership_batch(docs)
        hit = res.accepted.any(axis=1)
        self.stats.scanned += len(docs)
        self.stats.bytes_scanned += int(sum(len(d) for d in docs))
        self.stats.dropped += int(hit.sum())
        self.stats.patterns_scanned += len(docs) * self.batch.n_patterns
        self.stats.work_parallel += int(res.work_parallel.sum())
        self.stats.work_sequential += int(res.work_sequential.sum())
        self.stats.time_steps += int(res.time_steps.sum())
        self.stats.batch_calls += res.bucket_calls
        self.stats.early_exits += res.early_exits  # absorbing-state retires
        return ~hit

    def filter(self, docs: Iterable[bytes], *,
               batch_size: int = 64) -> Iterator[bytes]:
        """Stream kept documents, scanning in batches of ``batch_size``."""
        pending: list[bytes] = []
        for doc in docs:
            pending.append(doc)
            if len(pending) >= batch_size:
                for d, ok in zip(pending, self.scan_batch(pending)):
                    if ok:
                        yield d
                pending = []
        if pending:
            for d, ok in zip(pending, self.scan_batch(pending)):
                if ok:
                    yield d

    # -- streaming path (documents arrive as interleaved chunks) -------------

    def scan_stream(self, events, *, max_batch: int = 64,
                    max_delay: int = 8):
        """Filter documents that arrive as interleaved byte chunks.

        ``events`` yields ``(key, chunk)`` pairs: ``chunk`` is the next bytes
        of document ``key`` (documents interleave freely — concurrent
        downloads), and ``chunk=None`` marks the document complete.  Yields
        ``(key, keep)`` as each document completes; documents still open when
        ``events`` is exhausted are finalized in arrival order.

        Matching is resumable and micro-batched: chunks only *admit* work,
        and the tick policy (``max_batch`` pending documents, or a chunk
        waiting ``max_delay`` admission events) decides when one fused device
        round advances every pending document at once.  A document whose
        patterns have all absorbed (e.g. a block-list hit) stops being
        scanned entirely; its remaining bytes are only counted.
        """
        from ..streaming import (BlockedStreamMatcher, StreamMatcher,
                                 TickPolicy)

        if self.batch is None:  # no patterns: keep everything
            open_counts: dict = {}
            for key, chunk in events:
                if chunk is None:
                    self._stream_account(open_counts.pop(key, 0))
                    yield key, True
                else:
                    open_counts[key] = open_counts.get(key, 0) + len(chunk)
            for key, n in open_counts.items():
                self._stream_account(n)
                yield key, True
            return

        policy = TickPolicy(max_batch=max_batch, max_delay=max_delay)
        if self.pattern_set is not None:
            # blocked filter: one child StreamMatcher per block behind a
            # single session API, sharing the batch matcher's lowerings
            sm = BlockedStreamMatcher(self.batch, policy=policy)
        else:
            sm = StreamMatcher(self.batch, policy=policy)
        open_sessions: dict = {}
        # device ticks fire while events are consumed, so fold the scheduler
        # stats in even when the consumer abandons the generator early
        seen_skips = seen_calls = 0

        def sync_stats():
            nonlocal seen_skips, seen_calls
            self.stats.early_exits += sm.stats.absorbed_skips - seen_skips
            self.stats.batch_calls += sm.stats.bucket_calls - seen_calls
            seen_skips = sm.stats.absorbed_skips
            seen_calls = sm.stats.bucket_calls

        try:
            for key, chunk in events:
                if chunk is None:
                    sess = open_sessions.pop(key, None) or sm.open()
                    yield key, self._stream_close(sm, sess)
                else:
                    sess = open_sessions.get(key)
                    if sess is None:
                        sess = open_sessions[key] = sm.open()
                    sess.feed(chunk)
            for key, sess in open_sessions.items():
                yield key, self._stream_close(sm, sess)
        finally:
            sync_stats()

    def _stream_account(self, n_bytes: int) -> None:
        self.stats.scanned += 1
        self.stats.bytes_scanned += n_bytes

    def _stream_close(self, sm, sess) -> bool:
        res = sm.close(sess)
        hit = bool(res.accepted.any())
        self.stats.scanned += 1
        self.stats.bytes_scanned += res.byte_count
        self.stats.dropped += int(hit)
        self.stats.patterns_scanned += self.batch.n_patterns
        self.stats.work_parallel += res.byte_count * self.batch.n_patterns
        self.stats.work_sequential += res.byte_count * self.batch.n_patterns
        return not hit
