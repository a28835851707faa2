"""K-blocked pattern-set execution: ``BlockedMatcher``.

One ``Matcher`` runs one packed table; a ``BlockedMatcher`` fans a
``core.patterns.PatternSet`` out over one inner ``Matcher`` per block and
fans the per-block ``[B, k_blk]`` verdicts back into a single ``[B, K]``
result, re-offsetting final states by the set's global ``state_bases`` —
bit-identical to an unblocked ``pack_dfas`` over all K patterns (the packed
offsets are a plain cumsum, so block-local id + block base == global id).

Two things blocking buys:

* **Table memory scales linearly in blocks.**  Joint-alphabet refinement
  and padded lane tables grow super-linearly in K; 2048 patterns as 64
  blocks of 32 stay at the 32-pattern table size each (on the card: a
  shared-memory table per block) and dispatch the same bucket shapes.
* **Block-granular skipping and swapping.**  The required-literal prefilter
  (``core.prefilter``) gates whole blocks per document before any dispatch
  — a fully-gated block costs zero device calls (``prefilter_skipped_
  blocks``) and gated documents drop out of a block's tile batch.  And
  ``swap_patterns`` rebuilds only blocks whose content signature changed:
  unchanged blocks keep their inner Matcher — bucket lowerings, device
  tables, traces — verbatim.

Gated documents report ``accepted=False`` with ``final_states`` pinned at
the block's start states: the gate proves no pattern of the block can
match, and the (unreached) automaton position of a skipped run is defined
as "never left the start" rather than paying the scan to learn it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..patterns import PatternSet
from ..prefilter import Prefilter
from .facade import BatchResult, Matcher

__all__ = ["BlockedMatcher"]


class BlockedMatcher:
    """``Matcher``-shaped front end over a multi-block ``PatternSet``.

    ``source`` is a ``PatternSet`` or anything its constructor accepts
    (name->regex mapping, regex list, DFA list — then ``k_blk``/``search``
    apply).  ``prefilter=True`` builds the required-literal gate from the
    set's regexes; DFA-sourced patterns leave their block ungated.  All
    remaining keyword arguments go to every inner ``Matcher`` (``backend``
    — "cuda" by default, "local" for the torch-eager stages —,
    ``device``, ``num_chunks``, ``batch_tile``, ...), so all blocks share
    one bucket policy and their lowered shapes coincide; the inner matchers
    run on the card unless ``device`` says otherwise.
    """

    def __init__(self, source: Union[PatternSet, Sequence, dict], *,
                 k_blk: Optional[int] = None, search: bool = True,
                 prefilter: bool = True, **matcher_kwargs):
        if isinstance(source, PatternSet):
            if k_blk is not None and k_blk != source.k_blk:
                raise ValueError(f"k_blk={k_blk} conflicts with the "
                                 f"PatternSet's k_blk={source.k_blk}")
            self.pattern_set = source
        else:
            self.pattern_set = PatternSet(source, k_blk=k_blk or 32,
                                          search=search)
        self._matcher_kwargs = dict(matcher_kwargs)
        self.matchers: list[Matcher] = [
            Matcher(blk, **self._matcher_kwargs)
            for blk in self.pattern_set.blocks]
        self.prefilter: Optional[Prefilter] = (
            Prefilter.from_pattern_set(self.pattern_set) if prefilter
            else None)
        self.backend = self.matchers[0].backend
        self.batch_tile = self.matchers[0].batch_tile
        # gate accounting: whole block dispatches skipped (every doc of the
        # batch gated) and total (doc, block) pairs gated off
        self.prefilter_skipped_blocks = 0
        self.prefilter_gated_docs = 0

    # -- shape ---------------------------------------------------------------

    @property
    def n_patterns(self) -> int:
        return self.pattern_set.n_patterns

    @property
    def n_blocks(self) -> int:
        return self.pattern_set.n_blocks

    # -- matching ------------------------------------------------------------

    def can_match(self, docs: Sequence[bytes | np.ndarray]) -> np.ndarray:
        """[B, n_blocks] prefilter bits (all-True when the gate is off)."""
        arrs, lengths = Matcher._as_arrays(docs)
        if self.prefilter is None:
            return np.ones((len(arrs), self.n_blocks), dtype=bool)
        return self.prefilter.can_match(arrs, lengths)

    def membership_batch(self, docs: Sequence[bytes | np.ndarray]
                         ) -> BatchResult:
        """Match every doc against every pattern of every block ([B, K]).

        Ungated traffic is bit-identical to one unblocked ``Matcher`` over
        all K patterns; gated (doc, block) pairs are guaranteed non-matches
        reported at the block's start states (see module docstring).
        """
        b = len(docs)
        k = self.n_patterns
        ps = self.pattern_set
        if b == 0:
            z = np.zeros(0, np.int64)
            return BatchResult(np.zeros((0, k), bool),
                               np.zeros((0, k), np.int32), z, z, z, 0)
        arrs, lengths = Matcher._as_arrays(docs)
        can = (self.prefilter.can_match(arrs, lengths)
               if self.prefilter is not None
               else np.ones((b, ps.n_blocks), dtype=bool))
        accepted = np.zeros((b, k), dtype=bool)
        finals = np.zeros((b, k), dtype=np.int32)
        work_par = np.zeros(b, np.int64)
        work_seq = np.zeros(b, np.int64)
        steps = np.zeros(b, np.int64)
        calls = early = 0
        device_work = None
        for bi, m in enumerate(self.matchers):
            sl = ps.block_slice(bi)
            base = int(ps.state_bases[bi])
            # default every row to the start states; live rows overwrite
            finals[:, sl] = m.packed.starts[None, :] + base
            live = np.flatnonzero(can[:, bi])
            self.prefilter_gated_docs += b - live.size
            if live.size == 0:
                self.prefilter_skipped_blocks += 1
                continue
            res = m.membership_batch([arrs[i] for i in live])
            accepted[live, sl] = res.accepted
            finals[live, sl] = res.final_states + base
            # blocks dispatch back to back on the same devices, so the
            # model quantities accumulate (work) / sum (steps) per doc
            work_par[live] += res.work_parallel
            work_seq[live] += res.work_sequential
            steps[live] += res.time_steps
            calls += res.bucket_calls
            early += res.early_exits
            if res.device_work is not None:
                device_work = (res.device_work if device_work is None
                               else device_work + res.device_work)
        return BatchResult(accepted, finals, work_par, work_seq, steps,
                           calls, early_exits=early, device_work=device_work)

    def accepts_batch(self, docs: Sequence[bytes | np.ndarray]) -> np.ndarray:
        """[B, K] bool accept matrix across all blocks."""
        return self.membership_batch(docs).accepted

    # -- hot swap ------------------------------------------------------------

    def swap_patterns(self, source, *, k_blk: Optional[int] = None,
                      search: Optional[bool] = None) -> dict:
        """Swap the pattern set, rebuilding only changed blocks.

        Blocks are compared position-wise by content signature
        (``PatternSet.block_signatures``): an unchanged block keeps its
        inner ``Matcher`` object — lowerings, planner, traces —
        verbatim; a changed block swaps in place (``Matcher.swap_patterns``,
        which preserves bucket *shapes* but re-lowers against the new
        tables); new trailing blocks build fresh and removed ones drop.
        The prefilter rebuilds whenever it is enabled (literal tables are
        cheap; signatures are part of checkpoint identity).

        Returns ``{"reused": [block ids], "rebuilt": [block ids],
        "dropped": n}``.
        """
        if isinstance(source, PatternSet):
            ps = source
        else:
            ps = PatternSet(source,
                            k_blk=k_blk or self.pattern_set.k_blk,
                            search=self.pattern_set.search
                            if search is None else search)
        old_sigs = self.pattern_set.block_signatures
        reused: list[int] = []
        rebuilt: list[int] = []
        matchers: list[Matcher] = []
        for bi, blk in enumerate(ps.blocks):
            if bi < len(self.matchers):
                m = self.matchers[bi]
                if (bi < len(old_sigs)
                        and ps.block_signatures[bi] == old_sigs[bi]):
                    reused.append(bi)
                else:
                    m.swap_patterns(blk)
                    rebuilt.append(bi)
                matchers.append(m)
            else:
                matchers.append(Matcher(blk, **self._matcher_kwargs))
                rebuilt.append(bi)
        dropped = max(0, len(self.matchers) - ps.n_blocks)
        self.matchers = matchers
        self.pattern_set = ps
        if self.prefilter is not None:
            self.prefilter = Prefilter.from_pattern_set(ps)
        return {"reused": reused, "rebuilt": rebuilt, "dropped": dropped}

    # -- introspection -------------------------------------------------------

    def perf_report(self) -> dict:
        """Aggregate of the per-block ``Matcher.perf_report`` plus the gate
        counters (``prefilter_skipped_blocks`` is the headline: device
        dispatch groups that never ran because every doc was gated)."""
        return {
            "backend": self.backend,
            "n_patterns": self.n_patterns,
            "n_blocks": self.n_blocks,
            "k_blk": self.pattern_set.k_blk,
            "prefilter_skipped_blocks": self.prefilter_skipped_blocks,
            "prefilter_gated_docs": self.prefilter_gated_docs,
            "prefilter": repr(self.prefilter) if self.prefilter else None,
            "table_epochs": [m.planner.table_epoch for m in self.matchers],
            "blocks": [m.perf_report() for m in self.matchers],
        }

    def __repr__(self) -> str:
        return (f"BlockedMatcher(K={self.n_patterns}, "
                f"n_blocks={self.n_blocks}, backend={self.backend!r}, "
                f"prefilter={self.prefilter is not None})")
