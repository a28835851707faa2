"""``SpecDFAEngine`` - compatibility shim over the paper baselines + facade.

The single-document entry point of the paper's speculative matching.  It
holds no matching logic of its own: every per-document mode (lookahead /
basic / holub, balanced / uniform partitions, runtime r=2 lookahead) is
``engine.baselines.PaperSpecEngine``, inherited unchanged, and the batched
path delegates to the ``Matcher`` facade on the engine's device.

``sequential_state`` / ``match_chunks_lanes`` / ``VPU_LANES`` / ``MatcherFn``
re-export from ``baselines``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .baselines import (VPU_LANES, MatcherFn, MatchResult, PaperSpecEngine,
                        match_chunks_lanes, sequential_state)

__all__ = ["MatchResult", "SpecDFAEngine", "sequential_state",
           "match_chunks_lanes", "VPU_LANES", "MatcherFn"]


class SpecDFAEngine(PaperSpecEngine):
    """The paper engine's public name.

    Per-document methods (``membership``, ``membership_sequential``,
    ``accepts``) come from ``baselines.PaperSpecEngine`` verbatim;
    ``membership_batch`` is pure delegation to the ``Matcher`` facade.
    """

    _batch = None  # Matcher facade, built on first use

    def membership_batch(self, docs: Sequence[bytes | np.ndarray]):
        """Batched membership for many documents in few fused device calls.

        Pure delegation to ``Matcher(self.dfa, num_chunks=..., device=...)``:
        decisions are bit-identical to ``membership_sequential`` per
        document.  The batch path always partitions uniformly, regardless
        of this engine's ``partition`` setting.
        """
        if self._batch is None:
            from .facade import Matcher  # local import: facade layers on us
            self._batch = Matcher(self.dfa, num_chunks=self.num_chunks,
                                  device=self.device)
        return self._batch.membership_batch(docs)
