"""Paper baselines: the per-document speculative membership test, in PyTorch.

The single-document reference of the paper's algorithms (Algs. 1-3,
Eqs. 2-8, 11) and the Holub-Stekr baseline, on one device.  The public
``SpecDFAEngine`` shim (``engine/spec.py``) inherits it and delegates its
batched path to the ``Matcher`` facade.

Flow (Sec. 4.1 steps 2-4):

  1. partition the class stream into chunks,
  2. derive each chunk's reverse-lookahead class (last class of the previous
     chunk) and its candidate initial states (Eq. 11 tables),
  3. match all chunks x candidate lanes with the matcher (paper Listing 2),
  4. fold the compressed L-vectors from the known start state (Eq. 8), with
     the sink absorbing.

Partition models:

  * ``balanced`` (paper Eqs. 2-7): chunk 0 is ``m``x longer and is matched
    exactly (one state); the C-1 speculative chunks are equal-length.
  * ``uniform``: equal chunks, speculative lanes side by side.

Modes:
  * ``lookahead``  - paper Alg. 3 (I_max candidate lanes).      [default]
  * ``basic``      - paper Alg. 2 (all |Q| lanes, chunk 0 knows q0).
  * ``holub``      - Holub-Stekr [19] baseline: full [Q]->[Q] maps per chunk,
                     merged associatively; O(n|Q|/|P|) work.

The matcher callable is pluggable.  By default (``default_matcher``) it is
``kernels.ops.spec_match`` on a card, which runs the CUDA kernels (B6
gather, or B8 one-hot products + B7 composition where ``mxu_profitable``),
and ``match_chunks_lanes``, a torch gather loop, on the CPU.  On the card
``sequential_state`` is kernel B6 with one chunk and one lane.  The
work-model fields of ``MatchResult`` are host arithmetic and equal the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ...kernels import ops as kops
from ...kernels.ref import scan_lanes
from ..automata import DFA
from ..lookahead import LookaheadTables, build_lookahead_tables
from ..lvector import merge_scan_torch
from .plan import resolve_device

__all__ = ["MatchResult", "PaperSpecEngine", "sequential_state",
           "match_chunks_lanes", "default_matcher", "VPU_LANES", "MatcherFn"]

VPU_LANES = 1024  # the JAX package's lane constant: 8 x 128 int32 on a TPU core


@dataclasses.dataclass
class MatchResult:
    final_state: int
    accepted: bool
    work_parallel: int    # scalar-model: max symbols matched by any processor
    work_sequential: int  # n - the sequential matcher's symbol count
    time_steps: int       # lane-parallel model: wall-clock matching steps
    mode: str

    @property
    def model_speedup(self) -> float:
        """Scalar-work speedup proxy (the paper's time-unit model, Sec. 3)."""
        return self.work_sequential / max(self.work_parallel, 1)

    @property
    def lane_speedup(self) -> float:
        return self.work_sequential / max(self.time_steps, 1)


# --------------------------------------------------------------------------
# matchers
# --------------------------------------------------------------------------

def sequential_state(table: torch.Tensor, classes: torch.Tensor,
                     start) -> torch.Tensor:
    """Algorithm 1 matching loop: one table lookup per symbol -> 0-d int32.

    On a CUDA tensor this is kernel B6 with one chunk and one lane
    (``ops.spec_match(table, classes[None], start[None, None])``): the same
    function in one launch, where a per-symbol torch loop would launch once
    per symbol.  On the CPU it is a plain loop on the host.
    """
    start = torch.as_tensor(start, dtype=torch.int32, device=classes.device)
    if classes.device.type == "cuda":
        return kops.spec_match(table, classes.reshape(1, -1),
                               start.reshape(1, 1))[0, 0]
    rows = table.tolist()
    s = int(start)
    for c in classes.tolist():
        s = rows[s][c]
    return torch.tensor(s, dtype=torch.int32)


def match_chunks_lanes(table: torch.Tensor, chunk_classes: torch.Tensor,
                       init_states: torch.Tensor) -> torch.Tensor:
    """Vectorized matching of [C] chunks x [S] speculative lanes.

    chunk_classes: [C, L] int32;  init_states: [C, S] int32.  Returns final
    states [C, S]: one loop over L, each step a batched gather over every
    lane (the torch analogue of the AVX2 gather loop, Listing 2).
    """
    return scan_lanes(table, chunk_classes, init_states)


def _merge_compressed(start: int, lvecs: np.ndarray, cand_index: np.ndarray,
                      lookahead_cls: np.ndarray, sink: int) -> int:
    """Eq. 8 fold over compressed per-chunk results from a known start state.

    lvecs[i] holds chunk i's final state per candidate lane; lookahead_cls[i]
    selects the candidate list.  The carried state is always a candidate of
    the next chunk (Eq. 11) unless it is the absorbing sink.  A host loop
    over the chunks' results, copied off the device once.
    """
    s = int(start)
    for lv, la in zip(lvecs, lookahead_cls):
        if sink >= 0 and s == sink:
            continue
        lane = int(cand_index[la, s])
        s = (sink if sink >= 0 else 0) if lane < 0 else int(lv[lane])
    return s


def _merge_full(start: int, lvecs: np.ndarray) -> int:
    """Eq. 8 fold over full per-chunk maps (basic mode), on the host."""
    s = int(start)
    for lv in lvecs:
        s = int(lv[s])
    return s


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

MatcherFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def default_matcher(device: torch.device) -> MatcherFn:
    """The chunk matcher an engine on ``device`` uses when given none: the
    CUDA kernels (``kernels.ops.spec_match``) on a card, the torch gather
    loop ``match_chunks_lanes`` elsewhere.  Both give the same states."""
    return kops.spec_match if device.type == "cuda" else match_chunks_lanes


class PaperSpecEngine:
    """End-to-end speculative membership test for one DFA (paper reference).

    Parameters
    ----------
    dfa          : complete DFA (core.automata).
    num_chunks   : processor count P (defaults to 8).
    mode         : "lookahead" | "basic" | "holub".
    partition    : "balanced" (paper Eqs. 2-7) | "uniform" (SPMD lanes).
    weights      : optional per-processor capacity weights (Eq. 1).
    matcher      : optional replacement for the chunk matcher; by default
                   the CUDA kernels (``kernels.ops.spec_match``) on a card
                   and ``match_chunks_lanes`` on the CPU
                   (``default_matcher``).
    lookahead_r  : runtime lookahead depth, 1 or 2 (lookahead mode).
    device       : where the tables live and matching runs: the card
                   unless the caller names another (raises without one).
    """

    def __init__(self, dfa: DFA, *, num_chunks: int = 8, mode: str = "lookahead",
                 partition: str = "balanced", weights: Optional[np.ndarray] = None,
                 matcher: Optional[MatcherFn] = None, lookahead_r: int = 1,
                 device=None):
        if mode not in ("lookahead", "basic", "holub"):
            raise ValueError(f"unknown mode {mode!r}")
        if partition not in ("balanced", "uniform"):
            raise ValueError(f"unknown partition {partition!r}")
        if lookahead_r not in (1, 2):
            raise ValueError("runtime lookahead_r must be 1 or 2 (Sec. 4.3)")
        self.device = resolve_device(device)
        self.dfa = dfa
        self.mode = mode
        self.lookahead_r = lookahead_r if mode == "lookahead" else 1
        self.partition = "uniform" if mode == "holub" else partition
        self.num_chunks = int(num_chunks)
        self.weights = (np.ones(self.num_chunks) if weights is None
                        else np.asarray(weights, dtype=np.float64))
        if self.weights.shape != (self.num_chunks,):
            raise ValueError("weights must have one entry per chunk")
        self.tables: LookaheadTables = build_lookahead_tables(
            dfa, r=self.lookahead_r)
        self.matcher: MatcherFn = matcher or default_matcher(self.device)

        put = lambda x: torch.as_tensor(np.asarray(x, np.int32),
                                        device=self.device)
        self._table_t = put(dfa.table)
        self._cand_t = put(self.tables.candidates)
        self._all_states = torch.arange(dfa.n_states, dtype=torch.int32,
                                        device=self.device)

    # -- public API ---------------------------------------------------------

    @property
    def gamma(self) -> float:
        return self.tables.gamma

    @property
    def i_max(self) -> int:
        return self.tables.i_max

    @property
    def lanes_per_chunk(self) -> int:
        return self.dfa.n_states if self.mode in ("basic", "holub") else self.tables.i_max

    def classes(self, data: bytes | np.ndarray) -> np.ndarray:
        return self.dfa.classes_of(data).astype(np.int32)

    def membership_sequential(self, data: bytes | np.ndarray) -> MatchResult:
        return self._sequential(self.classes(data))

    def membership(self, data: bytes | np.ndarray) -> MatchResult:
        cls_np = self.classes(data)
        n = int(cls_np.shape[0])
        p = self.num_chunks
        m = self.lanes_per_chunk
        if p <= 1 or n < 4 * p:
            return self._sequential(cls_np)
        cls_t = torch.from_numpy(cls_np).to(self.device)
        if self.partition == "uniform":
            final, work, steps = self._run_uniform(cls_t)
        else:
            final, work, steps = self._run_balanced(cls_t, m)
        final_i = int(final)
        return MatchResult(final_i, bool(self.dfa.accepting[final_i]), work, n,
                           steps, self.mode)

    def accepts(self, data: bytes | np.ndarray) -> bool:
        return self.membership(data).accepted

    # -- partition bodies -----------------------------------------------------

    def _sequential(self, cls_np: np.ndarray) -> MatchResult:
        """The sequential matcher over a class stream (Algorithm 1)."""
        cls = torch.from_numpy(cls_np).to(self.device)
        final = int(sequential_state(self._table_t, cls, self.dfa.start))
        n = int(cls_np.shape[0])
        return MatchResult(final, bool(self.dfa.accepting[final]), n, n, n,
                           "sequential")

    def _run_balanced(self, cls: torch.Tensor, m: int) -> tuple[int, int, int]:
        """Paper Eqs. 2-7: exact chunk 0 of length ~m*L, C-1 speculative chunks.

        Speculative chunks are forced equal-length (L_spec) for the lane
        matcher; chunk 0 absorbs the rounding remainder.  With capacity
        weights w, L0 follows Eq. 5 with the w-weighted denominator.
        """
        n = cls.shape[0]
        p = self.num_chunks
        w = self.weights
        l0 = n * m / (w[0] * m + w[1:].sum())  # Eq. 5
        l_spec = max(1, int(np.floor(l0 / m * (w[1:].mean() if p > 1 else 1.0))))
        l_spec = min(l_spec, (n - 1) // max(p - 1, 1))
        l0_int = n - (p - 1) * l_spec
        if l0_int <= 0 or l_spec <= 0:
            seq = self._sequential(cls.cpu().numpy())
            return seq.final_state, seq.work_parallel, seq.time_steps

        head = cls[:l0_int]
        body = cls[l0_int:].reshape(p - 1, l_spec)
        final0 = sequential_state(self._table_t, head, self.dfa.start)

        la = torch.cat([cls[l0_int - 1:l0_int], body[:-1, -1]])
        if self.lookahead_r == 2:
            if l0_int < 2 or l_spec < 2:
                seq = self._sequential(cls.cpu().numpy())
                return seq.final_state, seq.work_parallel, seq.time_steps
            prev = torch.cat([cls[l0_int - 2:l0_int - 1], body[:-1, -2]])
            la = prev * self.dfa.n_classes + la
        cand, lanes = self._candidates(la, body.shape[0])
        lvecs = self.matcher(self._table_t, body, cand)  # [C-1, S]
        lv = lvecs.cpu().numpy()
        if self.mode == "basic":
            final = _merge_full(int(final0), lv)
        else:
            final = _merge_compressed(int(final0), lv,
                                      self.tables.cand_index,
                                      la.cpu().numpy(), self.dfa.sink)
        work = max(l0_int, l_spec * lanes)          # scalar-processor model
        steps = max(l0_int, l_spec)                 # lane-parallel model
        return final, work, steps

    def _run_uniform(self, cls: torch.Tensor) -> tuple[int, int, int]:
        n = cls.shape[0]
        c = self.num_chunks
        l = n // c
        body = cls[: l * c].reshape(c, l)

        if self.mode == "holub":
            q = self.dfa.n_states
            init = self._all_states.expand(c, q)
            maps = self.matcher(self._table_t, body, init)
            final = merge_scan_torch(maps)[-1][self.dfa.start]
            work, lanes = l * q, q
        else:
            la = torch.cat([torch.zeros(1, dtype=torch.int32,
                                        device=cls.device), body[:-1, -1]])
            if self.lookahead_r == 2:
                if l < 2:
                    seq = self._sequential(cls.cpu().numpy())
                    return seq.final_state, seq.work_parallel, l
                prev = torch.cat([torch.zeros(1, dtype=torch.int32,
                                              device=cls.device),
                                  body[:-1, -2]])
                la = prev * self.dfa.n_classes + la
            cand, lanes = self._candidates(la, c)
            # chunk 0 knows q0: all its lanes hold q0 (idle-lane duplicates)
            cand = cand.clone()
            cand[0] = self.dfa.start
            lv = self.matcher(self._table_t, body, cand).cpu().numpy()
            if self.mode == "basic":
                final = _merge_full(lv[0, self.dfa.start], lv[1:])
            else:
                final = _merge_compressed(lv[0, 0], lv[1:],
                                          self.tables.cand_index,
                                          la[1:].cpu().numpy(), self.dfa.sink)
            work = l * lanes

        if l * c < n:  # sequential tail for the remainder
            final = sequential_state(self._table_t, cls[l * c:], final)
            work += n - l * c
        return int(final), work, l + (n - l * c)

    def _candidates(self, la: torch.Tensor, c: int) -> tuple[torch.Tensor, int]:
        if self.mode == "basic":
            q = self.dfa.n_states
            return self._all_states.expand(c, q), q
        return self._cand_t[la.long()], self.tables.i_max
