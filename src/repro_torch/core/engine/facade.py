"""``Matcher`` facade: one entry point over the plan/executor layers.

    Matcher(dfas)                    # fused CUDA kernels on the card
    Matcher(dfas, backend="local")   # torch-eager stages
    Matcher(dfas, device="cpu")      # either backend on CPU tensors (the
                                     # kernel lowering then runs the
                                     # kernels' plain versions)

Decisions are bit-identical to per-document sequential matching on every
backend.  The facade packs the patterns, owns a sticky-bucket ``Planner``
and a ``LocalExecutor``, packs bucket tiles on the host and scatters the
results back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..automata import DFA, PackedDFA, pack_dfas, packed_signature
from .executors import LocalExecutor
from .plan import (ENTRY_LANES, ENTRY_STARTS, ENTRY_STATES, DeviceTables,
                   Planner, next_pow2, resolve_device)

__all__ = ["BatchResult", "SegmentBatchResult", "CursorBatchResult",
           "Matcher", "BatchMatcher"]

BACKENDS = ("cuda", "local", "sharded")


@dataclasses.dataclass
class BatchResult:
    """Per-batch outcome of ``Matcher.membership_batch`` ([B, K] decisions
    plus per-document work-model quantities)."""

    accepted: np.ndarray        # [B, K] bool
    final_states: np.ndarray    # [B, K] int32 packed state ids
    work_parallel: np.ndarray   # [B] scalar-model work
    work_sequential: np.ndarray # [B] n * K
    time_steps: np.ndarray      # [B] lane-parallel matching steps
    bucket_calls: int           # device dispatches consumed by this batch
    early_exits: int = 0        # docs fully absorbed before their last symbol
    device_work: Optional[np.ndarray] = None  # sharded backend only

    @property
    def model_speedup(self) -> float:
        return float(self.work_sequential.sum()) / max(float(self.work_parallel.sum()), 1.0)

    @property
    def lane_speedup(self) -> float:
        return float(self.work_sequential.sum()) / max(float(self.time_steps.sum()), 1.0)


@dataclasses.dataclass
class SegmentBatchResult:
    """Outcome of ``Matcher.advance_segments`` (the streaming tick call)."""

    final_states: np.ndarray  # [B, K] int32 packed states after the segment
    absorbed: np.ndarray      # [B, K] bool
    lengths: np.ndarray       # [B] int64 segment byte lengths
    bucket_calls: int         # fused device dispatches consumed
    padded_rows: int          # batch_tile rows dispatched across all tiles
    early_exits: int          # segments retired by the absorbing early exit


@dataclasses.dataclass
class CursorBatchResult:
    """Outcome of ``Matcher.advance_cursors`` (the candidate-keyed tick)."""

    lane_states: np.ndarray   # [B, K, S] int32 composed cursor lanes
    absorbed: np.ndarray      # [B, K] bool — all lanes absorbing
    lengths: np.ndarray       # [B] int64 segment byte lengths
    bucket_calls: int         # fused device dispatches consumed
    padded_rows: int          # batch_tile rows dispatched across all tiles
    early_exits: int          # segments retired by the absorbing early exit


class Matcher:
    """Batched, multi-pattern membership over padded shape buckets.

    Parameters
    ----------
    source       : DFA | PackedDFA | sequence of DFA | one-block PatternSet.
    num_chunks   : uniform chunk count C per document.
    max_buckets  : lifetime compiled-shape budget for the speculative path.
    batch_tile   : fixed row count of every device call (rounded up to a
                   power of two).
    backend      : "cuda" (the fused kernels, default) | "local" (torch-eager
                   stages).
    early_exit_segments : absorbing-state early-exit granularity of the
                   eager scans (1 disables; pow2).
    lookahead_r  : boundary-key depth: 1 (Eq. 11), 2 (Eq. 13) or "auto".
    mesh, mesh_shape, devices, capacities, spec_m, calibrate : the sharded
                   backend's layout keywords; ``backend="sharded"`` is not
                   ported, and the single-device backends refuse them with
                   the reference's ``ValueError``.
    device       : where the tensors live; ``None`` is the CUDA card and
                   raises ``RuntimeError`` when there is none.
    """

    def __init__(self, source, *, num_chunks: int = 8, max_buckets: int = 2,
                 batch_tile: int = 64, backend: str = "cuda", mesh=None,
                 mesh_shape=None, devices: Optional[int] = None,
                 capacities: Optional[Sequence[float]] = None,
                 spec_m: int = 1, calibrate: bool = False,
                 early_exit_segments: int = 4,
                 lookahead_r: int | str = "auto", autotune: bool = False,
                 device=None):
        if backend == "pallas":
            raise ValueError("backend='pallas' is the TPU kernel backend; "
                             "the fused CUDA kernels are backend='cuda'")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
        if backend == "sharded":
            raise NotImplementedError("backend='sharded' is not ported yet "
                                      "(ROADMAP A14)")
        if autotune:
            raise NotImplementedError("autotune is not ported yet "
                                      "(ROADMAP A10)")
        # the sharded-only keywords, refused as the reference refuses them
        if capacities is not None:
            raise ValueError("capacities only apply to the sharded backend")
        if mesh is not None or mesh_shape is not None or devices is not None:
            raise ValueError("mesh/mesh_shape/devices only apply to the "
                             "sharded backend")
        if spec_m != 1:
            raise ValueError("spec_m only applies to the sharded backend")
        if calibrate:
            raise ValueError("calibrate only applies to the sharded "
                             "backend (single-device layouts are uniform)")
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        if max_buckets < 1:
            raise ValueError("max_buckets must be >= 1")
        if batch_tile < 1:
            raise ValueError("batch_tile must be >= 1")
        self.device = resolve_device(device)
        packed = self._pack_source(source)
        self.packed = packed
        self.backend = backend
        self.batch_tile = next_pow2(int(batch_tile))
        self._lookahead_r = lookahead_r  # swap_patterns rebuilds with it
        self.dev = DeviceTables.build(packed, lookahead_r=lookahead_r,
                                      device=self.device)
        self.pad_cls = self.dev.pad_cls
        self.planner = Planner(num_chunks=num_chunks, max_buckets=max_buckets)
        self.executor = LocalExecutor(
            self.dev, num_chunks=self.planner.num_chunks,
            use_kernel=(backend == "cuda"),
            early_exit_segments=early_exit_segments)
        self.n_devices = 1
        self.num_chunks = self.planner.num_chunks
        self.compose_calls = 0  # compose_lane_maps dispatches

    @staticmethod
    def _pack_source(source) -> PackedDFA:
        """Normalize every accepted pattern source to one ``PackedDFA``.

        A multi-block ``PatternSet`` is refused: one Matcher runs exactly
        one table (``core.engine.BlockedMatcher`` is the multi-block front
        end).
        """
        from ..patterns import PatternSet
        if isinstance(source, PatternSet):
            if source.n_blocks != 1:
                raise ValueError(
                    f"PatternSet has {source.n_blocks} blocks; a Matcher "
                    "runs exactly one — use core.engine.BlockedMatcher for "
                    "multi-block sets (or raise k_blk to cover all patterns)")
            return source.blocks[0]
        if isinstance(source, PackedDFA):
            return source
        if isinstance(source, DFA):
            return pack_dfas([source])
        return pack_dfas(list(source))

    def swap_patterns(self, source) -> bool:
        """Hot-swap the pattern tables in place; True iff anything changed.

        A table of equal content (``automata.packed_signature``) is a no-op
        and returns False.  On a real change the ``DeviceTables`` rebuild on
        ``self.device``, the planner keeps its sticky buckets (shapes survive
        the swap) and bumps ``table_epoch``, and the executor drops every
        lowering (``LaneExecutor.retable``): programs re-lower on the next
        dispatch.  ``BlockedMatcher.swap_patterns`` leaves unchanged blocks'
        matchers untouched; ``StreamMatcher.swap_patterns`` owns the cursor
        carry rules.
        """
        packed = self._pack_source(source)
        if packed_signature(packed) == packed_signature(self.packed):
            return False
        self.packed = packed
        self.dev = DeviceTables.build(packed, lookahead_r=self._lookahead_r,
                                      device=self.device)
        self.pad_cls = self.dev.pad_cls
        self.planner.table_epoch += 1
        self.executor.retable(self.dev)
        return True

    def classes(self, doc: bytes | np.ndarray) -> np.ndarray:
        """[L] int32 class ids of ``doc`` under the packed table."""
        return self.packed.classes_of(doc).astype(np.int32)

    def compose_lane_maps(self, lane_maps: np.ndarray,
                          entry_keys: np.ndarray) -> np.ndarray:
        """Fold B runs of candidate-keyed lane maps in ONE device dispatch.

        ``lane_maps [B, N, K, S]`` holds, per row, a run of transition maps
        (leftmost first — e.g. a stream's cursor broadcast to lane width
        followed by buffered segment maps); ``entry_keys [B, N]`` the
        boundary key selecting each map's Eq. 11 candidate entry row.
        Returns the ``[B, K, S]`` composition of every row — the
        out-of-order gap-close bulk path: one device call per batch of
        contiguous runs, not one compose per segment.  ``backend="cuda"``
        runs the compose kernel (``executor.compose_mode``: ``"carry"`` or
        ``"tree"``), ``"local"`` the log-depth torch scan;
        ``kernels.ref.spec_compose_lanes_ref`` is the sequential oracle.

        Keys equal to ``DeviceTables.pad_key`` compose as the identity, so
        ragged runs are padded on the right; element 0's key is never read.
        N is padded to a power of two here to bound the lowerings (cached
        per padded N).  ``compose_calls`` counts dispatches.

        All lowerings are bit-identical on real candidate lanes — the only
        lanes a consumer can address through ``cand_index``.  Pad lanes
        (filler states repeated to reach width S) hold evaluation-order-
        dependent passthrough values; see ``kernels.ops.spec_compose_lanes``.
        """
        k = self.packed.n_patterns
        s = self.tables.i_max
        lanes = np.ascontiguousarray(np.asarray(lane_maps, np.int32))
        if lanes.ndim != 4 or lanes.shape[2:] != (k, s):
            raise ValueError(f"lane_maps must be [B, N, {k}, {s}], "
                             f"got {lanes.shape}")
        b, n = lanes.shape[:2]
        keys = np.asarray(entry_keys, np.int32)
        if keys.shape != (b, n):
            raise ValueError(f"entry_keys must be [{b}, {n}], "
                             f"got {keys.shape}")
        pad_key = self.dev.pad_key
        if n and ((keys[:, 1:] < 0) | (keys[:, 1:] > pad_key)).any():
            raise ValueError("entry_keys[:, 1:] must be boundary keys in "
                             "[0, n_keys] (pad_key = identity)")
        if b == 0 or n == 0:
            return np.zeros((b, k, s), np.int32)
        if n == 1:
            return lanes[:, 0].copy()
        np2 = next_pow2(n)
        if np2 != n:
            lanes = np.concatenate(
                [lanes, np.zeros((b, np2 - n, k, s), np.int32)], axis=1)
            keys = np.concatenate(
                [keys, np.full((b, np2 - n), pad_key, np.int32)], axis=1)
        out = self.executor.compose_lane_maps(lanes, keys).cpu().numpy()
        self.compose_calls += 1
        return out

    # -- serving hook -------------------------------------------------------

    def advance_classes(self, states, classes) -> torch.Tensor:
        """Advance [B] packed states through [B, T] class columns.

        One ``table_pad[st, col]`` gather per column on ``self.device``
        (the JAX package's ``lax.scan``).  ``pad_cls`` columns are identity
        moves (the padded table's extra column), which is how callers encode
        "this position advances no DFA" — e.g. special tokens in
        grammar-constrained serving.  Returns [B] int32 on ``self.device``.
        """
        st = torch.as_tensor(states, dtype=torch.int32).to(self.device)
        cls = torch.as_tensor(classes, dtype=torch.int32).to(self.device)
        if cls.dim() != 2:
            raise ValueError("advance_classes expects [B, T] classes")
        table = self.dev.table_pad_t
        cls = cls.long()
        for j in range(cls.shape[1]):
            st = table[st.long(), cls[:, j]]
        return st

    # -- properties ---------------------------------------------------------

    @property
    def n_patterns(self) -> int:
        return self.packed.n_patterns

    @property
    def tables(self):
        """Packed lookahead tables (built lazily on first access)."""
        return self.dev.tables

    @property
    def trace_count(self) -> int:
        """Number of lane programs lowered so far."""
        return self.executor.traces

    # -- the one bucket-dispatch loop (every public path rides it) -----------

    @staticmethod
    def _as_arrays(docs) -> tuple[list[np.ndarray], np.ndarray]:
        arrs = [np.frombuffer(d, np.uint8)
                if isinstance(d, (bytes, bytearray))
                else np.asarray(d, np.uint8) for d in docs]
        return arrs, np.array([a.shape[0] for a in arrs], np.int64)

    def _dispatch(self, mplan, arrs, lengths, out, *, entry_mode: str,
                  entry: Optional[np.ndarray] = None,
                  entry_cls: Optional[np.ndarray] = None, tile_hook=None
                  ) -> tuple[int, int, int]:
        """Run every bucket tile of a ``MatchPlan`` through the lane program
        and scatter the results into ``out`` ([B, K] or [B, K, S]).
        Returns ``(bucket_calls, padded_rows, early_exits)``."""
        k = self.packed.n_patterns
        calls = rows = early = 0
        for bucket in mplan.buckets:
            spec = bucket.kind == "spec"
            layout = (self.planner.layout_for(bucket.chunk_len)
                      if spec else None)
            spec_r = (self.dev.spec_r if (spec or entry_mode == ENTRY_LANES)
                      else 1)
            lane = self.planner.lane_plan(bucket, entry=entry_mode,
                                          spec_r=spec_r)
            for lo in range(0, bucket.doc_idx.size, self.batch_tile):
                sel = bucket.doc_idx[lo:lo + self.batch_tile]
                n = sel.size
                buf = np.zeros((self.batch_tile, bucket.width), np.uint8)
                lens = np.zeros(self.batch_tile, np.int32)
                for r, i in enumerate(sel):
                    buf[r, :lengths[i]] = arrs[i]
                    lens[r] = lengths[i]
                if tile_hook is not None:
                    tile_hook(bucket, layout, sel, lens)
                ent = ecls = None
                if entry_mode == ENTRY_STATES:
                    # pad rows scan from the pattern starts (ignored)
                    ent = np.tile(self.packed.starts,
                                  (self.batch_tile, 1)).astype(np.int32)
                    ent[:n] = entry[sel]
                elif entry_mode == ENTRY_LANES:
                    # pad rows carry in-range lanes and the pad boundary key,
                    # which the merge composes as the identity
                    s = self.tables.i_max
                    ent = np.broadcast_to(
                        self.packed.starts.astype(np.int32)[None, :, None],
                        (self.batch_tile, k, s)).copy()
                    ent[:n] = entry[sel]
                    ecls = np.full(self.batch_tile, self.dev.pad_key,
                                   np.int32)
                    ecls[:n] = entry_cls[sel]
                res, pos = self.executor.run(lane, buf, lens, entry=ent,
                                             entry_classes=ecls)
                out[sel] = res.cpu().numpy()[:n]
                pos = pos.cpu().numpy()[:n]
                # a doc "exited early" if all its lanes hit absorbing states
                # before its real symbols ran out (spec positions are
                # chunk-local, so compare against the per-chunk fill)
                eff = (np.minimum(bucket.chunk_len, lengths[sel]) if spec
                       else lengths[sel])
                early += int((pos < eff).sum())
                calls += 1
                rows += self.batch_tile
        return calls, rows, early

    def membership_batch(self, docs: Sequence[bytes | np.ndarray]) -> BatchResult:
        """Match every doc against every packed pattern.

        ``docs`` is a ragged sequence of B byte strings / uint8 arrays; the
        [B, K] decisions are bit-identical to sequential matching.
        """
        b = len(docs)
        k = self.packed.n_patterns
        if b == 0:
            z = np.zeros(0, np.int64)
            return BatchResult(np.zeros((0, k), bool), np.zeros((0, k), np.int32),
                               z, z, z, 0)
        arrs, lengths = self._as_arrays(docs)
        plan = self.planner.plan(lengths)
        finals = np.tile(self.packed.starts, (b, 1)).astype(np.int32)
        steps = np.where(plan.spec_mask, 0, lengths)

        def account(bucket, layout, sel, lens):
            if bucket.kind == "spec":
                steps[bucket.doc_idx] = self.executor.steps_for(layout)

        calls, _, early = self._dispatch(plan, arrs, lengths, finals,
                                         entry_mode=ENTRY_STARTS,
                                         tile_hook=account)
        accepted = self.packed.accepting[finals]
        # lanes forces the lazy lookahead tables — only on speculative work
        lanes = k * self.tables.i_max if plan.spec_mask.any() else k
        work_par = np.where(plan.spec_mask, steps * lanes, lengths * k)
        return BatchResult(accepted, finals, work_par, lengths * k, steps,
                           calls, early_exits=early)

    def accepts_batch(self, docs: Sequence[bytes | np.ndarray]) -> np.ndarray:
        """[B, K] bool accept matrix (``membership_batch`` convenience)."""
        return self.membership_batch(docs).accepted

    # -- streaming hooks -----------------------------------------------------

    def advance_segments(self, segments: Sequence[bytes | np.ndarray],
                         entry_states: np.ndarray) -> SegmentBatchResult:
        """Advance B independent streams by one segment each, batched.

        ``entry_states [B, K]`` are each stream's exact packed states (the
        pattern starts for a fresh stream).  Results are bit-identical to
        matching each stream's concatenated bytes in one shot.
        """
        b = len(segments)
        k = self.packed.n_patterns
        entry = np.ascontiguousarray(np.asarray(entry_states, np.int32))
        if entry.shape != (b, k):
            raise ValueError(f"entry_states must be [{b}, {k}], "
                             f"got {entry.shape}")
        if b == 0:
            return SegmentBatchResult(entry.copy(), np.zeros((0, k), bool),
                                      np.zeros(0, np.int64), 0, 0, 0)
        arrs, lengths = self._as_arrays(segments)
        plan = self.planner.plan(lengths)
        finals = entry.copy()  # zero-length segments pass through unchanged
        calls, rows, early = self._dispatch(plan, arrs, lengths, finals,
                                            entry_mode=ENTRY_STATES,
                                            entry=entry)
        return SegmentBatchResult(final_states=finals,
                                  absorbed=self.dev.absorbing[finals],
                                  lengths=lengths, bucket_calls=calls,
                                  padded_rows=rows, early_exits=early)

    def advance_cursors(self, segments: Sequence[bytes | np.ndarray],
                        lane_states: np.ndarray,
                        last_classes: np.ndarray) -> CursorBatchResult:
        """Advance B candidate-keyed cursors by one segment each — the
        streaming device merge.

        ``lane_states [B, K, S]`` is each stream's cursor lane map and
        ``last_classes [B]`` its boundary key in ``[0, n_keys)`` (see
        ``DeviceTables.advance_key``).  Each bucket tile matches the
        segments candidate-keyed and composes the cursor lanes with the
        resulting segment maps on the device (``kernels.ref
        .cursor_merge_ref`` is the host reference).  Zero-length segments
        compose as the identity.
        """
        b = len(segments)
        k = self.packed.n_patterns
        s = self.tables.i_max
        lanes = np.ascontiguousarray(np.asarray(lane_states, np.int32))
        if lanes.shape != (b, k, s):
            raise ValueError(f"lane_states must be [{b}, {k}, {s}], "
                             f"got {lanes.shape}")
        last = np.asarray(last_classes, np.int32).reshape(-1)
        if last.shape != (b,):
            raise ValueError(f"last_classes must be [{b}], got {last.shape}")
        if b and ((last < 0) | (last >= self.dev.n_keys)).any():
            raise ValueError(
                "last_classes must be boundary keys in [0, n_keys); fresh "
                "streams (no usable history) have exact states — advance "
                "them with advance_segments")
        if b == 0:
            return CursorBatchResult(lanes.copy(), np.zeros((0, k), bool),
                                     np.zeros(0, np.int64), 0, 0, 0)
        arrs, lengths = self._as_arrays(segments)
        plan = self.planner.plan(lengths)
        out = lanes.copy()  # zero-length segments compose as the identity
        calls, rows, early = self._dispatch(plan, arrs, lengths, out,
                                            entry_mode=ENTRY_LANES,
                                            entry=lanes, entry_cls=last)
        return CursorBatchResult(lane_states=out,
                                 absorbed=self.dev.absorbing[out].all(axis=2),
                                 lengths=lengths, bucket_calls=calls,
                                 padded_rows=rows, early_exits=early)

    # -- introspection -------------------------------------------------------

    def perf_report(self) -> dict:
        """The lowering chosen per plan (compose lowerings included), the
        in-kernel early-exit skip count, the compose dispatch count, the
        resolved boundary-key depth and lane width (``None`` until the
        lookahead analysis has run).  Keys of features not ported yet keep
        ``None`` or 0."""
        rep: dict = {
            "backend": self.backend,
            "spec_r": None,
            "lane_width": None,
            "lowerings": {"|".join(map(str, key)): kind
                          for key, kind in
                          self.executor.lowering_kinds.items()},
            "kernel_skipped_steps": self.executor.kernel_skipped_steps(),
            "table_epoch": self.planner.table_epoch,
            "prefilter_skipped_blocks": None,
            "autotune": None,
            # which lowering compose_lane_maps (the OOO gap-close bulk path)
            # rode: "compose-kernel-{carry,tree}" on the cuda backend,
            # "compose-scan" on local; None until the first compose dispatch
            "compose_lowering": next(
                (kind for kind in self.executor.lowering_kinds.values()
                 if kind.startswith("compose")), None),
            "compose_calls": self.compose_calls,
            "retunes": 0,
            "traffic": None,
        }
        if "tables" in self.dev.__dict__:  # lookahead analysis already ran
            rep["spec_r"] = self.dev.spec_r
            rep["lane_width"] = self.dev.i_max
        return rep


class BatchMatcher(Matcher):
    """Compatibility shim: the pre-refactor batched engine constructor.

    ``use_kernel=True`` routes chunk matching + merge through the fused
    CUDA kernels (the ``cuda`` backend), ``False`` through the torch-eager
    stages (``local``); everything else is the facade.  Deprecated: new
    code constructs ``Matcher(..., backend=...)`` directly.
    """

    def __init__(self, source, *, num_chunks: int = 8, max_buckets: int = 2,
                 batch_tile: int = 64, use_kernel: bool = False,
                 device=None):
        import warnings
        warnings.warn("BatchMatcher is a compatibility shim; use "
                      "Matcher(..., backend='cuda'|'local') instead",
                      DeprecationWarning, stacklevel=2)
        super().__init__(source, num_chunks=num_chunks,
                         max_buckets=max_buckets, batch_tile=batch_tile,
                         backend="cuda" if use_kernel else "local",
                         device=device)
        self.use_kernel = bool(use_kernel)
