"""Executor layer: one lane program, lowered per backend.

The planner describes the matching loop once as a ``LanePlan`` (classify ->
entry-seed -> chunk-scan -> merge); an executor lowers that plan to a
program on its ``DeviceTables`` device and runs it:

    run(plan, bytes_buf, lengths, *, layout=None, entry=None,
        entry_classes=None) -> (out, absorbed_pos)

Operands arrive as host numpy (``bytes_buf [B, W] uint8`` zero-padded,
``lengths [B]``, ``entry`` per ``plan.entry``: absent, exact ``[B, K]``
states, or ``[B, K, S]`` cursor lanes with ``entry_classes [B]`` boundary
keys) and are uploaded once per call; the results are device tensors
``(finals [B, K] | lanes [B, K, S], absorbed_pos [B])``.  ``absorbed_pos``
is the scan position (chunk-local for spec, stream for seq) at which every
lane of a document was absorbing, or ``NO_EXIT``.

``LocalExecutor`` holds the two lowerings of spec plans:

  * ``use_kernel=False`` — torch-eager stages, with the segmented
    absorbing-state early exit;
  * ``use_kernel=True``  — the fused CUDA kernels (``kernels.ops
    .spec_match_merge`` / ``spec_match_merge_lanes``) behind a host-side
    all-absorbed bucket check.  On CPU tensors the same lowering runs the
    kernels' plain versions.

Seq plans (documents shorter than ``4 * C``) are torch-eager in both.
``engine.sharded.ShardedExecutor`` is the ("doc", "chunk") mesh lowering
(own module); it alone reads ``layout``.

``compose_lane_maps`` (the out-of-order gap-close fold) runs the log-depth
torch scan ``core.lvector.merge_scan_lanes_torch`` in the eager lowering and
the compose kernels (``kernels.ops.spec_compose_lanes``, mode
``compose_mode``) in the kernel lowering.

While a torch profiler records, ``run`` is the range ``executor.run``
(``kernels.census_hooks.span``), a lowering made on a cache miss
``executor.lower``, and inside the kernel lowering and the eager bodies
``executor.upload`` (the operands' host-to-device copies),
``executor.stages`` (classify, boundary keys, candidate gather) and
``executor.launch`` (the kernel wrapper's call, or the eager scan and
merge).  Stages and launch time the host's side of work the device runs
asynchronously.
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np
import torch

from ...kernels import ops as kops
from ...kernels import ref as kref
from ...kernels.census_hooks import span
from ..lvector import merge_scan_lanes_torch
from .plan import ENTRY_LANES, ENTRY_STARTS, ENTRY_STATES, DeviceTables, LanePlan

__all__ = ["Executor", "LaneExecutor", "LocalExecutor", "NO_EXIT"]

NO_EXIT = np.int32(2 ** 30)  # absorbed_pos sentinel: never fully absorbed


class Executor(Protocol):
    """The one-method backend protocol: lower and run a ``LanePlan``."""

    traces: int

    def run(self, plan: LanePlan, bytes_buf: np.ndarray,
            lengths: np.ndarray, *, layout=None,
            entry: Optional[np.ndarray] = None,
            entry_classes: Optional[np.ndarray] = None
            ) -> tuple[torch.Tensor, torch.Tensor]: ...

    def steps_for(self, layout) -> int: ...


def _prev_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n.bit_length() - 1)


class LaneExecutor:
    """Shared lane-program stages plus the lowering cache.

    Subclasses override ``_lower`` (and ``_plan_key`` where a program
    depends on more than the plan, as the sharded backend's do).
    """

    def __init__(self, tables: DeviceTables, *, num_chunks: int,
                 early_exit_segments: int = 4):
        self.t = tables
        self.num_chunks = int(num_chunks)
        # segments must divide the pow2 scan widths -> round down to a pow2
        self.early_exit_segments = _prev_pow2(max(int(early_exit_segments), 1))
        self.traces = 0  # programs lowered so far
        self._lowered: dict[tuple, object] = {}
        # plan.key -> lowering name ("spec-kernel", "spec-torch", ...)
        self.lowering_kinds: dict[tuple, str] = {}
        # per-bucket kernel block sizes keyed by chunk_len (0 = default);
        # 512 when unset
        self.spec_l_blk: dict[int, int] = {}
        # bumped by invalidate_layouts() when chunk boundaries move (a
        # capacity rebalance); only lowerings that bake boundaries key on it
        self.layout_epoch = 0

    @property
    def device(self) -> torch.device:
        return self.t.device

    def _put(self, arr: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, dtype)

    # -- the one entry point ------------------------------------------------

    def run(self, plan: LanePlan, bytes_buf: np.ndarray, lengths: np.ndarray,
            *, layout=None, entry: Optional[np.ndarray] = None,
            entry_classes: Optional[np.ndarray] = None):
        with span("executor.run"):
            fn = self.lower(plan, layout=layout, batch=int(bytes_buf.shape[0]))
            return fn(bytes_buf, lengths, entry, entry_classes)

    def lower(self, plan: LanePlan, *, layout=None, batch: int = 0):
        """The program of one plan (cached; lowering happens once)."""
        key = self._plan_key(plan, batch)
        fn = self._lowered.get(key)
        if fn is None:
            with span("executor.lower"):
                fn = self._lower(plan, layout, batch)
            self._lowered[key] = fn
            self.traces += 1
        return fn

    def _plan_key(self, plan: LanePlan, batch: int) -> tuple:
        return plan.key

    def invalidate_layouts(self) -> None:
        """Signal that chunk boundaries moved (a capacity rebalance).

        Bumps ``layout_epoch`` instead of clearing the cache: lowerings
        that bake boundaries (the sharded spec lowering) key on the epoch
        and re-lower lazily; every other program survives.
        """
        self.layout_epoch += 1

    def _lower(self, plan: LanePlan, layout, batch: int):
        if plan.kind == "seq":
            self.lowering_kinds[plan.key] = "seq-torch"
            return self._eager(self._seq_body, plan)
        raise NotImplementedError("spec plans need a backend lowering")

    def invalidate_block_sizes(self) -> None:
        """Drop the programs that baked a ``spec_l_blk`` choice.

        The observed-traffic retune (``Matcher.maybe_retune``) updates
        ``spec_l_blk`` after construction; only the kernel lowerings read it
        (when a plan is lowered), so only entries whose kind starts with
        ``spec-kernel`` drop.  Seq scans, the eager spec stages and the
        compose lowerings keep their programs, and the new block takes
        effect on the next dispatch of each shape.
        """
        stale = [key for key, kind in self.lowering_kinds.items()
                 if kind.startswith("spec-kernel")]
        for key in stale:
            self._lowered.pop(key, None)
            self.lowering_kinds.pop(key, None)

    def retable(self, tables: DeviceTables) -> None:
        """Swap the matcher tables underneath the executor (the hot pattern
        swap, ``Matcher.swap_patterns``).

        The kernel lowering and the compose lowerings close over the *old*
        ``DeviceTables`` (``t = self.t``), so the whole cache drops and
        programs re-lower lazily against the new tables; the planner's
        bumped ``table_epoch`` is part of every later ``LanePlan.key``.
        ``traces`` keeps counting up, and the per-bucket ``spec_l_blk``
        choices survive (shapes, not tables).
        """
        self.t = tables
        self._lowered.clear()
        self.lowering_kinds.clear()

    def _eager(self, body, plan: LanePlan):
        """Upload the host operands and run a torch-eager stage body."""
        def fn(bytes_buf, lengths, entry, entry_cls):
            with span("executor.upload"):
                ops = (self._put(bytes_buf, torch.uint8), self._put(lengths),
                       None if entry is None else self._put(entry),
                       None if entry_cls is None else self._put(entry_cls))
            return body(plan, *ops)
        return fn

    def steps_for(self, layout) -> int:
        return layout.lmax  # lane-parallel wall steps = longest chunk buffer

    # -- stage: classify ----------------------------------------------------

    def _classify(self, bytes_buf: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
        """bytes [B, W] + lengths -> [B, W] class ids, pad_cls past the end."""
        return kref.classify_pad_ref(self.t.byte_to_class_t, bytes_buf,
                                     lengths, self.t.pad_cls)

    # -- stage: entry seed --------------------------------------------------

    def _seed_rows(self, plan: LanePlan, b: int, entry,
                   entry_cls) -> torch.Tensor:
        """Entry seed of sequential rows: [B, K] exact states, or [B, K, S]
        candidate lanes for lane plans."""
        if plan.entry == ENTRY_STARTS:
            return self.t.starts_t[None, :].expand(b, -1)
        if plan.entry == ENTRY_STATES:
            return entry
        return self.t.cand_pad_t[entry_cls.long()]

    def _seed_chunk0(self, plan: LanePlan, b: int, entry,
                     entry_cls) -> torch.Tensor:
        """Entry seed of spec chunk 0: [B, 1, K, S] lanes."""
        k, s = self.t.n_patterns, self.t.i_max
        if plan.entry == ENTRY_LANES:
            return self.t.cand_pad_t[entry_cls.long()][:, None]
        e = self._seed_rows(plan, b, entry, entry_cls)
        return e[:, None, :, None].expand(b, 1, k, s)

    # -- stage: chunk scan with absorbing-state early exit -------------------

    def _segmented_match(self, sym_t: torch.Tensor, states: torch.Tensor,
                         eff_len: torch.Tensor, scan_len: int,
                         early_exit: bool = True):
        """Scan ``states [R, N]`` through ``sym_t [R, L]`` symbol rows in
        segments, stopping once every document is done: all its lanes are
        absorbing, or the scan has passed its real symbols (``eff_len [B]``).

        Rows are doc-major (R = B * rows_per_doc).  Returns (final states,
        absorbed_pos [B]) with ``absorbed_pos`` the first segment boundary at
        which a document's lanes were all absorbing (``NO_EXIT`` otherwise).
        The stop test reads one flag back from the device per segment.
        """
        table = self.t.table_pad_t
        absorbing = self.t.absorbing_t.bool()
        b = eff_len.shape[0]
        segs = min(self.early_exit_segments if early_exit else 1, scan_len)
        pos = torch.full((b,), int(NO_EXIT), dtype=torch.int32,
                         device=states.device)
        if segs <= 1 or scan_len == 0:
            return kref.scan_lanes(table, sym_t, states), pos
        seg_len = scan_len // segs
        eff = eff_len.to(torch.int32)
        for g in range(segs):
            states = kref.scan_lanes(
                table, sym_t[:, g * seg_len:(g + 1) * seg_len], states)
            doc_abs = absorbing[states.long()].reshape(b, -1).all(dim=1)
            boundary = (g + 1) * seg_len
            pos = torch.where(doc_abs & (pos == int(NO_EXIT)),
                              torch.full_like(pos, boundary), pos)
            if bool((doc_abs | (boundary >= eff)).all()):
                break
        return states, pos

    # -- stage: device cursor merge (lane plans) -----------------------------

    def _compose_cursor(self, cursor_lanes: torch.Tensor,
                        seg_lanes: torch.Tensor,
                        entry_cls: torch.Tensor) -> torch.Tensor:
        """Eq. 8 composition of cursor lanes with a segment's lane map —
        bit-identical to ``kernels.ref.cursor_merge_ref``."""
        t = self.t
        return kref.compose_lanes_torch(cursor_lanes, seg_lanes, entry_cls,
                                        t.cidx_pad_t, t.sinks_t,
                                        pad_key=t.pad_key)

    # -- stage: bulk compose (the out-of-order gap-close path) ---------------

    def _compose(self, key: tuple, lower, lane_maps, entry_keys):
        """Run a compose lowering on uploaded operands.  ``lower()`` returns
        ``(kind, fn)`` and runs once per key."""
        fn = self._lowered.get(key)
        if fn is None:
            with span("executor.lower"):
                self.lowering_kinds[key], fn = lower()
            self._lowered[key] = fn
            self.traces += 1
        return fn(self._put(lane_maps), self._put(entry_keys))

    def compose_lane_maps(self, lane_maps, entry_keys) -> torch.Tensor:
        """Fold runs of candidate-keyed lane maps in one log-depth scan.

        ``lane_maps [B, N, K, S]`` + ``entry_keys [B, N]`` (host arrays) ->
        ``[B, K, S]`` compositions on the device (the last scan prefix) via
        ``lvector.merge_scan_lanes_torch``.  Keys equal to ``pad_key`` are
        right identities, so ragged runs arrive padded to a shared N; the
        lowering is cached per ``("compose_scan", N)``.
        """
        t = self.t

        def lower():
            return "compose-scan", lambda lanes, keys: merge_scan_lanes_torch(
                lanes, keys, t.cidx_pad_t, t.sinks_t, pad_key=t.pad_key,
                axis=1)[:, -1]

        return self._compose(("compose_scan", int(lane_maps.shape[1])),
                             lower, lane_maps, entry_keys)

    # -- seq body ------------------------------------------------------------

    def _seq_body(self, plan: LanePlan, bytes_buf, lengths, entry=None,
                  entry_cls=None):
        """Batched Algorithm 1: classify -> entry-seed -> scan."""
        b, w = bytes_buf.shape
        with span("executor.stages"):
            cls = self._classify(bytes_buf, lengths)
            rows = self._seed_rows(plan, b, entry, entry_cls).reshape(b, -1)
        with span("executor.launch"):
            finals, pos = self._segmented_match(cls, rows,
                                                lengths.clamp(max=w), w,
                                                early_exit=plan.early_exit)
            if plan.entry == ENTRY_LANES:
                seg = finals.reshape(b, self.t.n_patterns, self.t.i_max)
                return self._compose_cursor(entry, seg, entry_cls), pos
        return finals, pos

    # -- spec stage bodies (shared by the eager and kernel lowerings) --------

    def _spec_stages(self, plan: LanePlan, bytes_buf, lengths, entry,
                     entry_cls):
        """classify + chunking + entry-seed of the speculative path: returns
        (body [B, C, Lc] classes, la [B, C] boundary keys, init [B, C, K*S]
        lanes).

        Boundary keys follow ``DeviceTables.spec_r``: the class of the last
        byte before each chunk (r=1), or the pair key ``c_prev * n_classes +
        c_last`` (r=2).  Padding is a document suffix, so a padded last byte
        means the whole following chunk is padding: its key is ``pad_key``.
        """
        t = self.t
        b, w = bytes_buf.shape
        c = self.num_chunks
        lc = w // c
        k, s = t.n_patterns, t.i_max
        with span("executor.stages"):
            body = self._classify(bytes_buf, lengths).reshape(b, c, lc)
            last1 = body[:, :-1, -1]                           # [B, C-1]
            if t.spec_r == 2:
                if lc < 2:
                    raise ValueError(f"spec_r=2 boundary keys need "
                                     f"chunk_len >= 2, got {lc}")
                key = body[:, :-1, -2] * t.pad_cls + last1
                key = torch.where(last1 == t.pad_cls,
                                  torch.full_like(key, t.pad_key), key)
            else:
                key = last1  # r=1: the key is the class (pad_cls == pad_key)
            la = torch.cat([torch.zeros((b, 1), dtype=torch.int32,
                                        device=body.device), key], dim=1)
            cand = t.cand_pad_t[la[:, 1:].long()]              # [B, C-1, K, S]
            start = self._seed_chunk0(plan, b, entry, entry_cls)  # [B, 1, K, S]
            init = torch.cat([start, cand], dim=1).reshape(b, c, k * s)
            return body.contiguous(), la.contiguous(), init.contiguous()

    def _spec_body(self, plan: LanePlan, bytes_buf, lengths, entry=None,
                   entry_cls=None):
        """Eager classify/chunk/candidate-gather/match/merge of one bucket."""
        t = self.t
        b, w = bytes_buf.shape
        c = self.num_chunks
        lc = w // c
        k, s = t.n_patterns, t.i_max
        body, la, init = self._spec_stages(plan, bytes_buf, lengths, entry,
                                           entry_cls)
        with span("executor.launch"):
            lvecs, pos = self._segmented_match(body.reshape(b * c, lc),
                                               init.reshape(b * c, k * s),
                                               lengths.clamp(max=lc), lc,
                                               early_exit=plan.early_exit)
            lv = lvecs.reshape(b, c, k, s)
            if plan.entry == ENTRY_LANES:
                seg = kref.spec_merge_lanes_ref(lv, la, t.cidx_pad_t,
                                                t.sinks_t, pad_cls=t.pad_key)
                return self._compose_cursor(entry, seg, entry_cls), pos
            finals = kref.spec_merge_ref(lv, la, t.cidx_pad_t, t.sinks_t,
                                         pad_cls=t.pad_key)
        return finals, pos


class LocalExecutor(LaneExecutor):
    """Single-device lowering: torch-eager stages or the fused CUDA kernels.

    With ``use_kernel=True`` every spec plan — exact-entry and
    ``ENTRY_LANES`` — runs one fused kernel launch per bucket tile behind an
    all-absorbed bucket check made on the host; the kernel itself skips
    symbol blocks once a document's lanes all absorb (per-document skipped
    blocks drain via ``kernel_skipped_steps()``).
    """

    def __init__(self, tables: DeviceTables, *, num_chunks: int,
                 use_kernel: bool = False, early_exit_segments: int = 4,
                 compose_mode: str = "carry"):
        super().__init__(tables, num_chunks=num_chunks,
                         early_exit_segments=early_exit_segments)
        self.use_kernel = bool(use_kernel)
        # which compose kernel the gap-close fold rides: "carry" (B3, the
        # sequential fold) or "tree" (B4, the pairwise reduce); read when an
        # N is first lowered
        self.compose_mode = compose_mode
        # symbol blocks skipped by the in-kernel early exit: one device
        # counter, added to on the device with each launch
        self._skipped = torch.zeros((), dtype=torch.int64, device=self.device)

    def kernel_skipped_steps(self) -> int:
        """Total symbol blocks skipped by the in-kernel early exit so far
        (reading the counter synchronises with the device)."""
        return int(self._skipped)

    def compose_lane_maps(self, lane_maps, entry_keys) -> torch.Tensor:
        """The gap-close fold on the compose kernels when this executor runs
        the kernel lowering (``kernels.ops.spec_compose_lanes`` in
        ``compose_mode``, read at the first lowering of each
        ``("compose_kernel", N)``; kind ``"compose-kernel-{mode}"``); the
        eager scan otherwise.  Same contract as the base lowering."""
        if not self.use_kernel:
            return super().compose_lane_maps(lane_maps, entry_keys)
        t = self.t

        def lower():
            mode = self.compose_mode
            return (f"compose-kernel-{mode}",
                    lambda lanes, keys: kops.spec_compose_lanes(
                        lanes, keys, t.cidx_pad_t, t.sinks_t,
                        pad_key=t.pad_key, mode=mode))

        return self._compose(("compose_kernel", int(lane_maps.shape[1])),
                             lower, lane_maps, entry_keys)

    def _lower(self, plan: LanePlan, layout, batch: int):
        if plan.kind == "seq":
            return super()._lower(plan, layout, batch)
        if self.use_kernel:
            self.lowering_kinds[plan.key] = (
                "spec-kernel-lanes" if plan.entry == ENTRY_LANES
                else "spec-kernel")
            return self._lower_spec_kernel(plan)
        self.lowering_kinds[plan.key] = "spec-torch"
        return self._eager(self._spec_body, plan)

    def _lower_spec_kernel(self, plan: LanePlan):
        """Fused kernel lowering: bucket-level + in-kernel early exit.

        A bucket whose every row is already absorbed — or empty — cannot move
        any lane (absorbing states self-loop), so the entry states (or the
        caller's cursor lanes) return verbatim and nothing launches.  The
        test runs on the host from the host-side entry operands, so it costs
        no device round trip.  Otherwise one kernel launch runs the bucket
        tile, and its per-document skipped-block counts convert to
        ``absorbed_pos`` at block granularity.
        """
        t = self.t
        lanes_mode = plan.entry == ENTRY_LANES
        lc = plan.chunk_len
        l_blk, l_pad = kops._pad_to_block(
            lc, self.spec_l_blk.get(lc, self.spec_l_blk.get(0, 512)))
        l_blocks = l_pad // l_blk

        def run(bytes_buf, lengths, entry, entry_cls):
            b = bytes_buf.shape[0]
            if plan.entry == ENTRY_STARTS:
                e = np.broadcast_to(t.packed.starts, (b, t.n_patterns))
            else:
                e = entry
            doc_abs = t.absorbing[e].reshape(b, -1).all(axis=1)
            bucket_done = bool((doc_abs | (lengths <= 0)).all())
            if plan.early_exit and bucket_done:
                pos = np.where(doc_abs, 0, NO_EXIT).astype(np.int32)
                return self._put(e), self._put(pos)
            with span("executor.upload"):
                buf = self._put(bytes_buf, torch.uint8)
                lens = self._put(lengths)
                ent = None if entry is None else self._put(entry)
                ecls = None if entry_cls is None else self._put(entry_cls)
            body, la, init = self._spec_stages(plan, buf, lens, ent, ecls)
            fn = kops.spec_match_merge_lanes if lanes_mode else kops.spec_match_merge
            with span("executor.launch"):
                out, skipped, _ = fn(t.table_pad_t, body, init, la,
                                     t.cidx_pad_t, t.sinks_t, t.absorbing_t,
                                     pad_cls=t.pad_cls, pad_key=t.pad_key,
                                     early_exit=plan.early_exit, l_blk=l_blk)
            self._skipped += skipped.sum()
            if lanes_mode:
                out = self._compose_cursor(ent, out, ecls)
            if not plan.early_exit:
                pos = torch.full((b,), int(NO_EXIT), dtype=torch.int32,
                                 device=self.device)
            else:
                pos = torch.where(skipped > 0, (l_blocks - skipped) * l_blk,
                                  torch.full_like(skipped, int(NO_EXIT)))
            return out, pos

        return run
