"""Mesh-sharded lowering: capacity-balanced matching on a (doc, chunk) mesh.

The paper's cloud result (288 EC2 cores) comes from two ingredients: split
the input across workers, and size each worker's share by its measured
matching capacity (Eq. 1, ``core.profiling.profile_workers``).  This
executor lowers the one ``LanePlan`` onto a 2-D ``("doc", "chunk")`` mesh
(``launch.mesh.make_matcher_mesh``) as one SPMD program per
rank: every rank constructs the same ``Matcher``, calls each method with the
same arguments in the same order, and returns the whole result.

  * the **chunk axis is split over "chunk"**: each rank scans its contiguous
    run of chunks x candidate lanes with kernel B6 (``kernels.ops
    .spec_match``, the gather route);
  * the **document axis is split over "doc"**: mesh row ``r`` owns tile
    row-block ``r``; only that block's bytes are uploaded and classified on
    the rank.  Capacity-weighted document placement
    (``plan.MeshLayout.tile_rows``) routes real documents to row-blocks on
    the host, so a slow row receives more zero-length pad rows;
  * chunk boundaries come from the planner's layout, uniform or weighted by
    the paper's Eqs. 2–7 per doc row-block (``plan.MeshLayout``), so a rank
    with twice the measured capacity scans twice the real symbols.  Each
    rank scans only as far as its own longest chunk;
  * ranks exchange **only the per-chunk lane states** (``[C_loc, B/Dd, K,
    S]`` int32, independent of chunk length) in one all-gather per tile
    **over "chunk"**; boundary keys and exact flags of all C chunks are
    computed on every rank from its own rows, so they never cross;
  * each doc shard folds its gathered lane states per document (Eq. 8) with
    kernel B3 (``ops.spec_compose_lanes``, the carry fold), starting at the
    row layout's last exact chunk (the ones before it are zero-length);
  * the folded rows of each doc shard are then **collected over "doc"**,
    once a tile: the counterpart of a single controller's read of the
    sharded output, and the only traffic on "doc".  Doc shards exchange
    nothing else, and document bytes never cross ranks.

Results are bit-identical to sequential matching for every mesh shape and
capacity profile.  On CPU tensors the same calls run the kernels' plain
versions (``kernels.ops``); no other route exists.  No lowering here exits
early: ``absorbed_pos`` is ``NO_EXIT`` for every spec row.

The **sequential plan** needs no exchange: short documents are independent
rows, so a tile splits over both mesh axes jointly
(``distributed.sharding.doc_batch_spec``), every rank scans ``B / D`` rows
and the rows are gathered over the whole mesh ("seq-sharded").  A tile the
mesh size does not divide runs whole on every rank ("seq-torch", the JAX
package's "seq-jnp" rule).

Transport: lane states and rows move through ``launch.mesh
.all_gather_rows`` (NCCL on the card, or gloo staged through host memory).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels import ops as kops
from .executors import NO_EXIT, LaneExecutor
from .plan import (ENTRY_LANES, ENTRY_STARTS, ChunkLayout, DeviceTables,
                   LanePlan, MeshLayout)

__all__ = ["ShardedExecutor"]


class ShardedExecutor(LaneExecutor):
    """The ("doc", "chunk") mesh lowering of one rank.

    Parameters
    ----------
    tables      : shared ``DeviceTables`` bundle, on this rank's device.
    num_chunks  : total chunk count C (a multiple of the mesh chunk extent;
                  the planner rounds up).
    mesh        : a mesh from ``launch.mesh.make_matcher_mesh``
                  (legacy 1-D "data" meshes count as doc extent 1); defaults
                  to a 1-D chunk mesh over the whole world.

    Lowering kinds: ``"spec-sharded"``, ``"seq-sharded"`` and
    ``"seq-torch"`` (a seq tile the mesh size does not divide).
    ``compose_lane_maps`` runs rank-locally (replicated) on the compose
    kernel of ``compose_mode``.
    """

    def __init__(self, tables: DeviceTables, *, num_chunks: int,
                 mesh=None, early_exit_segments: int = 4):
        super().__init__(tables, num_chunks=num_chunks,
                         early_exit_segments=early_exit_segments)
        from ...launch.mesh import (make_matcher_mesh, matcher_mesh_extents,
                                    mesh_transport)
        if mesh is None:
            mesh = make_matcher_mesh(device=tables.device)
        self.mesh = mesh
        self.doc_shards, self.chunk_shards = matcher_mesh_extents(mesh)
        names = tuple(mesh.mesh_dim_names)
        self.chunk_axis = "chunk" if "chunk" in names else "data"
        self.doc_axis = "doc" if "doc" in names else None
        self.devices = self.doc_shards * self.chunk_shards
        if self.num_chunks % self.chunk_shards != 0:
            raise ValueError(
                f"num_chunks={self.num_chunks} must be a multiple of the mesh "
                f"chunk extent {self.chunk_shards} (the planner rounds up "
                "for you)")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the matcher mesh")
        self.coord = tuple(int(x) for x in coord)
        self.mesh_shape = tuple(int(mesh.size(i)) for i in range(len(names)))
        self.row = self.coord[0] if self.doc_axis else 0
        self.col = self.coord[-1]
        self.transport = mesh_transport(mesh)
        # the gap-close fold's compose kernel, read when an N is first
        # lowered: "carry" (B3) or "tree" (B4), as on LocalExecutor
        self.compose_mode = "carry"
        # collectives issued so far, per axis ("chunk", "doc", "mesh")
        self.collectives = {"chunk": 0, "doc": 0, "mesh": 0}

    def _gather(self, x: torch.Tensor, axis: str | None) -> torch.Tensor:
        from ...launch.mesh import all_gather_rows
        self.collectives[axis or "mesh"] += 1
        return all_gather_rows(self.mesh, x, axis)

    def mesh_report(self) -> dict:
        """The mesh as ``Matcher.perf_report()["mesh"]`` shows it."""
        import torch.distributed as dist
        return {"shape": [self.doc_shards, self.chunk_shards],
                "transport": self.transport,
                "coordinate": [self.row, self.col],
                "rank": dist.get_rank(), "device": str(self.device),
                "collectives": dict(self.collectives)}

    # -- lowering dispatch ---------------------------------------------------

    def _plan_key(self, plan: LanePlan, batch: int) -> tuple:
        # seq programs split the tile rows (their form depends on the batch);
        # spec programs bake the layout's boundaries, so a rebalance
        # (layout_epoch) re-lowers them while seq entries survive
        if plan.kind == "seq":
            return plan.key + (batch,)
        return plan.key + (self.layout_epoch,)

    def _lower(self, plan: LanePlan, layout, batch: int):
        key = self._plan_key(plan, batch)
        if plan.kind == "seq":
            if self.devices == 1 or batch % self.devices != 0:
                self.lowering_kinds[key] = "seq-torch"
                return self._eager(self._seq_body, plan)
            self.lowering_kinds[key] = "seq-sharded"
            return self._lower_seq_sharded(plan, batch)
        self.lowering_kinds[key] = "spec-sharded"
        return self._lower_spec_sharded(plan, layout)

    # -- sequential plan: the tile's rows over the whole mesh ----------------

    def _lower_seq_sharded(self, plan: LanePlan, batch: int):
        """Each rank classifies and scans its ``B / D`` rows (entry states,
        or cursor lanes and boundary keys, split with them); one gather over
        the whole mesh returns every row, with its exit position."""
        from ...distributed.sharding import doc_batch_spec, local_slices

        rows = local_slices((batch,), doc_batch_spec(self.mesh, batch),
                            self.mesh_shape, self.coord)[0]
        body = self._eager(self._seq_body, plan)

        def run(bytes_buf, lengths, entry, entry_cls):
            out, pos = body(bytes_buf[rows], lengths[rows],
                            None if entry is None else entry[rows],
                            None if entry_cls is None else entry_cls[rows])
            n = out.shape[0]
            both = torch.cat([out.reshape(n, -1), pos.reshape(n, 1)], dim=1)
            both = self._gather(both, None)
            return (both[:, :-1].reshape(batch, *out.shape[1:]),
                    both[:, -1].contiguous())

        return run

    # -- speculative plan ----------------------------------------------------

    def _layout_rows(self, layout: ChunkLayout | MeshLayout
                     ) -> tuple[ChunkLayout, ...]:
        """Per-doc-shard row layouts; a plain ChunkLayout serves every row."""
        if isinstance(layout, MeshLayout):
            if layout.doc_shards != self.doc_shards:
                raise ValueError(f"layout has {layout.doc_shards} doc shards, "
                                 f"mesh has {self.doc_shards}")
            return layout.rows
        return (layout,) * self.doc_shards

    def _gather_maps(self, plan: LanePlan, row: ChunkLayout):
        """Static gather maps of this rank's chunks of one row layout (host,
        once a lowering): symbol columns ``[C_loc, L]`` (``L`` = the rank's
        longest chunk; column ``width`` is the identity pad slot), the r = 1
        and r = 2 boundary columns of all C chunks, their exact flags and
        the last exact chunk."""
        t = self.t
        w = plan.width
        c = row.num_chunks
        c_loc = c // self.chunk_shards
        mine = range(self.col * c_loc, (self.col + 1) * c_loc)
        sizes = row.sizes[list(mine)]
        lmax = int(max(sizes.max(), 1))
        span = np.arange(lmax)
        col_idx = np.full((c_loc, lmax), w, np.int64)
        for j, ci in enumerate(mine):
            s0, e0 = int(row.starts[ci]), int(row.ends[ci])
            col_idx[j] = np.where(span < e0 - s0, s0 + span, w)
        la_idx = np.full(c, w, np.int64)
        la2_idx = np.full(c, w, np.int64)
        for ci in range(c):
            s0 = int(row.starts[ci])
            if s0 > 0:
                la_idx[ci] = s0 - 1
            if s0 > 1:
                la2_idx[ci] = s0 - 2
            elif s0 == 1 and t.spec_r == 2:
                # ChunkLayout.MIN_CUT keeps interior cuts >= 2
                raise ValueError("spec_r=2 boundary keys need chunk cuts "
                                 ">= 2 symbols into the stream")
        exact = np.asarray(row.exact, bool)
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return (put(col_idx), put(la_idx), put(la2_idx),
                put(exact[list(mine)]), int(np.flatnonzero(exact).max()),
                slice(mine.start, mine.stop))

    def _lower_spec_sharded(self, plan: LanePlan,
                            layout: ChunkLayout | MeshLayout):
        """One program per bucket width and layout epoch: this rank's gather
        maps are built and uploaded here, once."""
        from ...distributed.sharding import (local_slices, matcher_chunk_specs,
                                             matcher_lane_specs)

        t = self.t
        k, s = t.n_patterns, t.i_max
        lanes_mode = plan.entry == ENTRY_LANES
        specs = (matcher_lane_specs if lanes_mode
                 else matcher_chunk_specs)(self.mesh)[0]
        row = self._layout_rows(layout)[self.row]
        col_idx, la_idx, la2_idx, exact_mine, e, mine = self._gather_maps(
            plan, row)
        c = row.num_chunks

        def run(bytes_buf, lengths, entry, entry_cls):
            b = bytes_buf.shape[0]
            if b % self.doc_shards:
                raise ValueError(f"batch of {b} rows does not split over "
                                 f"{self.doc_shards} doc shards (raise "
                                 "batch_tile to a doc-shard multiple)")
            # this rank's rows: the B axis of the chunk operands over "doc"
            rows = local_slices((c, b), specs[1], self.mesh_shape,
                                self.coord)[1]
            buf = self._put(bytes_buf[rows], torch.uint8)
            lens = self._put(lengths[rows])
            cls = F.pad(self._classify(buf, lens), (0, 1), value=t.pad_cls)
            chunks = cls[:, col_idx].transpose(0, 1).contiguous()
            la1 = cls[:, la_idx]                               # [B_loc, C]
            if t.spec_r == 2:
                la = torch.where(la1 == t.pad_cls,
                                 torch.full_like(la1, t.pad_key),
                                 cls[:, la2_idx] * t.pad_cls + la1)
            else:
                la = la1  # r=1: the key is the class (pad_cls == pad_key)
            cand = t.cand_pad_t[la[:, mine].long()]     # [B_loc, C_loc, K, S]
            if lanes_mode:
                ent = self._put(entry[rows])
                ecls = self._put(entry_cls[rows])
                seed = t.cand_pad_t[ecls.long()]
            else:
                e_rows = (t.starts_t[None].expand(cand.shape[0], -1)
                          if plan.entry == ENTRY_STARTS
                          else self._put(entry[rows]))
                seed = e_rows[:, :, None].expand(-1, -1, s)
            init = torch.where(exact_mine[None, :, None, None],
                               seed[:, None], cand)
            b_loc, c_loc = cand.shape[:2]
            init = init.transpose(0, 1).reshape(c_loc * b_loc, k * s)
            lv = kops.spec_match(t.table_pad_t,
                                 chunks.reshape(c_loc * b_loc, -1),
                                 init.contiguous(), use_mxu=False)
            # the only lane-state exchange, over "chunk": [C, B_loc * K * S]
            lv = self._gather(lv.reshape(c_loc, -1), self.chunk_axis)
            lv = lv[e:].reshape(c - e, b_loc, k, s).transpose(0, 1)
            if c - e > 1:
                seg = kops.spec_compose_lanes(
                    lv.contiguous(), la[:, e:].contiguous(), t.cidx_pad_t,
                    t.sinks_t, pad_key=t.pad_key, mode="carry")
            else:
                seg = lv[:, 0]
            out = (self._compose_cursor(ent, seg, ecls) if lanes_mode
                   else seg[:, :, 0])
            if self.doc_axis is not None:
                out = self._gather(out.contiguous(), self.doc_axis)
            return out, torch.full((b,), int(NO_EXIT), dtype=torch.int32,
                                   device=self.device)

        return run

    # -- the gap-close fold, rank-local --------------------------------------

    def compose_lane_maps(self, lane_maps, entry_keys) -> torch.Tensor:
        """The out-of-order gap-close fold, replicated on every rank (each
        folds the whole batch on its own device, nothing crosses ranks):
        ``kernels.ops.spec_compose_lanes`` in ``compose_mode``, kind
        ``"compose-kernel-{mode}"``, cached per ``("compose_kernel", N)``."""
        t = self.t

        def lower():
            mode = self.compose_mode
            return (f"compose-kernel-{mode}",
                    lambda lanes, keys: kops.spec_compose_lanes(
                        lanes, keys, t.cidx_pad_t, t.sinks_t,
                        pad_key=t.pad_key, mode=mode))

        return self._compose(("compose_kernel", int(lane_maps.shape[1])),
                             lower, lane_maps, entry_keys)

