"""Placements of the sharded matcher's operands on a ("doc", "chunk") mesh.

Each spec is a tuple of ``torch.distributed.tensor`` placements, one per
mesh dimension (``Shard(d)``: tensor dim ``d`` is split over that mesh
dimension; ``Replicate()``: every rank holds it whole), as
``distribute_tensor`` takes them.  The sharded executor
(``core.engine.sharded``) reads its splits from these functions through
``local_slices``, so the layout is stated once.  A legacy 1-D "data" mesh
counts as pure chunk sharding (no doc axis).

The LM half of the JAX package's module (``param_specs``,
``opt_state_specs``, ``batch_specs``, ``cache_specs``, ``state_specs``)
waits for ROADMAP A15.
"""

from __future__ import annotations

__all__ = ["matcher_table_specs", "matcher_chunk_specs", "matcher_lane_specs",
           "doc_batch_spec", "local_slices"]


def _placements():
    from torch.distributed.tensor import Replicate, Shard
    return Replicate, Shard


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _split(mesh, doc_dim: int | None, chunk_dim: int | None) -> tuple:
    """One placement per mesh dim: tensor dim ``doc_dim`` over "doc",
    ``chunk_dim`` over "chunk" (or "data"); ``None`` replicates."""
    Replicate, Shard = _placements()
    out = []
    for name in _names(mesh):
        dim = doc_dim if name == "doc" else (
            chunk_dim if name in ("chunk", "data") else None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def matcher_table_specs(mesh) -> dict[str, tuple]:
    """The packed matcher tables (``engine.plan.DeviceTables``) replicate on
    every rank: they are small and every lane reads them, so the sharded
    executor moves lane states, never tables."""
    rep = _split(mesh, None, None)
    return {name: rep for name in ("table_pad", "cand_pad", "cidx_pad",
                                   "starts", "sinks", "byte_to_class",
                                   "absorbing")}


def matcher_chunk_specs(mesh) -> tuple[tuple, tuple]:
    """(inputs, output) placements of the speculative exact-entry body.

    Inputs (chunk-major):
      chunks [C, B, Lmax]  C over "chunk", B over "doc"
      lookahead [C, B]     the same
      exact [C, B]         the same
      entry [B, K]         B over "doc"
    Output [B, K] finals, replicated: each doc shard folds its own rows after
    the lane states' all-gather over "chunk", then the rows are collected
    over "doc" once a tile (what a single controller's read of the sharded
    output does), so every rank returns the whole result.
    """
    chunked = _split(mesh, 1, 0)
    return ((chunked, chunked, chunked, _split(mesh, 0, None)),
            _split(mesh, None, None))


def matcher_lane_specs(mesh) -> tuple[tuple, tuple]:
    """(inputs, output) placements of the lane-plan (``ENTRY_LANES``) body,
    the streaming device merge: ``matcher_chunk_specs``' chunk operands plus
    the cursor lanes [B, K, S] and boundary classes [B], both B over "doc"
    (they ride their doc shard and never cross "chunk").  Output [B, K, S],
    replicated after the row collection over "doc"."""
    chunked = _split(mesh, 1, 0)
    rows = _split(mesh, 0, None)
    return ((chunked, chunked, chunked, rows, rows), _split(mesh, None, None))


def doc_batch_spec(mesh, batch: int) -> tuple:
    """Placements of a sequential-plan tile [B, ...]: short documents are
    independent rows, so B splits over both mesh axes jointly (doc-major:
    ``Shard(0)`` on each) when the mesh size divides it; otherwise every
    rank scans the whole tile (replicated)."""
    Replicate, Shard = _placements()
    size = int(mesh.size())
    if size > 1 and batch % size == 0:
        return tuple(Shard(0) for _ in _names(mesh))
    return tuple(Replicate() for _ in _names(mesh))


def local_slices(shape, placements, mesh_shape, coord) -> tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``placements``:
    a ``Shard(d)`` on mesh dim ``i`` splits what is left of dim ``d`` into
    ``mesh_shape[i]`` equal parts (nested in mesh-dim order) and keeps part
    ``coord[i]``.  Uneven splits raise."""
    _, Shard = _placements()
    start = [0] * len(shape)
    size = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = int(mesh_shape[i])
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {n} ranks")
            size[p.dim] //= n
            start[p.dim] += int(coord[i]) * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(start, size))
