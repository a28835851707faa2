"""Placements of parameters, optimizer state, batches and caches on an LM
mesh, and of the sharded matcher's operands on a ("doc", "chunk") mesh.

Each spec is a tuple of ``torch.distributed.tensor`` placements, one per
mesh dimension (``Shard(d)``: tensor dim ``d`` is split over that mesh
dimension; ``Replicate()``: every rank holds it whole), as
``distribute_tensor`` takes them.  Two mesh dimensions sharding one tensor
dim nest in mesh order (the JAX package's ``P(("pod", "data"))``).

The LM rules (``param_specs``, ``opt_state_specs``, ``batch_specs``,
``cache_specs``, ``state_specs``) are the JAX package's, divisibility-aware:
every rule degrades to replication for a dimension the mesh axis does not
divide, so one rule set serves all ten architectures and every mesh.
  * params: FSDP over "data" on the d_model-ish dim, TP over "model" on the
    heads/ff/vocab dim; MoE experts over "model" only (``models.moe``'s
    expert parallelism takes them so); pods replicate params (pure DP);
  * stacked layer/group leading dims (``STACK_KEYS``) are never sharded;
  * batches and caches: the batch dim over ("pod", "data").
They read only the mesh's axis names and extents (a ``launch.mesh
.MeshLayout`` will do).  ``model_heads``, ``model_vocab``, ``model_span``
and ``dp_rows`` say which heads, vocab rows, channels and batch rows a
rank computes with under them (the partitioned program of ``models`` and
``models.api``).  ``model_head_dim`` says which head_dim columns a rank computes with where
a layer's heads do not divide "model".  ``named`` pairs each spec with its mesh, as
``distributed.fault_tolerance.reshard_tree`` and ``training.checkpoint
.restore_checkpoint(shardings=)`` take them.

The sharded executor (``core.engine.sharded``) reads its splits from the
matcher functions through ``local_slices``, so the layout is stated once.
A legacy 1-D "data" mesh counts as pure chunk sharding (no doc axis).
"""

from __future__ import annotations

import math
from typing import Any

__all__ = ["param_specs", "opt_state_specs", "batch_specs", "cache_specs",
           "state_specs", "named", "shards_of", "local_block",
           "STACK_KEYS", "MOE_EXPERT_KEYS",
           "matcher_table_specs", "matcher_chunk_specs", "matcher_lane_specs",
           "doc_batch_spec", "local_slices", "leaf_placements",
           "param_keep", "model_heads", "model_head_dim", "model_vocab",
           "model_span", "dp_parts", "dp_rows"]

STACK_KEYS = {"layers", "groups", "enc", "dec"}
MOE_EXPERT_KEYS = {"wi_gate", "wi_up", "wo"}


def _placements_cls():
    from torch.distributed.tensor import Replicate, Shard
    return Replicate, Shard


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _split(mesh, doc_dim: int | None, chunk_dim: int | None) -> tuple:
    """One placement per mesh dim: tensor dim ``doc_dim`` over "doc",
    ``chunk_dim`` over "chunk" (or "data"); ``None`` replicates."""
    Replicate, Shard = _placements_cls()
    out = []
    for name in _names(mesh):
        dim = doc_dim if name == "doc" else (
            chunk_dim if name in ("chunk", "data") else None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


# -- the LM rules ------------------------------------------------------------

def _sizes(mesh) -> dict[str, int]:
    return {n: int(mesh.size(i)) for i, n in enumerate(_names(mesh))}


def _div(n: int, sizes: dict, axis: str) -> bool:
    return axis in sizes and n % sizes[axis] == 0 and n >= sizes[axis]


def _dp(sizes: dict) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _fsdp_axis(sizes, n: int):
    return "data" if _div(n, sizes, "data") else None


def _tp_axis(sizes, n: int):
    return "model" if _div(n, sizes, "model") else None


def _core_spec(name: str, shape: tuple, sizes: dict, in_moe: bool) -> tuple:
    """One entry per tensor dim: an axis name or None (the JAX package's
    ``_core_spec``, rule for rule)."""
    nd = len(shape)
    if in_moe and name in MOE_EXPERT_KEYS and nd == 3:
        return ("model" if _div(shape[0], sizes, "model") else None,
                None, None)
    if name == "router":
        return (None,) * nd
    if name == "table" and nd == 2:        # embedding [V, D]
        return (_tp_axis(sizes, shape[0]), _fsdp_axis(sizes, shape[1]))
    if name in ("wq", "wk", "wv") and nd == 3:   # [D, N|K, H]
        if _div(shape[1], sizes, "model"):
            return (_fsdp_axis(sizes, shape[0]), "model", None)
        if _div(shape[2], sizes, "model"):
            return (_fsdp_axis(sizes, shape[0]), None, "model")
        return (_fsdp_axis(sizes, shape[0]), None, None)
    if name == "wo" and nd == 3:                  # [N, H, D]
        if _div(shape[0], sizes, "model"):
            return ("model", None, _fsdp_axis(sizes, shape[2]))
        if _div(shape[1], sizes, "model"):
            return (None, "model", _fsdp_axis(sizes, shape[2]))
        return (None, None, _fsdp_axis(sizes, shape[2]))
    if nd == 2 and name in ("wi_gate", "wi_up", "wx", "wgate", "wz", "wi",
                            "wf", "wog", "wo_gate", "w"):
        # column-parallel [D_in, D_out]
        return (_fsdp_axis(sizes, shape[0]), _tp_axis(sizes, shape[1]))
    if nd == 2 and name in ("wo", "w_r", "w_i"):
        # row-parallel [D_inner, D_out]
        return (_tp_axis(sizes, shape[0]), _fsdp_axis(sizes, shape[1]))
    if nd == 2 and name == "conv_w":
        return (None, _tp_axis(sizes, shape[1]))
    if nd == 1:
        # vectors: shard large ones (rglru lam/bias) over model, keep norms
        if name in ("lam", "conv_b") and _div(shape[0], sizes, "model"):
            return ("model",)
        return (None,)
    return (None,) * nd


def _placements(entries: tuple, names: tuple) -> tuple:
    """Spec entries (an axis, a tuple of axes, or None per tensor dim) ->
    one placement per mesh dim."""
    Replicate, Shard = _placements_cls()
    out = []
    for name in names:
        dims = [d for d, e in enumerate(entries)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _stacked(names: list) -> bool:
    return any(k in STACK_KEYS for k in names[:-1])


def _leaf_entries(names: list, shape: tuple, sizes: dict) -> tuple:
    """The entries of a leaf at path ``names``: a stacked leaf's leading
    dim is never sharded."""
    name = names[-1] if names else ""
    in_moe = "moe" in names
    if _stacked(names):
        return (None, *_core_spec(name, tuple(shape[1:]), sizes, in_moe))
    return _core_spec(name, tuple(shape), sizes, in_moe)


def _shape(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(list(path), tree)


def param_specs(params: Any, mesh) -> Any:
    """The placements tree of a parameter tree (leaves: tensors, arrays or
    shape tuples, e.g. ``models.api.param_shapes``)."""
    sizes, names = _sizes(mesh), _names(mesh)
    return _map_paths(lambda path, leaf: _placements(
        _leaf_entries(path, _shape(leaf), sizes), names), params)


def opt_state_specs(params: Any, mesh) -> Any:
    """Adam m/v mirror the param sharding (ZeRO-style fully sharded
    states)."""
    return param_specs(params, mesh)


def _batch_axis(sizes: dict, n: int, batch: int):
    dp = _dp(sizes)
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    return dp if (n == batch and batch % max(dp_size, 1) == 0
                  and dp_size > 1) else None


def batch_specs(batch: Any, mesh, global_batch: int) -> Any:
    """Shard the leading batch dim over ("pod", "data") when divisible; a
    scalar (or a non-tensor such as a position) replicates."""
    sizes, names = _sizes(mesh), _names(mesh)

    def spec_of(_, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return _placements((), names)
        bs = _batch_axis(sizes, leaf.shape[0], global_batch)
        return _placements((bs,) + (None,) * (len(leaf.shape) - 1), names)

    return _map_paths(spec_of, batch)


def cache_specs(cache: Any, mesh, batch: int) -> Any:
    """KV caches [L, B, S, K, H]: batch over dp, heads (or head_dim) over
    model."""
    sizes, names = _sizes(mesh), _names(mesh)

    def spec_of(_, leaf):
        shape = _shape(leaf)
        if len(shape) != 5:
            return _placements((None,) * len(shape), names)
        _, b, _, k, h = shape
        bs = _batch_axis(sizes, b, batch)
        if _div(k, sizes, "model"):
            return _placements((None, bs, None, "model", None), names)
        if _div(h, sizes, "model"):
            return _placements((None, bs, None, None, "model"), names)
        return _placements((None, bs, None, None, None), names)

    return _map_paths(spec_of, cache)


def state_specs(state: Any, mesh, batch: int) -> Any:
    """Recurrent decode states: the batch dim over dp, the last
    model-divisible dim not already taken over model."""
    sizes, names = _sizes(mesh), _names(mesh)

    def spec_of(_, leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        for i, d in enumerate(shape):
            if _batch_axis(sizes, d, batch) is not None:
                spec[i] = _dp(sizes)
                break
        for i in range(len(shape) - 1, -1, -1):
            if spec[i] is None and _div(shape[i], sizes, "model"):
                spec[i] = "model"
                break
        return _placements(tuple(spec), names)

    return _map_paths(spec_of, state)


def named(tree_specs: Any, mesh) -> Any:
    """Each placements tuple of ``tree_specs`` as ``(mesh, placements)``."""
    if isinstance(tree_specs, dict):
        return {k: named(v, mesh) for k, v in tree_specs.items()}
    return (mesh, tree_specs)


def shards_of(placements: tuple, mesh) -> tuple[tuple[str, int], ...]:
    """``(axis, tensor dim)`` of each ``Shard`` placement, in mesh order."""
    _, Shard = _placements_cls()
    return tuple((n, p.dim) for n, p in zip(_names(mesh), placements)
                 if isinstance(p, Shard))


def local_block(x, placements: tuple, mesh):
    """This rank's block of ``x`` (a tensor every rank holds whole) under
    ``placements`` on ``mesh`` (a view)."""
    idx = local_slices(tuple(x.shape), placements, mesh.shape,
                       mesh.get_coordinate())
    return x[idx]


def leaf_placements(names: list, shape: tuple, mesh) -> tuple:
    """The placements of the parameter at path ``names`` with ``shape``; a
    leaf under a stack key is read as one stacked entry (its own shape,
    without the leading stack dim), as the initialisers draw them."""
    sizes = _sizes(mesh)
    name = names[-1] if names else ""
    if _stacked(names):
        entries = _core_spec(name, tuple(shape), sizes, "moe" in names)
    else:
        entries = _leaf_entries(names, shape, sizes)
    return _placements(entries, _names(mesh))


def param_keep(mesh):
    """A ``keep(path, leaf)`` for ``models.api.init``: this rank's block of
    each freshly drawn leaf under ``param_specs`` (a copy, so the whole
    leaf is freed)."""
    def keep(path, leaf):
        return local_block(leaf, leaf_placements(list(path),
                                                 tuple(leaf.shape), mesh),
                           mesh).clone()
    return keep


# -- what a rank computes with under the LM rules -----------------------------

def model_heads(n_heads: int, n_kv: int, model: int,
                rank: int) -> tuple[int, int, int, int] | None:
    """``(q0, nq, k0, nk)``: the query heads ``[q0, q0 + nq)`` that rank
    ``rank`` of a ``model``-way "model" axis computes where ``param_specs``
    splits ``wq`` on its heads, and the kv heads ``[k0, k0 + nk)`` they
    read (query head h reads kv head h // (n_heads // n_kv)).  ``None``
    where the rules keep the heads whole, or where a rank's query heads
    neither fill whole kv groups nor fall within one: the layer then
    computes every head on every rank."""
    if model <= 1 or n_heads % model or n_heads < model:
        return None
    nq = n_heads // model
    group = n_heads // n_kv
    q0 = rank * nq
    if nq % group == 0:
        return q0, nq, q0 // group, nq // group
    if group % nq == 0:
        return q0, nq, q0 // group, 1
    return None


def model_head_dim(n_heads: int, head_dim: int, model: int,
                   rank: int) -> tuple[int, int] | None:
    """``(h0, nh)``: the head_dim columns ``[h0, h0 + nh)`` of every head
    that rank ``rank`` of a ``model``-way "model" axis holds where
    ``param_specs`` splits an attention or mLSTM layer's ``wq``/``wk``/
    ``wv`` ``[D, N, H]`` and ``wo`` ``[N, H, D]`` on H: its ``n_heads``
    query heads do not divide the axis and ``head_dim`` does
    (``state_specs`` and ``cache_specs`` then split the layer's state and
    cache on their last dim the same way).  ``None`` where the rules split
    the heads, or keep the leaves whole."""
    if model <= 1 or (n_heads % model == 0 and n_heads >= model):
        return None
    return model_span(head_dim, model, rank)


def model_span(n: int, model: int, rank: int) -> tuple[int, int] | None:
    """``(i0, k)``: the entries ``[i0, i0 + k)`` of a dim of ``n`` that
    rank ``rank`` of a ``model``-way "model" axis holds where
    ``param_specs`` splits that dim over "model" (a column-parallel
    leaf's columns, a row-parallel one's rows: the RG-LRU's and the
    sLSTM's channels); ``None`` where the dim stays whole."""
    if model <= 1 or n % model or n < model:
        return None
    k = n // model
    return rank * k, k


def model_vocab(vocab: int, model: int, rank: int) -> tuple[int, int] | None:
    """``(v0, nv)``: the vocab rows ``[v0, v0 + nv)`` of the embedding (and
    columns of the head) that rank ``rank`` of a ``model``-way "model"
    axis holds under ``param_specs``; ``None`` where they stay whole."""
    return model_span(vocab, model, rank)


def dp_parts(mesh, batch: int) -> int:
    """Into how many parts ``batch_specs`` splits a batch of ``batch`` rows
    on ``mesh`` (the extent of ("pod", "data"), or 1 where it does not
    split them)."""
    sizes = _sizes(mesh)
    axes = _batch_axis(sizes, batch, batch)
    return 1 if axes is None else math.prod(sizes[a] for a in axes)


def dp_rows(mesh, batch: int) -> tuple[int, int] | None:
    """``(start, rows)``: this rank's rows of a batch of ``batch`` rows
    where ``batch_specs`` splits them over ("pod", "data") (``mesh`` an
    ``LMMesh``); ``None`` where every rank takes them all."""
    parts = dp_parts(mesh, batch)
    if parts == 1:
        return None
    rows = batch // parts
    return mesh.group_index(_dp(_sizes(mesh))) * rows, rows


# -- the matcher's operands --------------------------------------------------

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
    Replicate, Shard = _placements_cls()
    size = int(mesh.size())
    if size > 1 and batch % size == 0:
        return tuple(Shard(0) for _ in _names(mesh))
    return tuple(Replicate() for _ in _names(mesh))


def local_slices(shape, placements, mesh_shape, coord) -> tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``placements``:
    a ``Shard(d)`` on mesh dim ``i`` splits what is left of dim ``d`` into
    ``mesh_shape[i]`` equal parts (nested in mesh-dim order) and keeps part
    ``coord[i]``.  Uneven splits raise."""
    _, Shard = _placements_cls()
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
