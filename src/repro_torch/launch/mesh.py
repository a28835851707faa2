"""Meshes over ``torch.distributed``: one SPMD program a rank.

Every rank of the world calls each function with the same arguments in the
same order, and each rank returns the whole result unless a function says
it returns a shard.  A mesh is an ``LMMesh`` (``make_mesh``, the
counterpart of ``jax.make_mesh``): named axes over the first ranks of the
world, row-major, with a process group for every combination of axes, all
created with the mesh (group creation is collective and must happen in the
same order on every rank, so meshes are cached by shape and names).  Each
collective of those groups fails after ``GROUP_TIMEOUT`` instead of waiting
for a dead rank.

  * The sharded matching backend (``core.engine.sharded``) runs on a
    ("doc", "chunk") mesh (``make_matcher_mesh``) and moves lane states and
    rows with ``all_gather_rows``.
  * The LM runs on ("data", "model") or ("pod", "data", "model")
    (``make_production_mesh``, ``make_local_mesh``).

Transport.  The world's backend decides it (``_transport``): NCCL where
each rank has its own card (``init_process_group("nccl")``), gloo on the
CPU and where ranks share one card (NCCL refuses two ranks on one device).
A mesh keeps every tensor on the rank's own device (``LMMesh.device``).
Its collectives (``all_gather``, ``all_reduce``, ``reduce_scatter``,
``all_to_all``, its uneven ``all_to_all_v``, ``permute``) take the
tensors where they are; over gloo a
device tensor is staged through host memory (copied to the host,
exchanged, copied back), over NCCL the exchange runs on the card.  A
collective over an axis of one rank moves nothing.  The collectives inside
a differentiated region are ``torch.autograd.Function``s whose backward is
the adjoint collective (``gather_shards``, ``split``, ``gather``,
``exchange``, ``exchange_v``, ``sum_grads``, ``reduce_parts``,
``scatter_parts``, ``replica_mean``).  Tensor parallelism over "model" takes four of them:
``sum_grads`` at a column-parallel product's input (identity forward, sum
backward), ``reduce_parts`` at a row-parallel product's output (sum
forward, identity backward), ``scatter_parts`` where that output stays
split over the ranks' channels (reduce-scatter forward, all-gather
backward) and ``gather`` of a vocab-parallel product's slices.
``MESH_STATS`` counts each collective's calls and bytes (and its
host-clock seconds while ``time_collectives(True)``) and keeps its largest
call's bytes.

Without an initialised world, a mesh of one device initialises a world of
one (a ``file://`` store in a temporary directory: NCCL on a card, gloo on
the CPU), so ``Matcher(dfas, backend="sharded")`` works in a plain script.

A world of torch's ``fake`` backend (``launch.dryrun``: 256 or 512 ranks in
one process, ``FakeStore``) carries meshes too: its transport is "fake",
whose collectives move nothing, and a mesh on it takes the device its
caller names without asking for a card.  Every collective is also counted
in the census being taken, if any (``launch.census``).
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import census_hooks as _hooks

__all__ = ["make_matcher_mesh", "factor_matcher_mesh", "matcher_mesh_extents",
           "dp_axes", "mesh_info", "rank_device", "mesh_transport",
           "mesh_coordinate", "mesh_group", "all_gather_rows",
           "GROUP_TIMEOUT", "MeshLayout", "LMMesh", "make_mesh",
           "make_production_mesh", "make_local_mesh", "all_gather",
           "all_reduce", "reduce_scatter", "all_to_all", "all_to_all_v",
           "permute", "gather_shards", "split", "gather", "exchange",
           "exchange_v", "sum_grads",
           "reduce_parts", "scatter_parts", "replica_mean", "MESH_STATS",
           "reset_mesh_stats", "time_collectives", "lm_mesh_of",
           "whole_on_host", "barrier"]

# how long a collective of the groups this module creates may wait for its
# peers before it fails (a dead or diverged rank raises instead of hanging)
GROUP_TIMEOUT = datetime.timedelta(seconds=300)

# the concatenating all-gather (renamed ``all_gather_single`` in newer torch)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def factor_matcher_mesh(devices: int) -> tuple[int, int]:
    """Auto-factor a device count into a near-square (doc, chunk) shape.

    The doc extent is the largest divisor of ``devices`` at most
    ``sqrt(devices)`` and the chunk extent takes the rest: 8 -> 2x4,
    16 -> 4x4, 6 -> 2x3, primes -> 1xN.
    """
    if devices < 1:
        raise ValueError("devices must be >= 1")
    doc = max(d for d in range(1, math.isqrt(devices) + 1) if devices % d == 0)
    return doc, devices // doc


def rank_device(device=None) -> torch.device:
    """The device this rank computes on.  ``None`` is card ``LOCAL_RANK %
    device_count`` (so ranks of one host spread over its cards, and share
    card 0 on a one-card host); a CUDA device where there is none raises
    ``RuntimeError``."""
    from ..core.engine.plan import resolve_device
    if device is not None:
        return resolve_device(device)
    dev = resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count()) \
        if dev.type == "cuda" else dev


def _init_world_of_one(device: torch.device) -> None:
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    atexit.register(shutil.rmtree, tmp, True)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="file://"
                            + os.path.join(tmp, "store"), rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT)


def _fake_world() -> bool:
    """Whether the world is torch's ``fake`` backend (a dry run)."""
    return dist.is_initialized() and str(dist.get_backend()) == "fake"


def _transport(device: torch.device) -> str:
    backend = str(dist.get_backend())
    if device.type == "cuda" and "nccl" in backend:
        return "nccl"
    if "gloo" in backend:
        return "gloo"
    if backend == "fake":
        return "fake"
    raise ValueError(f"the world's backend {backend!r} cannot carry a "
                     f"mesh on {device}: initialise it with 'nccl' "
                     "(one card a rank) or 'gloo' (the CPU, or ranks sharing "
                     "a card)")


def make_matcher_mesh(devices: int | None = None, *,
                      shape: tuple[int, int] | str | None = None,
                      device=None) -> "LMMesh":
    """("doc", "chunk") mesh over the world's ranks (``make_mesh``).

    The speculative path gathers lane states over "chunk" and collects each
    tile's rows over "doc" (see ``core.engine.sharded``).  ``devices`` is
    how many ranks the mesh uses (default: the whole world).

    shape=None         -> (1, D): every rank on the chunk axis.
    shape="auto"       -> ``factor_matcher_mesh``: near-square, 8 -> 2x4.
    shape=(doc, chunk) -> explicit extents (``devices`` may be omitted).

    Call it on every rank with the same arguments (SPMD); only the mesh's
    ranks go on to construct the matcher.  ``device`` is this rank's device
    (``rank_device``).
    """
    n_avail = dist.get_world_size() if dist.is_initialized() else 1
    d = n_avail if devices is None else int(devices)
    if shape is None:
        doc, chunk = 1, d
    elif shape == "auto":
        doc, chunk = factor_matcher_mesh(d)
    else:
        doc, chunk = int(shape[0]), int(shape[1])
        if devices is not None and doc * chunk != d:
            raise ValueError(f"mesh shape {doc}x{chunk} does not use "
                             f"devices={d}")
    if doc < 1 or chunk < 1:
        raise ValueError(f"mesh extents must be >= 1, got {doc}x{chunk}")
    mesh = make_mesh((doc, chunk), ("doc", "chunk"), device=device)
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the "
                         f"{doc}x{chunk} mesh; only its ranks construct the "
                         "matcher")
    return mesh


def matcher_mesh_extents(mesh) -> tuple[int, int]:
    """(doc, chunk) extents of a matcher mesh; a 1-D "data" mesh counts as
    (1, data)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "chunk" in names:
        doc = mesh.size(names.index("doc")) if "doc" in names else 1
        return int(doc), int(mesh.size(names.index("chunk")))
    if "data" in names:
        return 1, int(mesh.size(names.index("data")))
    raise ValueError(f"not a matcher mesh (axes {names}); expected "
                     "('doc', 'chunk') from launch.mesh.make_matcher_mesh")


def mesh_transport(mesh) -> str:
    """"nccl", "gloo" or "fake": how the mesh's collectives travel."""
    return mesh.transport


def mesh_coordinate(mesh) -> tuple[int, int]:
    """This rank's (doc, chunk) coordinate; (0, c) on a 1-D mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return (0, int(coord[0])) if len(coord) == 1 else (int(coord[0]),
                                                       int(coord[1]))


def mesh_group(mesh):
    """The process group over all of the mesh's ranks (row-major order)."""
    return mesh.get_group(mesh.mesh_dim_names)


def all_gather_rows(mesh, x: torch.Tensor,
                    axis: str | None = None) -> torch.Tensor:
    """All-gather ``x`` along its first dimension over one mesh axis
    (``"doc"``, ``"chunk"``) or, with ``axis=None``, over the whole mesh
    (``all_gather``); the result is in mesh order, on ``x``'s device."""
    return all_gather(x, mesh, mesh.mesh_dim_names if axis is None else axis)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present in this mesh (pod first)."""
    return tuple(a for a in ("pod", "data")
                 if a in tuple(mesh.mesh_dim_names or ()))


def mesh_info(mesh) -> dict:
    names = tuple(mesh.mesh_dim_names or ())
    shape = dict(zip(names, (int(mesh.size(i)) for i in range(len(names)))))
    return {
        "axes": shape,
        "n_devices": int(mesh.size()),
        "dp": int(math.prod(shape[a] for a in dp_axes(mesh))),
        "tp": int(shape.get("model", 1)),
    }


# --------------------------------------------------------------------------
# Meshes: ("doc", "chunk"), ("data", "model") and ("pod", "data", "model")
# --------------------------------------------------------------------------

class MeshLayout:
    """A mesh's axis names and extents, and nothing else: what the sharding
    rules (``distributed.sharding``) read, so they can be asked about a
    (2, 16, 16) mesh without 512 ranks.  ``mesh_dim_names``, ``shape``,
    ``ndim`` and ``size`` read as a ``DeviceMesh``'s do."""

    def __init__(self, shape, names):
        if len(tuple(shape)) != len(tuple(names)):
            raise ValueError(f"mesh shape {tuple(shape)} and names "
                             f"{tuple(names)} differ in length")
        self.mesh_dim_names = tuple(names)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    def size(self, mesh_dim: int | None = None) -> int:
        return math.prod(self._shape) if mesh_dim is None \
            else self._shape[mesh_dim]

    def axis_size(self, axes) -> int:
        """The product of the extents of ``axes`` (a name or names) present
        in the mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self._shape[self.mesh_dim_names.index(a)]
                         for a in axes if a in self.mesh_dim_names)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}("
                f"{dict(zip(self.mesh_dim_names, self._shape))})")


class LMMesh(MeshLayout):
    """A mesh over ranks of the world (one SPMD program a rank): the LM's
    and the sharded matcher's.

    ``ranks`` is the grid of global ranks (row-major), ``device`` this
    rank's device, ``transport`` "nccl" or "gloo".  ``group(axes)`` is the
    process group of the ranks that share this rank's coordinate on every
    other axis (all of them were created with the mesh, collectively);
    ``submesh(axes)`` is the mesh those ranks form along ``axes`` alone.
    A rank of the world outside the mesh holds the object too (it took
    part in creating the groups) but has no coordinate and no groups.
    """

    def __init__(self, ranks: np.ndarray, names, device: torch.device,
                 transport: str, groups: dict):
        super().__init__(ranks.shape, names)
        self.ranks = ranks
        self.device = device
        self.transport = transport
        self._groups = groups            # frozenset of names -> group
        me = dist.get_rank()
        where = np.argwhere(ranks == me)
        self._coord = tuple(int(c) for c in where[0]) if len(where) else None
        self._device_mesh = None

    @property
    def mesh(self) -> torch.Tensor:
        return torch.from_numpy(self.ranks.astype(np.int32))

    def get_coordinate(self):
        return None if self._coord is None else list(self._coord)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh lacks)."""
        if self._coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {self!r}")
        if axis not in self.mesh_dim_names:
            return 0
        return self._coord[self.mesh_dim_names.index(axis)]

    def group_index(self, axes) -> int:
        """This rank's index in ``group(axes)`` (row-major over ``axes``)."""
        axes = self._axes(axes)
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.coordinate(a)
        return idx

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.mesh_dim_names if a in axes)

    def group(self, axes):
        """The process group along ``axes`` (names absent from the mesh are
        ignored; ``None`` where that leaves no axis or one rank)."""
        axes = self._axes(axes)
        if not axes or self.axis_size(axes) == 1:
            return None
        return self.get_group(axes)

    def get_group(self, axes):
        """The process group along ``axes``, also where it holds one rank
        (as ``DeviceMesh.get_group``)."""
        if self._coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {self!r}")
        return self._groups[frozenset(self._axes(axes))]

    def submesh(self, axes) -> "LMMesh":
        """The mesh of the ranks that share this rank's coordinate off
        ``axes``, along ``axes`` (in this mesh's order)."""
        axes = self._axes(axes)
        idx = tuple(slice(None) if n in axes else c
                    for n, c in zip(self.mesh_dim_names, self._coord))
        groups = {k: g for k, g in self._groups.items() if k <= set(axes)}
        return LMMesh(self.ranks[idx], axes, self.device, self.transport,
                      groups)

    def dtensor(self, local: torch.Tensor, placements, shape):
        """A ``DTensor`` of global ``shape`` whose part on this rank is
        ``local`` (no collective: each rank brings its own part)."""
        from torch.distributed.tensor import DTensor
        shape = torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.device_mesh, list(placements),
                                  run_check=False, shape=shape,
                                  stride=stride)

    @property
    def device_mesh(self):
        """This mesh as a ``DeviceMesh`` of the rank's device type (over the
        same groups), for ``DTensor`` placements."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            groups = [self._groups[frozenset((n,))]
                      for n in self.mesh_dim_names]
            self._device_mesh = DeviceMesh.from_group(
                groups, self.device.type, mesh=self.mesh,
                mesh_dim_names=self.mesh_dim_names)
            _BY_DEVICE_MESH[id(self._device_mesh)] = self
        return self._device_mesh


# (shape, names, transport, device) -> (default group, mesh)
_MESHES: dict[tuple, tuple] = {}


def make_mesh(shape, names, *, device=None) -> LMMesh:
    """An ``LMMesh`` of ``shape`` named ``names`` over the first
    ``prod(shape)`` ranks of the world, row-major: the counterpart of
    ``jax.make_mesh``.  Call it on every rank of the world with the same
    arguments (group creation is collective); ``device`` is this rank's
    device (``rank_device``: by default the card ``LOCAL_RANK %
    device_count``), which also picks the transport of a world this call
    initialises (a world of one, when none exists and the mesh has one
    rank).  NCCL where the world is NCCL and each rank has a card, gloo
    otherwise (``_transport``).  On a ``fake`` world the named ``device``
    is taken as it is: no card is asked for."""
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    n = math.prod(shape)
    n_avail = dist.get_world_size() if dist.is_initialized() else 1
    if n > n_avail:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} "
                         f"devices, have {n_avail}")
    fake = _fake_world() and device is not None
    dev = torch.device(device) if fake else rank_device(device)
    if not dist.is_initialized():
        _init_world_of_one(dev)
    if dev.type == "cuda" and not fake:
        torch.cuda.set_device(dev)
    transport = _transport(dev)
    world = dist.distributed_c10d._get_default_group()
    key = (shape, names, transport, dev)
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is world:
        return hit[1]
    ranks = np.arange(n).reshape(shape)
    me = dist.get_rank()
    groups = {}
    # every non-empty subset of the axes, in one fixed order on every rank
    for bits in range(1, 1 << len(shape)):
        axes = tuple(a for i, a in enumerate(names) if bits >> i & 1)
        free = [names.index(a) for a in axes]
        rest = [i for i in range(len(shape)) if i not in free]
        lines = np.transpose(ranks, rest + free).reshape(
            -1, math.prod(shape[i] for i in free))
        for line in lines:
            g = dist.new_group([int(x) for x in line], backend=transport,
                               timeout=GROUP_TIMEOUT)
            if me in line:
                groups[frozenset(axes)] = g
    mesh = LMMesh(ranks, names, dev, transport, groups)
    _MESHES[key] = (world, mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> LMMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device=device)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> LMMesh:
    """A small ("data", "model") mesh over the first ``data * model`` ranks
    of the world: tests, smoke runs, the launcher."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {n}")
    return make_mesh((data, model), ("data", "model"), device=device)


# -- staged collectives -------------------------------------------------------

# "name axes" -> [calls, bytes this rank put in, host-clock seconds, the
# largest call's bytes]
MESH_STATS: dict[str, list] = {}
_TIMING = [False]


def reset_mesh_stats() -> None:
    MESH_STATS.clear()


def time_collectives(on: bool) -> None:
    """Time each collective on the host clock (after synchronising the
    device, so the time is the exchange's and its staging's)."""
    _TIMING[0] = bool(on)


def _counted(kind: str, out: torch.Tensor, group, axes) -> None:
    """Count a collective in the census being taken, if any
    (``launch.census``): its output ``out`` over ``group``."""
    if _hooks.active():
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        _hooks.record_collective(kind, out, dist.get_world_size(group),
                                 axes)


class _Timed:
    """Counts a collective in ``MESH_STATS`` under "name axes"."""

    def __init__(self, name: str, x: torch.Tensor, axes=()):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.name, self.x = f"{name} {','.join(axes)}".strip(), x

    def __enter__(self):
        if _TIMING[0]:
            if self.x.device.type == "cuda":
                torch.cuda.synchronize(self.x.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        st = MESH_STATS.setdefault(self.name, [0, 0, 0.0, 0])
        nbytes = self.x.numel() * self.x.element_size()
        st[0] += 1
        st[1] += nbytes
        st[3] = max(st[3], nbytes)
        if _TIMING[0]:
            if self.x.device.type == "cuda":
                torch.cuda.synchronize(self.x.device)
            st[2] += time.perf_counter() - self.t0


def _raw(x: torch.Tensor) -> torch.Tensor:
    """A view for pure data movement: 2-byte floats as bytes (every
    transport moves bytes; gloo has no bfloat16 all-to-all).  Flattened
    first: a tensor whose size-1 dims leave its last stride above 1 is
    contiguous to torch, and ``view`` of another element size refuses
    it."""
    if x.dtype in (torch.bfloat16, torch.float16) and x.dim():
        return x.contiguous().reshape(-1).view(torch.uint8).view(
            *x.shape[:-1], -1)
    return x


def _staged(mesh: LMMesh, x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(the tensor the transport takes, whether it is a host copy)."""
    x = x.contiguous()
    if mesh.transport == "gloo" and x.device.type != "cpu":
        return x.cpu(), True
    return x, False


def all_gather(x: torch.Tensor, mesh: LMMesh, axes,
               dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over ``axes`` (in
    group order: row-major over the axes), on ``x``'s device."""
    group = mesh.group(axes)
    if group is None:
        return x
    n = dist.get_world_size(group)
    with _Timed("all_gather", x, axes):
        src, staged = _staged(mesh, _raw(x.movedim(dim, 0)))
        out = torch.empty((n * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _ALL_GATHER(out, src, group=group)
        out = out.to(x.device) if staged else out
    _counted("all-gather", out, group, axes)
    return out.view(x.dtype).movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh: LMMesh, axes,
               op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``), mean (``"mean"``) or elementwise maximum
    (``"max"``) of every rank's ``x`` over ``axes``; a new tensor on
    ``x``'s device."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"all_reduce op {op!r}: not sum, mean or max")
    group = mesh.group(axes)
    if group is None:
        return x.clone()
    with _Timed("all_reduce", x, axes):
        src, staged = _staged(mesh, x)
        src = src.clone() if not staged else src
        dist.all_reduce(src, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
        out = src.to(x.device) if staged else src
    _counted("all-reduce", out, group, axes)
    return out / dist.get_world_size(group) if op == "mean" else out


def reduce_scatter(x: torch.Tensor, mesh: LMMesh, axes,
                   dim: int = 0) -> torch.Tensor:
    """The sum over ``axes`` of every rank's ``x``, split along ``dim``
    into the group's size; this rank keeps its part."""
    group = mesh.group(axes)
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    with _Timed("reduce_scatter", x, axes):
        src, staged = _staged(mesh, x.movedim(dim, 0))
        out = torch.empty((src.shape[0] // n, *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _REDUCE_SCATTER(out, src, group=group)
        out = out.to(x.device) if staged else out
    _counted("reduce-scatter", out, group, axes)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh: LMMesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)`` over one axis: ``x`` splits
    along ``split_dim`` into the group's size, part j goes to rank j, and
    the parts received are concatenated along ``concat_dim`` in rank
    order."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    with _Timed("all_to_all", x, axis):
        src, staged = _staged(mesh, _raw(x.movedim(split_dim, 0)))
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        out = out.to(x.device) if staged else out
    _counted("all-to-all", out, group, axis)
    out = out.view(x.dtype)
    parts = out.reshape(n, -1, *out.shape[1:])
    return torch.cat([p.movedim(0, split_dim) for p in parts],
                     dim=concat_dim)


def all_to_all_v(x: torch.Tensor, mesh: LMMesh, axis: str, send,
                 recv) -> torch.Tensor:
    """An all-to-all of uneven parts over one axis, along dim 0: the first
    ``send[0]`` rows of ``x`` go to rank 0, the next ``send[1]`` to rank 1
    and so on; ``recv[j]`` rows come from rank j, concatenated in rank
    order."""
    group = mesh.group(axis)
    if group is None:
        return x
    with _Timed("all_to_all", x, axis):
        src, staged = _staged(mesh, _raw(x))
        out = torch.empty((sum(recv), *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_to_all_single(out, src, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=group)
        out = out.to(x.device) if staged else out
    _counted("all-to-all", out, group, axis)
    return out.view(x.dtype)


def permute(x: torch.Tensor, mesh: LMMesh, axis: str,
            shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` with pairs (i, i + shift): each rank sends ``x``
    ``shift`` places along ``axis`` and returns what its peer sent; a rank
    no one sends to gets zeros."""
    group = mesh.group(axis)
    if group is None:
        return torch.zeros_like(x) if shift else x
    n, i = dist.get_world_size(group), dist.get_rank(group)
    with _Timed("permute", x, axis):
        src, staged = _staged(mesh, _raw(x))
        buf = torch.zeros_like(src)
        ops = []
        if 0 <= i + shift < n:
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(group, i + shift),
                                  group))
        if 0 <= i - shift < n:
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(group, i - shift),
                                  group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = buf.to(x.device) if staged else buf
    _counted("collective-permute", out, group, axis)
    return out.view(x.dtype)


# -- differentiable collectives ----------------------------------------------

def _part(x: torch.Tensor, mesh: LMMesh, axes, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` split along ``dim`` over ``axes``."""
    n = mesh.axis_size(axes)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.group_index(axes) * size, size)


class _GatherShards(torch.autograd.Function):
    """Forward: a leaf whole from this rank's shard (all-gathers along each
    sharded dim).  Backward: a reduce-scatter (sum) over the summed axes,
    and along the others this rank's part of the gradient (those axes hold
    replicas of one computation, whose gradients are equal)."""

    @staticmethod
    def forward(ctx, x, mesh, shards, summed):
        ctx.mesh, ctx.shards, ctx.summed = mesh, shards, summed
        out = x
        for axis, dim in reversed(shards):
            out = all_gather(out, mesh, axis, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        for axis, dim in ctx.shards:
            g = reduce_scatter(g, ctx.mesh, axis, dim) \
                if axis in ctx.summed else _part(g, ctx.mesh, axis, dim)
        return g.contiguous(), None, None, None


def gather_shards(x: torch.Tensor, mesh: LMMesh, shards, summed=()):
    """``x`` (this rank's shard) made whole: ``shards`` lists ``(axis,
    tensor dim)`` in mesh order, as ``distributed.sharding`` places the
    leaf.  The gradient is reduce-scattered over the ``summed`` axes (the
    data-parallel ones: each rank's gradient is a part of the sum) and
    sliced along the others."""
    if not shards:
        return x
    return _GatherShards.apply(x, mesh, tuple(shards), tuple(summed))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _part(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def split(x: torch.Tensor, mesh: LMMesh, axes, dim: int) -> torch.Tensor:
    """This rank's part of a tensor every rank of ``axes`` holds whole
    (split along ``dim``).  Backward: the parts' gradients all-gathered."""
    if mesh.axis_size(axes) == 1:
        return x
    return _Split.apply(x, mesh, axes, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_part(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


def gather(x: torch.Tensor, mesh: LMMesh, axes, dim: int) -> torch.Tensor:
    """The parts of ``axes`` concatenated along ``dim``, whole on every rank
    (``split``'s inverse).  What follows runs on every rank alike, so the
    gradient each rank gets is the same and its backward keeps this rank's
    part."""
    if mesh.axis_size(axes) == 1:
        return x
    return _Gather.apply(x, mesh, axes, dim)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, *ctx.args), None, None, None, None


def exchange(x: torch.Tensor, mesh: LMMesh, axis: str, split_dim: int,
             concat_dim: int) -> torch.Tensor:
    """``all_to_all``, differentiable: the backward is the reverse
    exchange."""
    if mesh.axis_size(axis) == 1:
        return x
    return _Exchange.apply(x, mesh, axis, split_dim, concat_dim)


class _ExchangeV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, send, recv):
        ctx.args = (mesh, axis, recv, send)
        return all_to_all_v(x, mesh, axis, send, recv)

    @staticmethod
    def backward(ctx, g):
        return (all_to_all_v(g.contiguous(), *ctx.args), None, None, None,
                None)


def exchange_v(x: torch.Tensor, mesh: LMMesh, axis: str, send,
               recv) -> torch.Tensor:
    """``all_to_all_v``, differentiable: the backward sends each row's
    gradient back to the rank it came from."""
    if mesh.axis_size(axis) == 1:
        return x
    return _ExchangeV.apply(x, mesh, axis, tuple(send), tuple(recv))


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


def sum_grads(x: torch.Tensor, mesh: LMMesh, axes) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``axes``: a
    tensor every rank holds the same, used on parts of the work that the
    ranks of ``axes`` split between them."""
    if mesh.axis_size(axes) == 1:
        return x
    return _SumGrads.apply(x, mesh, axes)


class _ReduceParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.float(), mesh, axes).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_parts(x: torch.Tensor, mesh: LMMesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of each rank's part of a result (a
    row-parallel product's partial sums), whole on every rank; summed in
    float32 and rounded once to ``x``'s dtype.  What follows runs on every
    rank alike, so the backward passes the gradient through as it is: each
    rank's part gets the whole sum's gradient."""
    if mesh.axis_size(axes) == 1:
        return x
    return _ReduceParts.apply(x, mesh, axes)


class _ScatterParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter(x.float(), mesh, axes, dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), \
            None, None, None


def scatter_parts(x: torch.Tensor, mesh: LMMesh, axes,
                  dim: int) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum over ``axes`` of each
    rank's partial result (a row-parallel product whose output stays split,
    as the rank's channels); summed in float32 and rounded once to ``x``'s
    dtype, as ``reduce_parts``.  Backward: each rank's part of the gradient
    all-gathered, since every rank's partial sum fed every part."""
    if mesh.axis_size(axes) == 1:
        return x
    return _ScatterParts.apply(x, mesh, axes, dim % x.dim())


class _ReplicaMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.axis_size(axes)
        return all_reduce(x, mesh, axes, "mean")

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def replica_mean(x: torch.Tensor, mesh: LMMesh, axes) -> torch.Tensor:
    """The mean over ``axes`` of each rank's part (a loss term the ranks
    split the work of).  Every rank then holds the same mean, one value
    seen from every rank, so each part's gradient is the rank's gradient
    of the mean, divided by the group's size."""
    if mesh.axis_size(axes) == 1:
        return x
    return _ReplicaMean.apply(x, mesh, axes)


# id(DeviceMesh) -> the LMMesh it was made from
_BY_DEVICE_MESH: dict[int, LMMesh] = {}


def lm_mesh_of(dt) -> LMMesh:
    """The ``LMMesh`` of a ``DTensor`` placed on one (``LMMesh
    .device_mesh``)."""
    mesh = _BY_DEVICE_MESH.get(id(dt.device_mesh))
    if mesh is None:
        raise ValueError("the DTensor's mesh is not an LM mesh of "
                         "launch.mesh.make_mesh")
    return mesh


def whole_on_host(dt, writer_only: bool = False):
    """A ``DTensor`` of an LM mesh gathered whole into host memory.
    Collective: every rank of the mesh calls it.  Every rank gets the
    tensor (an all-gather along each sharded axis), or with
    ``writer_only`` the mesh's first rank alone, the others ``None``: then
    one rank of each distinct shard sends it straight to the writer (a
    gather), which places the pieces."""
    from ..distributed.sharding import local_slices, shards_of
    mesh = lm_mesh_of(dt)
    placements = tuple(dt.placements)
    shards = shards_of(placements, mesh)
    with torch.no_grad():
        out = dt.to_local()
    if not writer_only:
        if mesh.transport == "gloo":
            out = out.cpu()
        for axis, dim in reversed(shards):
            out = all_gather(out, mesh, axis, dim)
        return out.cpu()
    axes = tuple(a for a, _ in shards)
    if any(mesh.coordinate(a) for a in mesh.mesh_dim_names if a not in axes):
        return None                  # a replica of a shard another sends
    group = mesh.group(axes)
    if group is None:
        return None if any(mesh.get_coordinate()) else out.cpu()
    src, staged = _staged(mesh, _raw(out))
    n = dist.get_world_size(group)
    first = dist.get_rank(group) == 0
    pieces = [torch.empty_like(src) for _ in range(n)] if first else None
    with _Timed("gather", src, axes):
        dist.gather(src, pieces, dst=dist.get_global_rank(group, 0),
                    group=group)
    if not first:
        return None
    whole = torch.empty(tuple(dt.shape), dtype=dt.dtype)
    sizes = [mesh.axis_size(a) for a in axes]
    coord = dict.fromkeys(mesh.mesh_dim_names, 0)
    for i, piece in enumerate(pieces):
        for a, c in zip(axes, np.unravel_index(i, sizes)):
            coord[a] = int(c)
        idx = local_slices(tuple(dt.shape), placements, mesh.shape,
                           [coord[a] for a in mesh.mesh_dim_names])
        whole[idx] = piece.cpu().view(dt.dtype)
    return whole


def barrier(mesh: LMMesh) -> None:
    """Every rank of ``mesh`` waits for the others."""
    group = mesh.group(mesh.mesh_dim_names)
    if group is not None:
        dist.barrier(group=group)
