"""Matcher meshes over ``torch.distributed``: one process per device.

The sharded matching backend (``core.engine.sharded``) runs one SPMD
program per rank: every rank of the world constructs the same ``Matcher``
and calls each method with the same arguments in the same order, and each
rank returns the whole result.  Its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` named ``("doc", "chunk")``
over the ranks, row-major (rank ``r * Dc + c`` sits at coordinate
``(r, c)``).

Transport.  The world's backend decides it: NCCL where each rank has its
own card (``init_process_group("nccl")``), gloo on the CPU and where ranks
share one card (NCCL refuses two ranks on one device).  On gloo the
collectives stage device tensors through host memory explicitly
(``all_gather_rows``), so the CPU and a shared card run the same code.  A
gloo mesh has device type "cpu" (where its collectives' tensors live), an
NCCL mesh "cuda".

Without an initialised world, a mesh of one device initialises a world of
one (a ``file://`` store in a temporary directory: NCCL on a card, gloo on
the CPU), so ``Matcher(dfas, backend="sharded")`` works in a plain script.

Group creation is collective and must happen in the same order on every
rank, so meshes are cached by shape: a tune over candidate shapes builds
each mesh's groups once.

The LM's ("data", "model") meshes (``make_production_mesh``,
``make_local_mesh``) are not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_matcher_mesh", "factor_matcher_mesh", "matcher_mesh_extents",
           "dp_axes", "mesh_info", "rank_device", "mesh_transport",
           "mesh_coordinate", "mesh_group", "all_gather_rows",
           "GROUP_TIMEOUT"]

# how long a collective of the groups this module creates may wait for its
# peers before it fails (a dead or diverged rank raises instead of hanging)
GROUP_TIMEOUT = datetime.timedelta(seconds=300)

# (doc, chunk, transport) -> (default group, mesh, flat group); the default
# group's identity invalidates entries of a destroyed world
_MESHES: dict[tuple, tuple] = {}
# id(mesh) -> the group over all of the mesh's ranks
_FLAT: dict[int, tuple] = {}
# the concatenating all-gather (renamed ``all_gather_single`` in newer torch)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


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


def _transport(device: torch.device) -> str:
    backend = str(dist.get_backend())
    if device.type == "cuda" and "nccl" in backend:
        return "nccl"
    if "gloo" in backend:
        return "gloo"
    raise ValueError(f"the world's backend {backend!r} cannot carry a "
                     f"matcher mesh on {device}: initialise it with 'nccl' "
                     "(one card a rank) or 'gloo' (the CPU, or ranks sharing "
                     "a card)")


def make_matcher_mesh(devices: int | None = None, *,
                      shape: tuple[int, int] | str | None = None,
                      device=None):
    """("doc", "chunk") ``DeviceMesh`` over the world's ranks.

    The speculative path gathers lane states over "chunk" and collects each
    tile's rows over "doc" (see ``core.engine.sharded``).  ``devices`` is
    how many ranks the mesh uses (default: the whole world).

    shape=None         -> (1, D): every rank on the chunk axis.
    shape="auto"       -> ``factor_matcher_mesh``: near-square, 8 -> 2x4.
    shape=(doc, chunk) -> explicit extents (``devices`` may be omitted).

    Call it on every rank with the same arguments (SPMD).  ``device`` is
    this rank's device (``rank_device``); it picks the transport of a world
    this call initialises (a world of one, when none exists and the mesh
    has one device).  Each collective of the groups created here fails
    after ``GROUP_TIMEOUT`` instead of waiting for a dead rank.
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
    if doc * chunk > n_avail:
        raise ValueError(f"mesh {doc}x{chunk} needs {doc * chunk} devices, "
                         f"have {n_avail}")
    dev = rank_device(device)
    if not dist.is_initialized():
        _init_world_of_one(dev)
    transport = _transport(dev)
    world = dist.distributed_c10d._get_default_group()
    key = (doc, chunk, transport)
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is world:
        return hit[1]
    from torch.distributed.device_mesh import DeviceMesh

    ranks = np.arange(doc * chunk).reshape(doc, chunk)
    me = dist.get_rank()

    def groups(members):
        mine = None
        for m in members:
            g = dist.new_group([int(x) for x in m], backend=transport,
                               timeout=GROUP_TIMEOUT)
            if me in m:
                mine = g
        return mine

    doc_g = groups([ranks[:, c] for c in range(chunk)])
    chunk_g = groups([ranks[r] for r in range(doc)])
    flat_g = groups([ranks.reshape(-1)])
    if me >= doc * chunk:
        raise ValueError(f"rank {me} is outside the {doc}x{chunk} mesh; "
                         "only its ranks construct the matcher")
    mesh = DeviceMesh.from_group(
        [doc_g, chunk_g], "cuda" if transport == "nccl" else "cpu",
        mesh=torch.from_numpy(ranks.astype(np.int32)),
        mesh_dim_names=("doc", "chunk"))
    _MESHES[key] = (world, mesh, flat_g)
    _FLAT[id(mesh)] = (mesh, flat_g)
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
    """"nccl" for a mesh of CUDA tensors, "gloo" otherwise."""
    return "nccl" if mesh.device_type == "cuda" else "gloo"


def mesh_coordinate(mesh) -> tuple[int, int]:
    """This rank's (doc, chunk) coordinate; (0, c) on a 1-D mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return (0, int(coord[0])) if len(coord) == 1 else (int(coord[0]),
                                                       int(coord[1]))


def mesh_group(mesh):
    """The process group over all of the mesh's ranks (row-major order).

    Meshes from ``make_matcher_mesh`` carry it; for another mesh it is
    created on first use, which, like every group creation, every rank of
    the world must reach in the same order.
    """
    hit = _FLAT.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    ranks = mesh.mesh.reshape(-1).tolist()
    if ranks != sorted(ranks):
        raise ValueError("a matcher mesh numbers its ranks row-major in "
                         f"ascending order, got {ranks}")
    g = dist.new_group(ranks, backend=mesh_transport(mesh),
                       timeout=GROUP_TIMEOUT)
    _FLAT[id(mesh)] = (mesh, g)
    return g


def all_gather_rows(mesh, x: torch.Tensor,
                    axis: str | None = None) -> torch.Tensor:
    """All-gather ``x`` along its first dimension over one mesh axis
    (``"doc"``, ``"chunk"``) or, with ``axis=None``, over the whole mesh;
    the result is in group-rank order (mesh order), on ``x``'s device.

    On a gloo mesh a device tensor is staged through host memory (``.cpu()``,
    gather, copy back); on NCCL the gather runs on the card.
    """
    group = mesh_group(mesh) if axis is None else mesh.get_group(axis)
    n = dist.get_world_size(group)
    stage = mesh.device_type == "cpu" and x.device.type != "cpu"
    src = (x.cpu() if stage else x).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _ALL_GATHER(out, src, group=group)
    return out.to(x.device) if stage else out


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
