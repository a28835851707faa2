"""Topology-aware collectives: the paper's 2-tier merge, on the mesh
hierarchy.

The port of the JAX package's ``distributed/collectives.py``.  The paper
found (Sec. 5.2) that on EC2 a flat binary-tree reduction of L-vectors
loses to a hierarchy that exploits the intra-node/inter-node latency gap.
``hierarchical_merge_lvecs`` folds chunk maps over "data" (the fast tier)
first, then over "pod" (the slow tier): one composition step crosses the
slow tier, mirroring Fig. 9's node-leader / master scheme.  Every fold is
kernel B7 (``kernels.ops.lvec_compose``) on a card.

``hierarchical_mean`` applies the same structure to gradient reduction:
a mean over "data", then over "pod".

SPMD, as every LM-mesh function: each rank calls with the same global
arguments (an ``launch.mesh.LMMesh``) and returns the whole result; the
model ranks of a data-parallel group repeat its work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import ops
from ..launch import mesh as lmesh

__all__ = ["hierarchical_merge_lvecs", "flat_merge_lvecs",
           "hierarchical_mean", "distributed_membership"]


def _local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of ``x`` [C, ...] sharded over the dp axes."""
    dp = lmesh.dp_axes(mesh)
    n = mesh.axis_size(dp)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over the "
                         f"{n} data-parallel ranks")
    part = x.shape[0] // n
    i = mesh.group_index(dp)
    return x[i * part:(i + 1) * part]


def _merge_tiers(acc: torch.Tensor, mesh, tiers) -> torch.Tensor:
    """All-gather the folded map [Q] over each tier in turn, and fold."""
    for axes in tiers:
        if mesh.axis_size(axes) > 1:
            acc = ops.lvec_compose(lmesh.all_gather(acc[None], mesh, axes))
    return acc


def hierarchical_merge_lvecs(maps: torch.Tensor, mesh) -> torch.Tensor:
    """maps [C_global, Q] (chunk-major, sharded over the dp axes) -> the
    global map [Q].

    Tier 0: each rank folds its own chunks' maps.
    Tier 1: all-gather + fold over "data"  (the paper's node leader).
    Tier 2: all-gather + fold over "pod"   (the paper's master).
    """
    acc = ops.lvec_compose(_local_rows(maps, mesh))
    tiers = [(a,) for a in ("data", "pod") if a in mesh.mesh_dim_names]
    return _merge_tiers(acc, mesh, tiers)


def flat_merge_lvecs(maps: torch.Tensor, mesh) -> torch.Tensor:
    """Baseline: one all-gather over all dp axes, then a fold (the
    comparison partner of the 2-tier scheme, Sec. 5.2)."""
    acc = ops.lvec_compose(_local_rows(maps, mesh))
    return _merge_tiers(acc, mesh, [lmesh.dp_axes(mesh)])


def hierarchical_mean(tree, mesh):
    """Two-tier mean of a tree of tensors: over "data", then over "pod"."""
    if isinstance(tree, dict):
        return {k: hierarchical_mean(v, mesh) for k, v in tree.items()}
    for axis in ("data", "pod"):
        tree = lmesh.all_reduce(tree, mesh, axis, "mean") \
            if mesh.axis_size(axis) > 1 else tree
    return tree


def distributed_membership(table: np.ndarray, classes: np.ndarray,
                           start: int, sink: int, accepting: np.ndarray,
                           mesh, num_chunks_per_device: int = 4) -> int:
    """End-to-end distributed DFA membership test (Holub-style full maps):
    the final state of running ``classes`` from ``start``.

    The class stream splits into ``dp_size * num_chunks_per_device``
    chunks, chunk-major over the dp ranks; each rank computes its chunks'
    full state maps with ``ops.spec_match`` from identity lanes (kernel B6,
    or B8 then B7 where ``mxu_profitable`` picks the product route), the
    maps merge with the 2-tier hierarchy (B7), and the tail past the last
    whole chunk runs on the host.
    """
    dp = lmesh.dp_axes(mesh)
    dp_size = mesh.axis_size(dp)
    c = dp_size * num_chunks_per_device
    n = classes.shape[0]
    l = n // c
    q = table.shape[0]
    i = mesh.group_index(dp)
    dev = mesh.device
    mine = np.asarray(classes[i * num_chunks_per_device * l:
                              (i + 1) * num_chunks_per_device * l],
                      np.int32).reshape(num_chunks_per_device, l)
    table_t = torch.as_tensor(np.asarray(table, np.int32), device=dev)
    lanes = torch.arange(q, dtype=torch.int32, device=dev).expand(
        num_chunks_per_device, q).contiguous()
    maps = ops.spec_match(table_t, torch.from_numpy(mine).to(dev), lanes)
    acc = ops.lvec_compose(maps)
    tiers = [(a,) for a in ("data", "pod") if a in mesh.mesh_dim_names]
    total = _merge_tiers(acc, mesh, tiers)
    state = int(total[start])
    for cls in classes[l * c:]:
        state = int(table[state, int(cls)])
    return state
