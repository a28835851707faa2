"""GPipe-style pipeline parallelism over a mesh axis.

The port of the JAX package's ``distributed/pipeline.py``: the layer stack
splits into S stages laid out on a ``stage`` mesh axis; microbatches
stream through with the classic (M + S - 1)-step schedule, activations
hopping one stage forward with the neighbour permute
(``launch.mesh.permute``).  Bubble fraction = (S-1)/(M+S-1).  Forward
only, as in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..launch import mesh as lmesh

__all__ = ["pipeline_apply"]


def _stage_of(tree, i: int):
    if isinstance(tree, dict):
        return {k: _stage_of(v, i) for k, v in tree.items()}
    return tree[i]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   mesh, *, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_s, x)`` through S pipeline stages.

    stage_params : a tree of tensors with a leading [S] dim (stage-major)
    x_micro      : [M, ...] microbatches
    Returns [M, ...], the final stage's outputs in order, on every rank of
    the mesh (a sum over ``axis``: only the last stage banks outputs).
    """
    s = mesh.axis_size(axis)
    m = x_micro.shape[0]
    idx = mesh.coordinate(axis)
    first, last = idx == 0, idx == s - 1
    params = _stage_of(stage_params, idx)           # my stage
    buf = torch.zeros_like(x_micro[0])              # what my stage holds
    outs = torch.zeros_like(x_micro)
    for t in range(m + s - 1):
        # stage 0 ingests microbatch t (the last one again in the bubble)
        inp = x_micro[min(t, m - 1)] if first else buf
        out = stage_fn(params, inp)
        done = t - (s - 1)
        if last and done >= 0:
            outs[done] = out
        buf = lmesh.permute(out, mesh, axis, 1)     # hop one stage on
    return lmesh.all_reduce(outs, mesh, axis)
