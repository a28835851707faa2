"""int8 gradient compression with error feedback for the cross-pod mean.

The port of the JAX package's ``distributed/compression.py``.  Cross-pod
bandwidth is the scarce resource at multi-pod scale; the pod axis is pure
data parallelism, so its gradient mean moves whole gradients every step.
This module quantises that exchange to int8 (4x less traffic) with a
per-tensor scale and keeps the quantisation residual in an error-feedback
buffer (Seide et al. / 1-bit SGD lineage).

``quantize`` and ``dequantize`` are the reference's arithmetic bit for bit
(``torch.round``, like ``jnp.round``, rounds half to even).  The exchange
is an all-gather of the int8 values and scales over "pod" and a local
dequantised mean; each rank passes its own gradients (those of its pod).
"""

from __future__ import annotations

import torch

from ..launch import mesh as lmesh
from ..training.optimizer import _tree_map

__all__ = ["init_error_state", "quantize", "dequantize",
           "compressed_pod_mean"]


def init_error_state(params):
    return _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_pod_mean(grads, error, mesh, *, axis: str = "pod"):
    """Error-feedback int8 mean over ``axis``.  Returns (mean_grads,
    new_error).

    g_corrected = g + e;  q = Q(g_corrected);  e' = g_corrected - deQ(q);
    exchange q (int8) and its scale, dequantise and average locally.
    A mesh without ``axis`` returns its inputs (a single-pod mesh).
    """
    if axis not in mesh.mesh_dim_names:
        return grads, error

    def per_leaf(g, e):
        corrected = g.to(torch.float32) + e
        q, scale = quantize(corrected)
        new_e = corrected - dequantize(q, scale)
        qs = lmesh.all_gather(q[None], mesh, axis)      # [pods, ...] int8
        scales = lmesh.all_gather(scale.reshape(1), mesh, axis)
        mean = torch.mean(qs.to(torch.float32)
                          * scales.reshape((-1,) + (1,) * g.dim()), dim=0)
        return mean.to(g.dtype), new_e

    pairs = _tree_map(per_leaf, grads, error)
    return (_tree_map(lambda p: p[0], pairs),
            _tree_map(lambda p: p[1], pairs))
