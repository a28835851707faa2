"""Carry the JAX package's model parameters over to the port.

``params_from_jax(cfg, tree)`` takes the pytree that the JAX package's
``models.api.init`` returns, as nested dicts of numpy arrays (``jax.tree.map
(np.asarray, params)``), and returns the port's parameters: the same names,
the same stacked ``[L, ...]`` layout, float32 tensors on ``device``.  The
tests feed both packages the same weights through it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.engine.plan import resolve_device
from .transformer import param_shapes

__all__ = ["params_from_jax"]


def params_from_jax(cfg: ModelConfig, tree: dict, *, device=None) -> dict:
    """The JAX parameter tree of ``cfg`` -> the port's, on ``device``
    (default: the card).  Raises if a name or a shape does not match."""
    device = resolve_device(device)

    def convert(shapes, node, path):
        if isinstance(shapes, dict):
            if not isinstance(node, dict) or set(node) != set(shapes):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or 'params'}: expected keys "
                                 f"{sorted(shapes)}, got {got}")
            return {k: convert(shapes[k], node[k], f"{path}/{k}")
                    for k in shapes}
        arr = np.array(node, np.float32)  # a writable copy
        if arr.shape != tuple(shapes):
            raise ValueError(f"{path}: expected shape {tuple(shapes)}, got "
                             f"{arr.shape}")
        return torch.from_numpy(arr).to(device)

    return convert(param_shapes(cfg), tree, "")
