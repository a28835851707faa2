"""Carry the JAX package's model parameters over to the port.

``params_from_jax(cfg, tree)`` takes the pytree that the JAX package's
``models.api.init`` returns, as nested dicts of numpy arrays (``jax.tree.map
(np.asarray, params)``), and returns the port's parameters: the same names,
the same stacked layout (``[L, ...]`` layers; ``[n_groups, ...]`` groups
and an unstacked ``tail`` for the hybrid and ssm families; ``enc``/``dec``
stacks for encdec), float32 tensors on ``device``.  Every family's tree
goes through it (``api.param_shapes``).  The tests feed both packages the
same weights through it; with ``mesh=`` (an LM mesh) each rank keeps its
block of each leaf as ``distributed.sharding.param_specs`` places it
(``local_block``), the layout ``api.init(..., keep=param_keep(mesh))``
draws.

``train_state_from_jax(cfg, state)`` does the same for a whole train state
(``training.init_train_state``'s ``{"params", "opt": {"m", "v", "step"}}``,
the JAX package's tree), and ``train_state_to_numpy`` is its inverse: the
port's state as the nested dicts of numpy arrays that the JAX package's
steps and checkpoints take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.engine.plan import resolve_device
from .api import param_shapes

__all__ = ["params_from_jax", "train_state_from_jax", "train_state_to_numpy"]


def params_from_jax(cfg: ModelConfig, tree: dict, *, device=None,
                    mesh=None) -> dict:
    """The JAX parameter tree of ``cfg`` -> the port's, on ``device``
    (default: the card; on ``mesh``, this rank's block of each leaf).
    Raises if a name or a shape does not match."""
    device = resolve_device(device)
    specs = None
    if mesh is not None:
        from ..distributed.sharding import local_block, param_specs
        specs = param_specs(param_shapes(cfg), mesh)

    def block(arr, path):
        if specs is None:
            return arr
        spec = specs
        for k in path.strip("/").split("/"):
            spec = spec[k]
        return np.ascontiguousarray(local_block(arr, spec, mesh))

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
        return torch.from_numpy(block(arr, path)).to(device)

    return convert(param_shapes(cfg), tree, "")


def train_state_from_jax(cfg: ModelConfig, state: dict, *,
                         device=None) -> dict:
    """The JAX package's train state of ``cfg`` (numpy leaves) -> the
    port's, on ``device`` (default: the card): parameters and both moments
    through ``params_from_jax``, the step a 0-d int32 tensor."""
    device = resolve_device(device)
    if set(state) != {"params", "opt"} or set(state["opt"]) != {"m", "v",
                                                                 "step"}:
        raise ValueError("expected a train state {'params', 'opt': {'m', "
                         f"'v', 'step'}}}}, got keys {sorted(state)}")
    opt = state["opt"]
    return {"params": params_from_jax(cfg, state["params"], device=device),
            "opt": {"m": params_from_jax(cfg, opt["m"], device=device),
                    "v": params_from_jax(cfg, opt["v"], device=device),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=device)}}


def train_state_to_numpy(state: dict) -> dict:
    """A tree of tensors (a train state, parameters) -> the same tree of
    numpy arrays on the host, each leaf in its own memory; a 0-d step
    stays 0-d int32."""
    if isinstance(state, dict):
        return {k: train_state_to_numpy(v) for k, v in state.items()}
    return state.detach().cpu().numpy().copy()
