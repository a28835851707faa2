"""AdamW with a cosine schedule and global-norm clipping.

The port of the JAX package's ``training/optimizer.py``: plain tensor ops
on parameter trees (nested dicts of tensors), no ``torch.optim``, in the
reference's arithmetic order, so the numbers are the reference's and not
PyTorch's AdamW.  The state is ``{"m", "v", "step"}``: float32 trees
mirroring the parameters and a 0-d int32 step, the reference's tree, so a
checkpoint of either package restores in the other.  Every quantity stays
on the parameters' device; nothing syncs with the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to ``min_lr_frac`` (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def adamw_init(params: Any) -> dict:
    """Zero moments (float32) and step 0, on the parameters' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = _leaves(params)[0].device
    return {"m": _tree_map(zeros, params),
            "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for g in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _tree_map(lambda g: g * scale, grads), norm


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, opt: dict, *,
                 norm: torch.Tensor | None = None):
    """One AdamW step, in place; returns (params, opt, metrics).

    Consumes its arguments: the float32 gradients are clipped in place
    (a gradient that is not float32 is cast first), and each leaf's new
    parameter and moments are written into the given tensors as soon as
    they are computed, so peak memory grows by one leaf's temporaries, not
    by second copies of the gradients, parameters and moments.  The
    returned trees hold the given tensors; ``opt["step"]`` is advanced in
    place too.  ``norm`` is the gradients' global norm where they are a
    rank's shards of a mesh (``train_loop``'s sharded step counts it);
    by default it is computed from ``grads``.
    """
    grads = _tree_map(lambda g: g.to(torch.float32), grads)
    gnorm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(gnorm, cfg.clip_norm)
    for g in _leaves(grads):
        g.mul_(scale)
    step = opt["step"].add_(1)
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def leaf(p, g, m, v):
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.to(torch.float32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)

    _tree_map(leaf, params, grads, opt["m"], opt["v"])
    return params, opt, {"grad_norm": gnorm, "lr": lr}
