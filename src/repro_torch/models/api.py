"""Unified model API: one entry point per phase, dispatched on cfg.family.

  init(cfg, seed)                     -> params
  train_logits(params, cfg, batch)    -> (logits, aux_loss)
  prefill(params, cfg, batch)         -> (logits, cache)
  decode(params, cfg, batch)          -> (logits, cache)
  make_inputs(cfg, shape, seed)       -> concrete batch
  input_specs(cfg, shape)             -> TensorSpec batch

The port of the JAX package's ``models/api.py`` for the dense family; every
other family raises ``NotImplementedError`` naming ROADMAP A15.  Entry
points run on the card unless the caller passes ``device="cpu"``; the
tensors of a batch carry their device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..core.engine.plan import resolve_device
from . import transformer as TF
from .layers import Compute
from .transformer import lm_loss

__all__ = ["init", "train_logits", "prefill", "decode", "make_inputs",
           "input_specs", "lm_loss", "TensorSpec"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one model input (the port's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


def _dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family!r} family is not ported "
                                  "yet (ROADMAP A15); the port serves "
                                  "family='dense'")


def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (default: the card)."""
    _dense(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return TF.init_lm(cfg, gen, device=device)


def train_logits(params, cfg: ModelConfig, batch: dict):
    _dense(cfg)
    logits, _, aux = TF.forward(params, cfg, batch["tokens"])
    return logits, aux


def prefill(params, cfg: ModelConfig, batch: dict, *,
            last_only: bool = True, attn_route: str = "auto"):
    """Prompt ingestion into a cache exactly the prompt's length, so its
    attention takes the fused kernel B9 on the card.  ``last_only``
    (default) emits the final position's logits only; ``attn_route``
    (``"auto"``, ``"kernel"`` or ``"blockwise"``) picks the attention
    route (``layers.attention``)."""
    _dense(cfg)
    tokens = batch["tokens"]
    b, t = tokens.shape
    cache = TF.init_cache(cfg, b, t, device=tokens.device)
    logits, cache, _ = TF.forward(params, cfg, tokens, cache=cache,
                                  last_only=last_only, attn_route=attn_route)
    return logits, cache


def decode(params, cfg: ModelConfig, batch: dict):
    _dense(cfg)
    return TF.decode_step(params, cfg, batch["cache"], batch["tokens"],
                          batch["pos"])


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """TensorSpec stand-ins for every model input of this cell."""
    _dense(cfg)
    t, b = shape.seq_len, shape.global_batch
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        out = {"tokens": TensorSpec((b, t), i32)}
        if shape.kind == "train":
            out["labels"] = TensorSpec((b, t), i32)
        return out
    # decode shapes: one new token against a seq_len-deep cache
    cshape = (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.hd)
    return {"tokens": TensorSpec((b, 1), i32), "pos": TensorSpec((), i32),
            "cache": {"k": TensorSpec(cshape, Compute),
                      "v": TensorSpec(cshape, Compute)}}


def make_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0, *,
                device=None) -> dict:
    """Concrete random batch matching ``input_specs``, drawn from numpy in
    the JAX package's order (leaves by sorted key), so both packages get the
    same batch from the same seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def concrete(spec):
        if isinstance(spec, dict):
            return {k: concrete(spec[k]) for k in sorted(spec)}
        if not spec.dtype.is_floating_point:
            hi = max(cfg.vocab_size - 1, 1)
            arr = rng.integers(0, hi, size=spec.shape).astype(np.int32)
            return torch.from_numpy(np.asarray(arr)).to(device)
        arr = rng.normal(0, 0.02, size=spec.shape).astype(np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=spec.dtype)

    batch = concrete(input_specs(cfg, shape))
    if "pos" in batch:
        # decode smoke tests write at a mid-cache position
        batch["pos"] = min(7, shape.seq_len - 2)
    return batch
