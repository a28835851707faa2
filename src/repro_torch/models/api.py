"""Unified model API: one entry point per phase, dispatched on cfg.family.

  init(cfg, seed)                     -> params
  train_logits(params, cfg, batch)    -> (logits, aux_loss)
  prefill(params, cfg, batch)         -> (logits, cache)
  decode(params, cfg, batch)          -> (logits, cache/state)
  (each of the last three takes ``mesh=``, as the reference's)
  make_inputs(cfg, shape, seed)       -> concrete batch
  input_specs(cfg, shape)             -> TensorSpec batch
  param_shapes(cfg)                   -> nested parameter shapes

The port of the JAX package's ``models/api.py`` for every family: dense,
moe and vlm (``transformer``), hybrid (``recurrent``), ssm (``xlstm``) and
encdec (``encdec``).  The modality frontends are stubs, as in the
reference: batches carry precomputed frame/patch embeddings.  Entry points
run on the card unless the caller passes ``device="cpu"``; the tensors of a
batch carry their device.  ``train_logits`` is differentiable (each
layer's body rematerialised by ``cfg.remat_policy``):
``training.train_loop.make_train_step`` takes its gradients, on one device
or on an LM mesh.

``mesh`` (a ``launch.mesh.LMMesh``; SPMD: every rank passes the same whole
batch and gets the whole result) reaches the transformer family's MoE
layers, which then run expert parallelism over its "model" axis; the
expert leaves of ``params`` are then this rank's shard (``init(...,
keep=distributed.sharding.expert_keep(mesh))``).  The other families accept
it and pass it on, as the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..core.engine.plan import resolve_device
from . import encdec as ED
from . import recurrent as RG
from . import transformer as TF
from . import xlstm as XL
from .layers import Compute
from .transformer import lm_loss

__all__ = ["init", "train_logits", "prefill", "decode", "make_inputs",
           "input_specs", "param_shapes", "lm_loss", "TensorSpec"]

_INIT = {"dense": TF.init_lm, "moe": TF.init_lm, "vlm": TF.init_lm,
         "hybrid": RG.init_hybrid, "ssm": XL.init_xlstm,
         "encdec": ED.init_encdec}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one model input (the port's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _init_fn(cfg: ModelConfig):
    if cfg.family not in _INIT:
        raise ValueError(cfg.family)
    return _INIT[cfg.family]


def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         keep=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (default: the card).  ``keep(path, leaf)`` takes each leaf
    as it is drawn (``layers.keep_tree``): a sharded initialisation keeps
    its part of the same numbers."""
    init_fn = _init_fn(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if keep is None:
        return init_fn(cfg, gen, device=device)
    return init_fn(cfg, gen, device=device, keep=keep)


def param_shapes(cfg: ModelConfig) -> dict:
    """The nested shape tree of ``init``'s parameters (all float32), from
    the initialiser run on the meta device: no memory, no numbers."""
    params = _init_fn(cfg)(cfg, torch.Generator(), device="meta")
    return _tree_map(lambda x: tuple(x.shape), params)


def train_logits(params, cfg: ModelConfig, batch: dict, *, mesh=None,
                 weights=None):
    """The training forward pass: (logits, aux_loss), differentiable in
    ``params`` (leaves that require grad).  ``weights(path, tree)`` (each
    family's per-layer gather, as ``transformer.forward`` takes it) is the
    sharded train step's."""
    if cfg.family in ("dense", "moe", "vlm"):
        prefix = batch["patches"] if cfg.family == "vlm" else None
        logits, _, aux = TF.forward(params, cfg, batch["tokens"],
                                    prefix_embeds=prefix, mesh=mesh,
                                    weights=weights)
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]         # text positions
        return logits, aux
    if cfg.family == "hybrid":
        logits, _, aux = RG.forward_hybrid(params, cfg, batch["tokens"],
                                           mesh=mesh, weights=weights)
        return logits, aux
    if cfg.family == "ssm":
        logits, _, aux = XL.forward_xlstm(params, cfg, batch["tokens"],
                                          mesh=mesh, weights=weights)
        return logits, aux
    if cfg.family == "encdec":
        logits, _, aux = ED.forward_encdec(params, cfg, batch["frames"],
                                           batch["tokens"], mesh=mesh,
                                           weights=weights)
        return logits, aux
    raise ValueError(cfg.family)


def prefill(params, cfg: ModelConfig, batch: dict, *, mesh=None,
            last_only: bool = True, attn_route: str = "auto"):
    """Prompt ingestion.  The transformer families and the enc-dec decoder
    prefill into a cache exactly the prompt's length, so their
    self-attention takes the fused kernel B9 on the card; the hybrid and
    ssm families return no state (as the reference).  ``last_only``
    (default) emits the final position's logits only; ``attn_route``
    (``"auto"``, ``"kernel"`` or ``"blockwise"``) picks the attention
    route (``layers.attention``)."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    if cfg.family in ("dense", "moe", "vlm"):
        prefix = batch["patches"] if cfg.family == "vlm" else None
        n_prefix = 0 if prefix is None else prefix.shape[1]
        cache = TF.init_cache(cfg, b, t + n_prefix, device=tokens.device)
        logits, cache, _ = TF.forward(params, cfg, tokens,
                                      prefix_embeds=prefix, cache=cache,
                                      last_only=last_only,
                                      attn_route=attn_route, mesh=mesh)
        return logits, cache
    if cfg.family == "hybrid":
        logits, _, _ = RG.forward_hybrid(params, cfg, tokens,
                                         last_only=last_only, mesh=mesh)
        return logits, None
    if cfg.family == "ssm":
        logits, _, _ = XL.forward_xlstm(params, cfg, tokens,
                                        last_only=last_only, mesh=mesh)
        return logits, None
    if cfg.family == "encdec":
        cache = ED.init_encdec_cache(cfg, b, t, device=tokens.device)
        logits, cache, _ = ED.forward_encdec(params, cfg, batch["frames"],
                                             tokens, cache=cache,
                                             last_only=last_only,
                                             attn_route=attn_route,
                                             mesh=mesh)
        return logits, cache
    raise ValueError(cfg.family)


def decode(params, cfg: ModelConfig, batch: dict, *, mesh=None):
    """One decode step; the batch's cache or state is updated in place."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TF.decode_step(params, cfg, batch["cache"], batch["tokens"],
                              batch["pos"], mesh=mesh)
    if cfg.family == "hybrid":
        return RG.decode_step_hybrid(params, cfg, batch["state"],
                                     batch["tokens"], batch["pos"],
                                     mesh=mesh)
    if cfg.family == "ssm":
        return XL.decode_step_xlstm(params, cfg, batch["state"],
                                    batch["tokens"], batch["pos"], mesh=mesh)
    if cfg.family == "encdec":
        return ED.decode_step_encdec(params, cfg, batch["cache"],
                                     batch["memory"], batch["tokens"],
                                     batch["pos"], mesh=mesh)
    raise ValueError(cfg.family)


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def _token_split(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """How a shape's seq_len budget maps to this family's streams."""
    t, b = shape.seq_len, shape.global_batch
    if cfg.family == "encdec":
        return {"enc": t // 2, "dec": t // 2, "batch": b}
    if cfg.family == "vlm":
        npatch = cfg.n_patches or 256
        return {"patches": npatch, "text": t - npatch, "batch": b}
    return {"text": t, "batch": b}


def _specs_of(tree: dict) -> dict:
    return _tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype), tree)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """TensorSpec stand-ins for every model input of this cell."""
    sp = _token_split(cfg, shape)
    b = sp["batch"]
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out = {"frames": TensorSpec((b, sp["enc"], cfg.d_model), Compute),
                   "tokens": TensorSpec((b, sp["dec"]), i32)}
            if shape.kind == "train":
                out["labels"] = TensorSpec((b, sp["dec"]), i32)
            return out
        out = {"tokens": TensorSpec((b, sp["text"]), i32)}
        if cfg.family == "vlm":
            out["patches"] = TensorSpec((b, sp["patches"], cfg.d_model),
                                        Compute)
        if shape.kind == "train":
            out["labels"] = TensorSpec((b, sp["text"]), i32)
        return out

    # decode shapes: one new token against a seq_len-deep cache/state
    out = {"tokens": TensorSpec((b, 1), i32), "pos": TensorSpec((), i32)}
    cshape = (cfg.n_layers, b, shape.seq_len, cfg.n_kv_heads, cfg.hd)
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        out["cache"] = {"k": TensorSpec(cshape, Compute),
                        "v": TensorSpec(cshape, Compute)}
    if cfg.family == "encdec":
        out["memory"] = TensorSpec((b, cfg.enc_frames_decode, cfg.d_model),
                                   Compute)
    elif cfg.family == "hybrid":
        out["state"] = _specs_of(RG.init_hybrid_state(cfg, b, device="meta"))
    elif cfg.family == "ssm":
        out["state"] = _specs_of(XL.init_xlstm_state(cfg, b, device="meta"))
    return out


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
