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
batch and gets the whole result) runs the partitioned program of the
reference's sharding rules.  ``params`` are this rank's blocks as
``distributed.sharding.param_specs`` places them (``init(...,
keep=distributed.sharding.param_keep(mesh))``, or ``convert
.params_from_jax(..., mesh=mesh)``).  Each rank computes its rows of the
batch over ("pod", "data") where ``batch_specs`` splits them (``dp_rows``),
with its own cache or state of those rows; only the returned logits are
gathered over those axes.  Every family runs tensor parallelism over
"model" (heads, hidden width and vocab; the MoE layers' experts under
expert parallelism; the RG-LRU's and the sLSTM's channels, the mLSTM's
heads), each layer gathering its leaves over "data" just before use
(FSDP) and keeping its "model" shard.  Where a layer's heads do not
divide "model" and its head_dim does (recurrentgemma-2b's attention and
xlstm-1.3b's mLSTM at m = 16), the rules split its leaves on head_dim and
the rank computes with its head_dim / m columns of every head
(``sharding.model_head_dim``; ``layers._model_parallel``, the mLSTM's
``xlstm._mlstm_head_dim``).  A cache or state holds the rank's rows and
its part over "model" (``transformer.cache_block``: the transformer's and
the enc-dec decoder's cache, the hybrid's ring; ``xlstm.state_block``):
the kv heads its query heads read, or every kv head's head_dim / m
columns where the heads do not divide "model"; the RG-LRU's d_rnn / m
and the sLSTM's D / m channels; the mLSTM's heads, or its ``C``'s value
columns and ``n``'s key columns, as ``state_specs`` places them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..core.engine.plan import resolve_device
from . import encdec as ED
from . import recurrent as RG
from . import transformer as TF
from . import layers as L
from . import xlstm as XL
from .layers import Compute
from .transformer import lm_loss

__all__ = ["init", "train_logits", "prefill", "decode", "make_inputs",
           "input_specs", "param_shapes", "lm_loss", "TensorSpec",
           "MeshRows"]

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


def _tree_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


class MeshRows:
    """How one call of the model runs on an LM mesh: this rank's rows of a
    batch of ``batch`` rows (``sharding.dp_rows``) and the FSDP gather of
    its parameters (``weights``).  ``take`` cuts a whole-batch leaf to the
    rows, ``whole`` gathers a result's rows over the data axes."""

    def __init__(self, cfg: ModelConfig, mesh, batch: int):
        from ..distributed import sharding as shr
        from ..launch import mesh as lm
        self.mesh = mesh
        self.rows = shr.dp_rows(mesh, batch)
        self.dp = lm.dp_axes(mesh)
        self.specs = _param_specs(cfg, tuple(mesh.shape),
                                  tuple(mesh.mesh_dim_names))

    def take(self, x):
        if self.rows is None or not isinstance(x, torch.Tensor) \
                or x.dim() == 0:
            return x
        return x.narrow(0, *self.rows)

    def whole(self, x):
        from ..launch import mesh as lm
        if self.rows is None:
            return x
        return lm.all_gather(x, self.mesh, self.dp, 0)

    def _gather(self, path, x, stacked: bool):
        from ..distributed import sharding as shr
        from ..launch import mesh as lm
        if "moe" in path and path[-1] in shr.MOE_EXPERT_KEYS:
            return x                      # expert parallelism's own shard
        spec = self.specs
        for k in path:
            spec = spec[k]
        sh = [(a, d - 1 if stacked else d)
              for a, d in shr.shards_of(spec, self.mesh) if a != "model"]
        if not sh:
            return x
        # cast where the layers would: half the bytes (the leaves the
        # layers read in float32, norms and the RG-LRU's ``lam``, are never
        # split over "data")
        return lm.gather_shards(x.to(L.Compute), self.mesh, sh)

    def weights(self, path: tuple, tree):
        """The ``weights(path, tree)`` hook of every family's forward and
        decode step: each leaf gathered over "data" (its "model" shard
        kept); under a stack key, ``tree`` is one entry of the stack."""
        from ..distributed.sharding import STACK_KEYS
        stacked = bool(path) and path[0] in STACK_KEYS
        return _tree_paths(lambda sub, x: self._gather(path + sub, x,
                                                       stacked), tree)


@functools.lru_cache(maxsize=None)
def _param_specs(cfg: ModelConfig, shape: tuple, names: tuple):
    """``param_specs`` of ``cfg``'s parameters on a mesh of ``shape``
    (read only: every call of a mesh shape shares it)."""
    from ..distributed.sharding import param_specs
    from ..launch.mesh import MeshLayout
    return param_specs(param_shapes(cfg), MeshLayout(shape, names))


def train_logits(params, cfg: ModelConfig, batch: dict, *, mesh=None,
                 weights=None):
    """The training forward pass: (logits, aux_loss), differentiable in
    ``params`` (leaves that require grad).  ``weights(path, tree)`` (each
    family's per-layer gather, as ``transformer.forward`` takes it) is the
    sharded train step's.  On ``mesh`` the logits are this rank's vocab
    slice over "model" (``layers.vocab_parallel_nll`` reduces them)."""
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
    route (``layers.attention``).  On ``mesh`` (see the module's
    docstring) the logits are whole and the cache is this rank's."""
    on = None if mesh is None else MeshRows(cfg, mesh, batch["tokens"]
                                            .shape[0])
    weights = None
    if on is not None:
        batch = {k: on.take(v) for k, v in batch.items()}
        weights = on.weights
    tokens = batch["tokens"]
    b, t = tokens.shape
    if cfg.family in ("dense", "moe", "vlm"):
        prefix = batch["patches"] if cfg.family == "vlm" else None
        n_prefix = 0 if prefix is None else prefix.shape[1]
        cache = TF.init_cache(cfg, b, t + n_prefix, device=tokens.device,
                              mesh=mesh)
        logits, cache, _ = TF.forward(params, cfg, tokens,
                                      prefix_embeds=prefix, cache=cache,
                                      last_only=last_only,
                                      attn_route=attn_route, mesh=mesh,
                                      weights=weights)
    elif cfg.family == "hybrid":
        logits, _, _ = RG.forward_hybrid(params, cfg, tokens,
                                         last_only=last_only, mesh=mesh,
                                         weights=weights)
        cache = None
    elif cfg.family == "ssm":
        logits, _, _ = XL.forward_xlstm(params, cfg, tokens,
                                        last_only=last_only, mesh=mesh,
                                        weights=weights)
        cache = None
    elif cfg.family == "encdec":
        cache = ED.init_encdec_cache(cfg, b, t, device=tokens.device,
                                     mesh=mesh)
        logits, cache, _ = ED.forward_encdec(params, cfg, batch["frames"],
                                             tokens, cache=cache,
                                             last_only=last_only,
                                             attn_route=attn_route,
                                             mesh=mesh, weights=weights)
    else:
        raise ValueError(cfg.family)
    return _whole(logits, cfg, mesh, on), cache


def decode(params, cfg: ModelConfig, batch: dict, *, mesh=None):
    """One decode step; the batch's cache or state is updated in place.
    On ``mesh`` the tokens are the whole batch's, the cache or state this
    rank's (``prefill``'s), and the logits whole."""
    on = None if mesh is None else MeshRows(cfg, mesh, batch["tokens"]
                                            .shape[0])
    weights = None
    tokens = batch["tokens"]
    memory = batch.get("memory")
    if on is not None:
        tokens, memory = on.take(tokens), on.take(memory)
        weights = on.weights
    if cfg.family in ("dense", "moe", "vlm"):
        logits, out = TF.decode_step(params, cfg, batch["cache"], tokens,
                                     batch["pos"], mesh=mesh,
                                     weights=weights)
    elif cfg.family == "hybrid":
        logits, out = RG.decode_step_hybrid(params, cfg, batch["state"],
                                            tokens, batch["pos"], mesh=mesh,
                                            weights=weights)
    elif cfg.family == "ssm":
        logits, out = XL.decode_step_xlstm(params, cfg, batch["state"],
                                           tokens, batch["pos"], mesh=mesh,
                                           weights=weights)
    elif cfg.family == "encdec":
        logits, out = ED.decode_step_encdec(params, cfg, batch["cache"],
                                            memory, tokens, batch["pos"],
                                            mesh=mesh, weights=weights)
    else:
        raise ValueError(cfg.family)
    return _whole(logits, cfg, mesh, on), out


def _whole(logits, cfg: ModelConfig, mesh, on):
    """A mesh's logits made whole: the vocab over "model", then the rows
    over the data axes (``MeshRows.whole``)."""
    if on is None:
        return logits
    logits = L.whole_vocab(logits, vocab=cfg.padded_vocab,
                           mesh=TF.model_axis(mesh))
    return on.whole(logits)


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


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> dict:
    """TensorSpec stand-ins for every model input of this cell.  On
    ``mesh`` a decode cell's cache or state is this rank's, as ``prefill``
    leaves it or ``decode`` takes it (its rows and its part over "model";
    see the module's docstring); every other leaf stays whole (SPMD)."""
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
    rows = b
    if mesh is not None:
        from ..distributed.sharding import dp_parts
        rows = b // dp_parts(mesh, b)
    cshape = (cfg.n_layers, rows, shape.seq_len, *TF.cache_block(cfg, mesh))
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        out["cache"] = {"k": TensorSpec(cshape, Compute),
                        "v": TensorSpec(cshape, Compute)}
    if cfg.family == "encdec":
        out["memory"] = TensorSpec((b, cfg.enc_frames_decode, cfg.d_model),
                                   Compute)
    elif cfg.family == "hybrid":
        out["state"] = _specs_of(RG.init_hybrid_state(cfg, rows,
                                                      device="meta",
                                                      mesh=mesh))
    elif cfg.family == "ssm":
        out["state"] = _specs_of(XL.init_xlstm_state(cfg, rows,
                                                     device="meta",
                                                     mesh=mesh))
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
