"""Decoder-only LM: dense, MoE, and vision-prefixed (VLM) variants, over
stacked per-layer parameters.

The port of the JAX package's ``models/transformer.py``.  Parameters keep
the JAX names and the stacked ``[L, ...]`` layout, so one checkpoint tree
feeds both packages (``models.convert.params_from_jax``); a Python loop over
layers takes the place of ``lax.scan``.  The same ``forward`` serves
training (no cache; each layer's body under ``cfg.remat_policy``,
``layers.remat``) and prefill (a zero cache passed in, filled in place and
returned); ``decode_step`` consumes one token block against the cache, also
in place.  MoE layers run ``models.moe.moe_mlp``: its local path, or
expert parallelism on an LM mesh.

On an LM mesh (``mesh=``) the layers run the partitioned program over its
"model" axis: tensor parallelism of the attention heads, the MLP's hidden
width and the vocab (``layers``), expert parallelism of the MoE layers,
each leaf of ``params`` this rank's shard as ``distributed.sharding
.param_specs`` places it on "model" (a leaf given whole computes as on one
device).  The rows are the caller's: ``models.api`` and the train step
split the batch over the data axes before they call in, and ``weights``
gathers each leaf over "data".
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .moe import init_moe, moe_mlp

__all__ = ["init_lm", "forward", "init_cache", "decode_step", "lm_loss",
           "cache_block", "model_axis", "embed_tokens", "head_logits",
           "attn_heads"]


def init_layer(cfg: ModelConfig, gen: torch.Generator, *, device) -> dict:
    p = {
        "ln1": L.init_rmsnorm(cfg.d_model, device=device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, device=device),
        "ln2": L.init_rmsnorm(cfg.d_model, device=device),
    }
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            device=device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device)
    return p


def init_lm(cfg: ModelConfig, gen: torch.Generator, *, device,
            keep=None) -> dict:
    """Random parameters from ``gen`` on ``device`` (the JAX initialisers'
    distributions; not their numbers); ``keep`` as ``layers.keep_tree``."""
    layers = L.stack_trees([
        L.keep_tree(keep, ("layers",), init_layer(cfg, gen, device=device))
        for _ in range(cfg.n_layers)])
    params = {
        "embed": L.keep_tree(keep, ("embed",), L.init_embedding(
            gen, cfg.padded_vocab, cfg.d_model, device=device)),
        "layers": layers,
        "final_norm": L.keep_tree(keep, ("final_norm",), L.init_rmsnorm(
            cfg.d_model, device=device)),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.keep_tree(keep, ("head",), L.init_dense(
            gen, cfg.d_model, cfg.padded_vocab, device=device))
    return params


def model_axis(mesh):
    """The "model" axis of an LM mesh as a mesh of its own (``None``
    without a mesh or without that axis)."""
    if mesh is None or "model" not in tuple(mesh.mesh_dim_names or ()):
        return None
    return mesh if tuple(mesh.mesh_dim_names) == ("model",) \
        else mesh.submesh(("model",))


def attn_heads(cfg: ModelConfig) -> tuple:
    """(n_heads, n_kv_heads, head_dim): an attention layer's whole counts,
    as ``layers.attention(heads=)`` takes them."""
    return cfg.n_heads, cfg.n_kv_heads, cfg.hd


def cache_block(cfg: ModelConfig, mesh=None) -> tuple[int, int]:
    """(kv heads, head_dim) of a rank's cache on ``mesh``'s "model" axis
    (any mesh, or a ``MeshLayout``).  Where the rules split the query
    heads: the kv heads they read (``sharding.model_heads``; as many on
    every rank), whole, where ``cache_specs`` would split head_dim at K <
    m (the rank attends with whole heads; a placement the port keeps, see
    ROADMAP).  Where the query heads do not divide "model" and head_dim
    does: every kv head's H / m columns (``sharding.model_head_dim``), as
    ``cache_specs`` and ``state_specs`` place them.  Otherwise the whole
    layer's."""
    from ..distributed.sharding import model_head_dim, model_heads
    m = L.model_size(mesh)
    span = model_head_dim(cfg.n_heads, cfg.hd, m, 0)
    if span is not None:
        return cfg.n_kv_heads, span[1]
    plan = model_heads(cfg.n_heads, cfg.n_kv_heads, m, 0)
    return (cfg.n_kv_heads if plan is None else plan[3]), cfg.hd


def _layer_body(cfg: ModelConfig, x, p, *, positions, cache=None,
                cache_index: int = 0, attn_route: str = "auto", mesh=None,
                weights=None):
    if weights is not None:
        p = weights(("layers",), p)
    h, _ = L.attention(
        p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps), positions=positions,
        rope_theta=cfg.rope_theta, window=cfg.attn_window, cache=cache,
        cache_index=cache_index, attn_route=attn_route, mesh=mesh,
        heads=attn_heads(cfg))
    x = x + h
    hn = L.rms_norm(p["ln2"], x, cfg.norm_eps)
    if cfg.n_experts:
        h, aux = moe_mlp(p["moe"], hn, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, mesh=mesh)
    else:
        h, aux = L.swiglu_mlp(p["mlp"], hn, mesh=mesh, d_ff=cfg.d_ff), None
    return x + h, aux


def embed_tokens(params: dict, cfg: ModelConfig, tokens, mesh=None,
                 weights=None):
    """The embedding of ``tokens`` (vocab-parallel on ``mesh``'s "model"
    axis, ``layers.embed_tp``); every family's."""
    p = params["embed"] if weights is None else weights(
        ("embed",), params["embed"])
    return L.embed_tp(p, tokens, vocab=cfg.padded_vocab, mesh=mesh)


def head_logits(params: dict, cfg: ModelConfig, x, weights=None,
                mesh=None):
    """The final norm and the head (the tied table where
    ``cfg.tie_embeddings``): on ``mesh``'s "model" axis the rank's vocab
    slice of the logits (``layers.logits_tp``); the decoder-only
    families'."""
    if weights is not None:
        params = {k: weights((k,), params[k]) for k in (
            "final_norm", "embed" if cfg.tie_embeddings else "head")}
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    w = params["embed"]["table"].t() if cfg.tie_embeddings \
        else params["head"]["w"]
    return L.logits_tp(w, x, vocab=cfg.padded_vocab, mesh=mesh)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, last_only: bool = False,
            attn_route: str = "auto", mesh=None, weights=None):
    """tokens [B, T] -> (logits [B, T(+Np) or 1, V_pad], cache, aux_loss).

    ``prefix_embeds`` [B, Np, D] (VLM patch embeddings) are prepended.
    With ``cache`` (zero-initialised, [L, B, S, K, H] leaves) this is a
    prefill: the prompt's K/V fill the cache's first T positions in place.
    ``last_only`` emits the final position's logits only; ``attn_route``
    (``"auto"``, ``"kernel"`` or ``"blockwise"``) picks the prefill's
    attention route (``layers.attention``).  ``aux_loss`` is the MoE
    load-balancing loss summed over layers (0 without experts).

    ``mesh`` (an LM mesh, ``launch.mesh.LMMesh``): the partitioned program
    over its "model" axis (see the module's docstring); ``tokens`` are the
    rows this rank computes.  ``weights(path, tree)`` (the sharded step's
    and mesh serving's FSDP gather) gathers each layer's parameters over
    "data" inside its rematerialised body, so the backward pass gathers
    them again, and the embedding's and head's just before use.
    The logits are then the rank's vocab slice ``[..., V_pad / m]``:
    serving gathers them (``layers.whole_vocab``), the sharded train
    step's loss reduces them (``layers.vocab_parallel_nll``).
    """
    mesh = model_axis(mesh)
    x = embed_tokens(params, cfg, tokens, mesh, weights)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    body = L.remat(functools.partial(_layer_body, cfg, mesh=mesh,
                                     weights=weights), cfg.remat_policy)
    for i, p in enumerate(L.unstack_tree(params["layers"])):
        c = None if cache is None else {"k": cache["k"][i],
                                        "v": cache["v"][i]}
        x, a = body(x, p, positions=positions, cache=c,
                    attn_route=attn_route)
        if a is not None:
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    return head_logits(params, cfg, x, weights, mesh), cache, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device, mesh=None) -> dict:
    """A zero cache [L, batch, max_len, K, H]; on ``mesh`` (K, H) is this
    rank's block (``cache_block``)."""
    shape = (cfg.n_layers, batch, max_len, *cache_block(cfg, mesh))
    return {"k": torch.zeros(shape, dtype=L.Compute, device=device),
            "v": torch.zeros(shape, dtype=L.Compute, device=device)}


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int, *, mesh=None, weights=None):
    """tokens [B, t] (t small) at position ``pos`` -> (logits, cache); the
    cache is updated in place.  ``mesh`` and ``weights`` as
    ``forward``'s."""
    pos = int(pos)
    mesh = model_axis(mesh)
    x = embed_tokens(params, cfg, tokens, mesh, weights)
    t = x.shape[1]
    positions = pos + torch.arange(t, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x, _ = _layer_body(cfg, x, L.index_tree(params["layers"], i),
                           positions=positions,
                           cache={"k": cache["k"][i], "v": cache["v"][i]},
                           cache_index=pos, mesh=mesh, weights=weights)
    return head_logits(params, cfg, x, weights, mesh), cache


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32; labels < 0 are ignored."""
    if mask is not None:
        labels = torch.where(mask, labels, -1)
    nll, count = L.vocab_parallel_nll(logits, labels, vocab=logits.shape[-1])
    return nll / torch.clamp(count, min=1)
