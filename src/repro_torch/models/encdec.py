"""Encoder-decoder backbone (seamless-m4t-medium).

The port of the JAX package's ``models/encdec.py``.  The audio frontend is a
stub: batches carry precomputed frame embeddings [B, T_enc, D] for the
encoder.  The encoder is bidirectional and keeps no cache (the blockwise
attention path); the decoder is a causal stack with cross-attention to the
encoder memory.  A decoder prefill into a cache exactly the prompt's
length runs its self-attention on the fused kernel B9 on the card (as
``transformer.forward`` does); cross-attention runs blockwise in prefill
and directly in decode.  Layers are stacked ``[L, ...]`` under ``enc`` and
``dec``; a Python loop takes the place of ``lax.scan``, and the decoder's
cache is filled in place.  Training rematerialises each layer's body
(``layers.remat_all``) unless ``cfg.remat_policy`` is ``"none"``.

On an LM mesh (``mesh=``) every layer runs tensor parallelism over its
"model" axis as the transformer's does (``layers.attention``'s heads,
``swiglu_mlp``'s hidden columns, the vocab of the embedding and the
head), with the shards ``distributed.sharding.param_specs`` gives a rank
there.  Cross-attention splits its heads too: every rank holds the
encoder memory whole and projects the K/V of its own heads from it.  The
decoder's cache holds the rank's block (``transformer.cache_block``):
the kv heads its query heads read, or, where the heads do not divide
"model", every kv head's head_dim / m columns.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .transformer import attn_heads, cache_block, embed_tokens, model_axis

__all__ = ["init_encdec", "forward_encdec", "encode", "init_encdec_cache",
           "decode_step_encdec"]


def init_enc_layer(cfg: ModelConfig, gen, *, device) -> dict:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, device=device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, device=device),
        "ln2": L.init_rmsnorm(cfg.d_model, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def init_dec_layer(cfg: ModelConfig, gen, *, device) -> dict:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, device=device),
        "self": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, device=device),
        "ln_x": L.init_rmsnorm(cfg.d_model, device=device),
        "cross": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.hd, device=device),
        "ln2": L.init_rmsnorm(cfg.d_model, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def init_encdec(cfg: ModelConfig, gen: torch.Generator, *, device,
                keep=None) -> dict:
    """Random parameters from ``gen`` on ``device`` (the JAX initialisers'
    distributions; not their numbers); ``keep`` as ``layers.keep_tree``."""
    n_enc = cfg.n_enc_layers or cfg.n_layers
    embed = L.keep_tree(keep, ("embed",), L.init_embedding(
        gen, cfg.padded_vocab, cfg.d_model, device=device))
    enc = L.stack_trees([
        L.keep_tree(keep, ("enc",), init_enc_layer(cfg, gen, device=device))
        for _ in range(n_enc)])
    dec = L.stack_trees([
        L.keep_tree(keep, ("dec",), init_dec_layer(cfg, gen, device=device))
        for _ in range(cfg.n_layers)])
    return {
        "embed": embed,
        "enc": enc,
        "dec": dec,
        "enc_norm": L.keep_tree(keep, ("enc_norm",), L.init_rmsnorm(
            cfg.d_model, device=device)),
        "final_norm": L.keep_tree(keep, ("final_norm",), L.init_rmsnorm(
            cfg.d_model, device=device)),
        "head": L.keep_tree(keep, ("head",), L.init_dense(
            gen, cfg.d_model, cfg.padded_vocab, device=device)),
    }


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           weights=None, mesh=None) -> torch.Tensor:
    """frames [B, T_enc, D] (stubbed frontend output) -> memory [B, T_enc,
    D] (bf16), whole on every rank of ``mesh``.  ``weights`` and ``mesh``
    as ``forward_encdec``'s."""
    mesh = model_axis(mesh)
    x = frames.to(L.Compute)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = L.remat_all(functools.partial(
        _enc_layer, cfg, gather=None if weights is None
        else functools.partial(weights, ("enc",)), mesh=mesh),
        cfg.remat_policy)
    for p in L.unstack_tree(params["enc"]):
        x = body(x, p, positions)
    norm = params["enc_norm"] if weights is None else weights(
        ("enc_norm",), params["enc_norm"])
    return L.rms_norm(norm, x, cfg.norm_eps)


def _enc_layer(cfg, x, p, positions, gather=None, mesh=None):
    if gather is not None:
        p = gather(p)
    h, _ = L.attention(p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps),
                       positions=positions, rope_theta=cfg.rope_theta,
                       causal=False, mesh=mesh, heads=attn_heads(cfg))
    x = x + h
    return x + L.swiglu_mlp(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps),
                            mesh=mesh, d_ff=cfg.d_ff)


def _dec_layer(cfg, p, x, memory, *, positions, cache=None,
               cache_index: int = 0, attn_route: str = "auto", gather=None,
               mesh=None):
    if gather is not None:
        p = gather(p)
    h, _ = L.attention(p["self"], L.rms_norm(p["ln1"], x, cfg.norm_eps),
                       positions=positions, rope_theta=cfg.rope_theta,
                       cache=cache, cache_index=cache_index,
                       attn_route=attn_route, mesh=mesh, heads=attn_heads(cfg))
    x = x + h
    h, _ = L.attention(p["cross"], L.rms_norm(p["ln_x"], x, cfg.norm_eps),
                       positions=positions, rope_theta=cfg.rope_theta,
                       memory=memory, causal=False, mesh=mesh,
                       heads=attn_heads(cfg))
    x = x + h
    return x + L.swiglu_mlp(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps),
                            mesh=mesh, d_ff=cfg.d_ff)


def _logits(top: dict, cfg: ModelConfig, x, mesh):
    return L.logits_tp(top["head"]["w"], x, vocab=cfg.padded_vocab,
                       mesh=mesh)


def forward_encdec(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                   dec_tokens: torch.Tensor, *,
                   cache: Optional[dict] = None, last_only: bool = False,
                   attn_route: str = "auto", mesh=None, weights=None):
    """Teacher-forced training / prefill.  Returns (logits, cache, aux).
    ``mesh`` (an LM mesh): tensor parallelism over its "model" axis (see
    the module's docstring); ``frames`` and ``dec_tokens`` are the rows
    this rank computes.  ``weights(path, tree)`` (the FSDP gather of mesh
    serving and the sharded train step) gathers each layer's parameters
    over "data" inside its rematerialised body, and the embedding's, the
    norms' and the head's just before use.
    With ``cache`` ([L, B, S, K, H] leaves, zero; K the rank's kv heads on
    ``mesh``) the decoder's K/V fill its first T positions in place;
    ``attn_route`` picks the route of the decoder's prefill
    self-attention (``layers.attention``)."""
    mesh = model_axis(mesh)
    memory = encode(params, cfg, frames, weights, mesh)
    x = embed_tokens(params, cfg, dec_tokens, mesh, weights)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = L.remat_all(functools.partial(
        _dec_layer, cfg, gather=None if weights is None
        else functools.partial(weights, ("dec",)), mesh=mesh),
        cfg.remat_policy)
    for i, p in enumerate(L.unstack_tree(params["dec"])):
        c = None if cache is None else {"k": cache["k"][i],
                                        "v": cache["v"][i]}
        x = body(p, x, memory, positions=positions, cache=c,
                 attn_route=attn_route)
    top = params if weights is None else {
        k: weights((k,), params[k]) for k in ("final_norm", "head")}
    x = L.rms_norm(top["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return (_logits(top, cfg, x, mesh), cache,
            torch.zeros((), device=x.device))


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device, mesh=None) -> dict:
    """A zero decoder cache [L, batch, max_len, K, H]; on ``mesh`` (K, H)
    is this rank's block (``transformer.cache_block``)."""
    shape = (cfg.n_layers, batch, max_len, *cache_block(cfg, mesh))
    return {"k": torch.zeros(shape, dtype=L.Compute, device=device),
            "v": torch.zeros(shape, dtype=L.Compute, device=device)}


def decode_step_encdec(params: dict, cfg: ModelConfig, cache: dict,
                       memory: torch.Tensor, tokens: torch.Tensor, pos: int,
                       *, mesh=None, weights=None):
    """One-token decode against the self cache (updated in place) and the
    precomputed encoder memory.  Returns (logits, cache).  ``mesh`` and
    ``weights`` as ``forward_encdec``'s; the cache is this rank's
    (``init_encdec_cache(..., mesh=)``), ``memory`` its rows, whole."""
    pos = int(pos)
    mesh = model_axis(mesh)
    x = embed_tokens(params, cfg, tokens, mesh, weights)
    positions = pos + torch.arange(x.shape[1], device=x.device)[None, :]
    gather = None if weights is None else functools.partial(weights,
                                                            ("dec",))
    for i in range(cfg.n_layers):
        x = _dec_layer(cfg, L.index_tree(params["dec"], i), x, memory,
                       positions=positions,
                       cache={"k": cache["k"][i], "v": cache["v"][i]},
                       cache_index=pos, gather=gather, mesh=mesh)
    top = params if weights is None else {
        k: weights((k,), params[k]) for k in ("final_norm", "head")}
    x = L.rms_norm(top["final_norm"], x, cfg.norm_eps)
    return _logits(top, cfg, x, mesh), cache
