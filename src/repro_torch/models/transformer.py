"""Decoder-only LM (the dense family) over stacked per-layer parameters.

The port of the JAX package's ``models/transformer.py``.  Parameters keep
the JAX names and the stacked ``[L, ...]`` layout, so one checkpoint tree
feeds both packages (``models.convert.params_from_jax``); a Python loop over
layers takes the place of ``lax.scan``.  The same ``forward`` serves
training (no cache) and prefill (a zero cache passed in, filled in place and
returned); ``decode_step`` consumes one token block against the cache, also
in place.  MoE layers are not ported yet (ROADMAP A15, ``models/moe.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from . import layers as L

__all__ = ["init_lm", "param_shapes", "forward", "init_cache", "decode_step",
           "lm_loss"]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP "
                                  "A15, models/moe.py)")


def param_shapes(cfg: ModelConfig) -> dict:
    """The nested shape tree of ``init_lm``'s parameters (all float32)."""
    _dense_only(cfg)
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    shapes = {
        "embed": {"table": (cfg.padded_vocab, d)},
        "layers": {
            "ln1": {"scale": (n, d)},
            "attn": {"wq": (n, d, cfg.n_heads, hd),
                     "wk": (n, d, cfg.n_kv_heads, hd),
                     "wv": (n, d, cfg.n_kv_heads, hd),
                     "wo": (n, cfg.n_heads, hd, d)},
            "ln2": {"scale": (n, d)},
            "mlp": {"wi_gate": (n, d, cfg.d_ff), "wi_up": (n, d, cfg.d_ff),
                    "wo": (n, cfg.d_ff, d)},
        },
        "final_norm": {"scale": (d,)},
    }
    if not cfg.tie_embeddings:
        shapes["head"] = {"w": (d, cfg.padded_vocab)}
    return shapes


def init_lm(cfg: ModelConfig, gen: torch.Generator, *, device) -> dict:
    """Random parameters from ``gen`` on ``device`` (the JAX initialisers'
    distributions; not their numbers)."""
    _dense_only(cfg)
    layers = [{
        "ln1": L.init_rmsnorm(cfg.d_model, device=device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, device=device),
        "ln2": L.init_rmsnorm(cfg.d_model, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device),
    } for _ in range(cfg.n_layers)]
    stacked = {grp: {name: torch.stack([lay[grp][name] for lay in layers])
                     for name in layers[0][grp]} for grp in layers[0]}
    params = {
        "embed": L.init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                  device=device),
        "layers": stacked,
        "final_norm": L.init_rmsnorm(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.init_dense(gen, cfg.d_model, cfg.padded_vocab,
                                      device=device)
    return params


def _layer(params: dict, i: int) -> dict:
    return {grp: {name: w[i] for name, w in ws.items()}
            for grp, ws in params["layers"].items()}


def _layer_body(cfg: ModelConfig, x, p, *, positions, cache=None,
                cache_index: int = 0, attn_route: str = "auto"):
    h, _ = L.attention(
        p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps), positions=positions,
        rope_theta=cfg.rope_theta, window=cfg.attn_window, cache=cache,
        cache_index=cache_index, attn_route=attn_route)
    x = x + h
    hn = L.rms_norm(p["ln2"], x, cfg.norm_eps)
    return x + L.swiglu_mlp(p["mlp"], hn)


def _logits(params: dict, cfg: ModelConfig, x):
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.dense(params["head"], x)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[dict] = None, last_only: bool = False,
            attn_route: str = "auto"):
    """tokens [B, T] -> (logits [B, T or 1, V_pad], cache, aux_loss).

    With ``cache`` (zero-initialised, [L, B, S, K, H] leaves) this is a
    prefill: the prompt's K/V fill the cache's first T positions in place.
    ``last_only`` emits the final position's logits only; ``attn_route``
    (``"auto"``, ``"kernel"`` or ``"blockwise"``) picks the prefill's
    attention route (``layers.attention``).
    """
    _dense_only(cfg)
    x = L.embed(params["embed"], tokens)
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        c = None if cache is None else {"k": cache["k"][i],
                                        "v": cache["v"][i]}
        x = _layer_body(cfg, x, _layer(params, i), positions=positions,
                        cache=c, attn_route=attn_route)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), cache, torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=L.Compute, device=device),
            "v": torch.zeros(shape, dtype=L.Compute, device=device)}


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens [B, t] (t small) at position ``pos`` -> (logits, cache); the
    cache is updated in place."""
    _dense_only(cfg)
    pos = int(pos)
    x = L.embed(params["embed"], tokens)
    t = x.shape[1]
    positions = pos + torch.arange(t, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x = _layer_body(cfg, x, _layer(params, i), positions=positions,
                        cache={"k": cache["k"][i], "v": cache["v"][i]},
                        cache_index=pos)
    return _logits(params, cfg, x), cache


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32; labels < 0 are ignored."""
    logits = logits.float()
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)
