"""Functional NN layers: GQA attention (+RoPE, windows, KV cache), SwiGLU,
RMSNorm, embeddings.

The port of the JAX package's ``models/layers.py``: pure functions over
parameter dicts of float32 tensors, cast to the bf16 compute dtype at use,
with float32 softmax and norm accumulation.  The ``init_*`` functions draw
from an explicit ``torch.Generator`` on an explicit device (the numbers
differ from ``jax.random``; tests share weights through
``models.convert.params_from_jax``).

Unlike the JAX layers, ``attention`` writes the new keys and values into
the cache tensors it is given, in place, instead of returning updated
copies: a decode step then moves one token's K/V, not the whole cache.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .attention_core import direct_attention, flash_attention

__all__ = [
    "Compute", "init_dense", "dense", "init_rmsnorm", "rms_norm",
    "init_embedding", "embed", "unembed", "rope", "init_attention",
    "attention", "init_kv_cache_layer", "init_mlp", "swiglu_mlp",
    "truncated_normal",
]

Compute = torch.bfloat16


def truncated_normal(gen: torch.Generator, shape, scale: float, *,
                     device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale`` (float32)."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(scale)


def init_dense(gen, d_in: int, d_out: int, *, scale: Optional[float] = None,
               device):
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": truncated_normal(gen, (d_in, d_out), scale, device=device)}


def dense(p, x):
    return torch.matmul(x, p["w"].to(Compute))


def init_rmsnorm(d: int, *, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(p, x, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p["scale"]
    return out.to(Compute)


def init_embedding(gen, vocab: int, d: int, *, device):
    return {"table": truncated_normal(gen, (vocab, d), 1.0, device=device)}


def embed(p, tokens):
    return p["table"].to(Compute)[tokens.long()]


def unembed(p, x):
    return torch.matmul(x, p["table"].to(Compute).t())


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding. x [..., T, H, D]; positions [..., T]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., :, None, None].float() * freq  # [..., T, 1, half]
    sin, cos = torch.sin(angle), torch.cos(angle)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA; full-causal or local-window)
# --------------------------------------------------------------------------

def init_attention(gen, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, *, device):
    s = d_model ** -0.5
    return {
        "wq": truncated_normal(gen, (d_model, n_heads, head_dim), s,
                               device=device),
        "wk": truncated_normal(gen, (d_model, n_kv, head_dim), s,
                               device=device),
        "wv": truncated_normal(gen, (d_model, n_kv, head_dim), s,
                               device=device),
        "wo": truncated_normal(gen, (n_heads, head_dim, d_model),
                               (n_heads * head_dim) ** -0.5, device=device),
    }


def init_kv_cache_layer(batch: int, n_kv: int, max_len: int, head_dim: int,
                        *, device):
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=Compute, device=device),
            "v": torch.zeros(shape, dtype=Compute, device=device)}


ATTN_ROUTES = ("auto", "kernel", "blockwise")


def _kernel_route(x, attn_route: str) -> bool:
    """Whether a full-prompt prefill takes the fused kernel B9.

    ``"auto"`` (default) takes B9 for CUDA tensors and the blockwise torch
    path otherwise; ``"kernel"`` forces B9's route, which on CPU tensors
    runs B9's plain version (as the JAX package's interpret mode does);
    ``"blockwise"`` never takes it.
    """
    if attn_route not in ATTN_ROUTES:
        raise ValueError(f"attn_route must be one of {ATTN_ROUTES}, got "
                         f"{attn_route!r}")
    return attn_route == "kernel" or (attn_route == "auto"
                                      and x.device.type == "cuda")


def attention(p, x, *, positions, rope_theta: float, window: int = 0,
              cache: Optional[dict] = None, cache_index: int = 0,
              causal: bool = True, q_block: int = 512, kv_block: int = 1024,
              attn_route: str = "auto"):
    """GQA self-attention.

    x [B, T, D].  Without ``cache``: causal (or bidirectional) attention
    over x.  With ``cache`` ({"k", "v"} [B, S, n_kv, hd] bf16): the new K/V
    are written into it at ``cache_index`` (in place) and x attends to the
    first ``cache_index + T`` positions.  A prefill whose cache is exactly
    the prompt (T == S > 16) runs the fused kernel B9 on the card; other
    long queries run the blockwise path, short (decode) queries the direct
    path; ``attn_route`` picks the prefill's route (``_kernel_route``).
    Returns (out [B, T, D], cache).
    """
    from ..kernels import ops as kops

    b, t, d = x.shape
    q = torch.einsum("btd,dnh->btnh", x, p["wq"].to(Compute))
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"].to(Compute))
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"].to(Compute))
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)

    kv_valid = None
    q_offset = 0
    if cache is not None:
        cache["k"][:, cache_index:cache_index + t] = k
        cache["v"][:, cache_index:cache_index + t] = v
        k, v = cache["k"], cache["v"]
        kv_valid = cache_index + t
        q_offset = cache_index

    n_heads = q.shape[2]
    n_kv = k.shape[2]
    group = n_heads // n_kv
    hd = q.shape[-1]
    qg = q.reshape(b, t, n_kv, group, hd)
    if cache is not None and t > 16 and t == k.shape[1] \
            and _kernel_route(x, attn_route):
        # prefill: the full prompt, kv_valid == t, so the kernel mask is
        # exact; kv heads go over unrepeated, head h reading kv head h // g
        qf = qg.permute(0, 2, 3, 1, 4).reshape(b * n_heads, t, hd)
        kf = k.permute(0, 2, 1, 3).reshape(b * n_kv, t, hd)
        vf = v.permute(0, 2, 1, 3).reshape(b * n_kv, t, hd)
        ctx = kops.flash_attn(qf, kf, vf, causal=causal, window=window,
                              group=group)
        ctx = ctx.reshape(b, n_kv, group, t, hd).permute(0, 3, 1, 2, 4)
    elif t > 16:
        ctx = flash_attention(qg, k, v, q_offset=q_offset, causal=causal,
                              window=window, kv_valid=kv_valid,
                              q_block=q_block, kv_block=kv_block)
    else:
        ctx = direct_attention(qg, k, v, q_offset=q_offset, causal=causal,
                               window=window, kv_valid=kv_valid)
    ctx = ctx.reshape(b, t, n_heads, hd)
    out = torch.einsum("btnh,nhd->btd", ctx, p["wo"].to(Compute))
    return out, cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, *, device):
    return {
        "wi_gate": truncated_normal(gen, (d_model, d_ff), d_model ** -0.5,
                                    device=device),
        "wi_up": truncated_normal(gen, (d_model, d_ff), d_model ** -0.5,
                                  device=device),
        "wo": truncated_normal(gen, (d_ff, d_model), d_ff ** -0.5,
                               device=device),
    }


def swiglu_mlp(p, x):
    gate = torch.matmul(x, p["wi_gate"].to(Compute))
    up = torch.matmul(x, p["wi_up"].to(Compute))
    return torch.matmul(F.silu(gate) * up, p["wo"].to(Compute))
