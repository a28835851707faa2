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

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.census_hooks import on_card
from .attention_core import direct_attention, flash_attention

__all__ = [
    "Compute", "init_dense", "dense", "init_rmsnorm", "rms_norm",
    "init_embedding", "embed", "unembed", "rope", "init_attention",
    "attention", "init_kv_cache_layer", "init_mlp", "swiglu_mlp",
    "truncated_normal", "stack_trees", "index_tree", "unstack_tree",
    "remat", "remat_all", "REMAT_POLICIES", "sigmoid", "silu", "gelu",
    "keep_tree",
]

Compute = torch.bfloat16


def truncated_normal(gen: torch.Generator, shape, scale: float, *,
                     device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale`` (float32)."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(scale)


def keep_tree(keep, path: tuple, tree):
    """``keep(path, leaf)`` on each leaf of a freshly drawn tree (``None``:
    the tree as it is).  The initialisers call it on each leaf as soon as
    it is drawn, so a sharded initialisation (``training.train_loop
    .init_train_state_sharded``) keeps this rank's part of each leaf and
    never holds more than one layer's leaves whole; the draws, and so the
    numbers, are the unsharded initialisation's."""
    if keep is None:
        return tree
    if isinstance(tree, dict):
        return {k: keep_tree(keep, path + (k,), v) for k, v in tree.items()}
    return keep(path, tree)


def stack_trees(trees: list) -> dict:
    """Equal nested dicts of tensors -> one dict of their leaves stacked on
    a new leading axis (the JAX package's ``vmap``-ed initialisers)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def index_tree(tree: dict, i: int) -> dict:
    """Entry ``i`` of every leaf of a stacked tree (views, not copies: a
    write to one writes to the stack)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_tree(tree: dict) -> list:
    """Every entry of a stacked tree, in order: ``torch.unbind`` of each
    leaf (views, as ``index_tree``'s).  A backward pass through it stacks
    the entries' gradients once; one ``index_tree`` per entry would fill a
    zero tensor of the whole stack for each."""
    if isinstance(tree, dict):
        parts = {k: unstack_tree(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


# --------------------------------------------------------------------------
# Rematerialisation (the JAX package's ``jax.checkpoint`` policies)
# --------------------------------------------------------------------------

REMAT_POLICIES = ("nothing", "dots", "none")
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the matmul outputs, recompute the rest
    (``dots_with_no_batch_dims_saveable``; einsum's batched products are
    ``bmm`` here and are kept too)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat(fn, policy: str):
    """``fn`` (a layer body) under a remat policy: ``"nothing"`` keeps only
    its inputs and recomputes the body in the backward pass, ``"dots"``
    keeps the matmul outputs as well, ``"none"`` keeps every activation.
    Remat changes memory, never values.  A call no gradient flows through
    (a prefill, a decode step) runs ``fn`` as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    if policy == "none":
        return fn
    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _save_matmuls) if policy == "dots" else None)
    kw_ctx = {} if context is None else {"context_fn": context}

    def body(*args, **kwargs):
        if not (torch.is_grad_enabled() and _needs_grad((args, kwargs))):
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, **kw_ctx, **kwargs)

    return body


def remat_all(fn, policy: str):
    """The hybrid, ssm and encdec families' rule: ``fn`` fully
    rematerialised unless ``policy`` is ``"none"`` (the reference's
    ``nothing_saveable`` whatever else the policy names)."""
    return remat(fn, "none" if policy == "none" else "nothing")


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
# Attention (GQA; full-causal, local-window, or cross)
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

    ``"auto"`` (default) takes B9 for CUDA tensors (and a trace of the
    card's program, ``kernels.census_hooks.on_card``) and the blockwise
    torch path otherwise; ``"kernel"`` forces B9's route, which on CPU
    tensors runs B9's plain version (as the JAX package's interpret mode
    does); ``"blockwise"`` never takes it.
    """
    if attn_route not in ATTN_ROUTES:
        raise ValueError(f"attn_route must be one of {ATTN_ROUTES}, got "
                         f"{attn_route!r}")
    return attn_route == "kernel" or (attn_route == "auto" and on_card(x))


def attention(p, x, *, positions, rope_theta: float, window: int = 0,
              cache: Optional[dict] = None, cache_index: int = 0,
              memory: Optional[torch.Tensor] = None, causal: bool = True,
              q_block: int = 512, kv_block: int = 1024,
              attn_route: str = "auto"):
    """GQA attention.

    x [B, T, D].  Without ``cache``: causal (or bidirectional) attention
    over x.  With ``memory`` [B, S, D]: cross-attention, K/V from memory,
    no rope, never causal.  With ``cache`` ({"k", "v"} [B, S, n_kv, hd]
    bf16): the new K/V are written into it at ``cache_index`` (in place)
    and x attends to the first ``cache_index + T`` positions.  A prefill
    whose cache is exactly the prompt (T == S > 16) runs the fused kernel
    B9 on the card; other long queries run the blockwise path, short
    (decode) queries the direct path; ``attn_route`` picks the prefill's
    route (``_kernel_route``).  Returns (out [B, T, D], cache).
    """
    from ..kernels import ops as kops

    b, t, d = x.shape
    q = torch.einsum("btd,dnh->btnh", x, p["wq"].to(Compute))
    src = memory if memory is not None else x
    k = torch.einsum("bsd,dkh->bskh", src, p["wk"].to(Compute))
    v = torch.einsum("bsd,dkh->bskh", src, p["wv"].to(Compute))
    if memory is None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    causal = causal and memory is None

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
    return torch.matmul(silu(gate) * up, p["wo"].to(Compute))


# --------------------------------------------------------------------------
# Activations, op by op as ``jax.nn`` computes them
# --------------------------------------------------------------------------
# On bf16 operands XLA rounds after every op of these formulas, so a fused
# torch activation (one rounding) differs from the JAX package in a third
# to a half of all bf16 values by an ulp; the same ops in torch, each
# rounding to bf16, agree bit for bit on the CPU.

def sigmoid(x):
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``, each op rounded to x's
    dtype (float32 takes torch's own)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * sigmoid(x)


def _const(v: float, dtype) -> float:
    """A constant rounded to ``dtype``, as JAX's weakly typed literals are."""
    return torch.tensor(v, dtype=dtype).item()


def gelu(x):
    """``jax.nn.gelu`` (the tanh approximation, its default), op by op with
    its constants in x's dtype (sqrt(2/pi) is 0.796875 in bf16)."""
    inner = _const(math.sqrt(2 / math.pi), x.dtype) * (
        x + _const(0.044715, x.dtype) * (x * x * x))
    return x * (_const(0.5, x.dtype) * (1 + torch.tanh(inner)))
