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

Tensor parallelism.  Given an LM mesh's "model" axis (``mesh=``),
``attention``, ``swiglu_mlp``, ``embed_tp`` and ``logits_tp`` compute with
the shards ``distributed.sharding.param_specs`` gives a rank on that axis
(Megatron's layout, which the reference's GSPMD program takes from the same
rules): query heads and ``wo``'s rows (where the query heads do not divide
"model", every head's head_dim columns, ``attention``), the MLP's hidden
columns and ``wo``'s rows, the vocab rows of the table and head.  A
column-parallel product's
input passes ``launch.mesh.sum_grads`` and a row-parallel output
``launch.mesh.reduce_parts`` (one sum over "model"); vocab-parallel logits
stay each rank's slice: serving gathers them (``whole_vocab``) and the
sharded train step's loss reduces them (``vocab_parallel_nll``).  A leaf
given whole computes as on one device.
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
    "keep_tree", "embed_tp", "logits_tp", "whole_vocab",
    "vocab_parallel_nll", "model_size", "head_dim_rope", "model_scores",
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


def model_size(mesh) -> int:
    """The extent of ``mesh``'s "model" axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.axis_size("model")


def embed_tp(p, tokens, *, vocab: int, mesh=None):
    """``embed`` where ``p``'s table may be this rank's ``[vocab / m, D]``
    rows over "model": the ids in the rank's range are looked up, the
    others give zeros, and the parts are summed over "model" (one rank
    holds each id's row, so the sum is exact)."""
    if model_size(mesh) == 1 or p["table"].shape[0] == vocab:
        return embed(p, tokens)
    from ..distributed.sharding import model_vocab
    from ..launch import mesh as lm
    v0, nv = model_vocab(vocab, model_size(mesh), mesh.coordinate("model"))
    local = tokens.long() - v0
    hit = (local >= 0) & (local < nv)
    x = p["table"].to(Compute)[local.clamp(0, nv - 1)]
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return lm.reduce_parts(x, mesh, "model")


def logits_tp(w, x, *, vocab: int, mesh=None):
    """``x @ w`` (``w`` [D, V]) where ``w`` may be this rank's ``[D,
    vocab / m]`` columns over "model": then the rank's vocab slice of the
    logits ``[..., vocab / m]`` (``whole_vocab`` gathers it,
    ``vocab_parallel_nll`` reduces it)."""
    w = w.to(Compute)
    if model_size(mesh) == 1 or w.shape[1] == vocab:
        return torch.matmul(x, w)
    from ..launch import mesh as lm
    return torch.matmul(lm.sum_grads(x, mesh, "model"), w)


def whole_vocab(logits, *, vocab: int, mesh=None):
    """``logits_tp``'s rank slice all-gathered over "model" into the whole
    vocab (serving's output); whole logits are returned as they are."""
    if model_size(mesh) == 1 or logits.shape[-1] == vocab:
        return logits
    from ..launch import mesh as lm
    return lm.gather(logits, mesh, "model", logits.dim() - 1)


def vocab_parallel_nll(logits, labels, *, vocab: int, mesh=None):
    """``(nll_sum, count)``: the token sum of the cross entropy and the
    number of valid labels (labels < 0 are ignored), in float32, of logits
    that may be this rank's ``[..., vocab / m]`` slice over "model"
    (``logits_tp``'s; whole logits compute as on one device).  ``transformer.lm_loss`` is ``nll_sum / max(count, 1)``.

    The log-sum-exp reduces over "model": the largest logit (a max over
    the ranks, no gradient: it only shifts the sum), each rank's
    ``sum(exp(x - max))`` summed, and the gold logit taken by the rank
    whose vocab range holds the label, zeros elsewhere, summed.  Both sums
    are ``reduce_parts``, whose backward gives each rank the whole sum's
    gradient: its softmax columns and, on the label's rank, the gold
    logit's -1.  Three ``labels``-shaped float32 tensors cross "model",
    never the vocab."""
    x = logits.float()
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    m = model_size(mesh)
    if m == 1 or x.shape[-1] == vocab:
        logz = torch.logsumexp(x, dim=-1)
        gold = torch.gather(x, -1, safe[..., None])[..., 0]
    else:
        from ..distributed.sharding import model_vocab
        from ..launch import mesh as lm
        v0, nv = model_vocab(vocab, m, mesh.coordinate("model"))
        top = lm.all_reduce(x.detach().amax(dim=-1), mesh, "model", "max")
        sumexp = torch.exp(x - top[..., None]).sum(dim=-1)
        logz = torch.log(lm.reduce_parts(sumexp, mesh, "model")) + top
        local = safe - v0
        hit = (local >= 0) & (local < nv)
        gold = torch.gather(x, -1, local.clamp(0, nv - 1)[..., None])[..., 0]
        gold = lm.reduce_parts(torch.where(hit, gold, torch.zeros_like(gold)),
                               mesh, "model")
    nll = (logz - gold) * valid
    return nll.sum(), valid.sum()


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


def _kernel_route(x, attn_route: str, head_dim_split: bool = False) -> bool:
    """Whether a full-prompt prefill takes the fused kernel B9.

    ``"auto"`` (default) takes B9 for CUDA tensors (and a trace of the
    card's program, ``kernels.census_hooks.on_card``) and the blockwise
    torch path otherwise; ``"kernel"`` forces B9's route, which on CPU
    tensors runs B9's plain version (as the JAX package's interpret mode
    does); ``"blockwise"`` never takes it.  A layer split on head_dim over
    "model" (``head_dim_split``) takes the blockwise path on every route:
    B9 takes one head_dim for q, k and v, and the rank's v holds H / m of
    it.
    """
    if attn_route not in ATTN_ROUTES:
        raise ValueError(f"attn_route must be one of {ATTN_ROUTES}, got "
                         f"{attn_route!r}")
    if head_dim_split:
        return False
    return attn_route == "kernel" or (attn_route == "auto" and on_card(x))


def attention(p, x, *, positions, rope_theta: float, window: int = 0,
              cache: Optional[dict] = None, cache_index: int = 0,
              memory: Optional[torch.Tensor] = None, causal: bool = True,
              q_block: int = 512, kv_block: int = 1024,
              attn_route: str = "auto", mesh=None,
              heads: Optional[tuple] = None):
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

    ``mesh`` (an LM mesh's "model" axis) with ``heads`` = (n_heads, n_kv,
    head_dim), the layer's whole counts: tensor parallelism where ``p``'s
    leaves are this rank's shards (``_model_parallel``).  Where the rules
    split the heads, the rank computes its query heads against the kv
    heads they read, and the cache holds those kv heads only.  Where they
    split head_dim (the heads do not divide "model"), the rank computes
    its H / m columns of every head's values and output, and the cache
    holds those columns of k and v (``cache_specs``' block): a prompt
    from position 0 (T > 1) makes ``wq``/``wk`` whole and scores q . k
    whole on every rank; a decode step scores the rank's columns against
    its cache and sums the partial scores over "model"
    (``_partial_score_attention``).  Cross-attention splits the same way:
    ``memory`` is whole on every rank, and the rank projects its part of
    the K/V from it.
    """
    from ..kernels import ops as kops

    mode = None
    if model_size(mesh) > 1:
        from ..launch import mesh as lm
        p, mode = _model_parallel(p, heads, mesh)
        if mode is not None:
            x = lm.sum_grads(x, mesh, "model")
            if memory is not None:
                memory = lm.sum_grads(memory, mesh, "model")
    b, t, d = x.shape
    split_hd = mode == "head_dim"
    if split_hd and not (t > 1 and (cache is None or cache_index == 0)):
        out = _partial_score_attention(
            p, x, heads=heads, mesh=mesh, positions=positions,
            rope_theta=rope_theta, window=window, cache=cache,
            cache_index=cache_index, memory=memory, causal=causal)
        return lm.reduce_parts(out, mesh, "model"), cache
    wq, wk = p["wq"], p["wk"]
    if split_hd:                  # q and k whole, v the rank's columns
        wq, wk = (lm.gather_shards(w, mesh, [("model", 2)],
                                   summed=("model",)) for w in (wq, wk))
    q = torch.einsum("btd,dnh->btnh", x, wq.to(Compute))
    src = memory if memory is not None else x
    k = torch.einsum("bsd,dkh->bskh", src, wk.to(Compute))
    v = torch.einsum("bsd,dkh->bskh", src, p["wv"].to(Compute))
    if memory is None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    causal = causal and memory is None

    kv_valid = None
    q_offset = 0
    if cache is not None and split_hd:
        # a prompt from position 0: it attends to its own keys, whole here;
        # the cache keeps the rank's columns of them
        cache["k"][:, :t] = k.narrow(-1, mesh.coordinate("model")
                                     * v.shape[-1], v.shape[-1])
        cache["v"][:, :t] = v
    elif cache is not None:
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
            and _kernel_route(x, attn_route, split_hd):
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
    ctx = ctx.reshape(b, t, n_heads, -1)
    out = torch.einsum("btnh,nhd->btd", ctx, p["wo"].to(Compute))
    if mode is not None:
        out = lm.reduce_parts(out, mesh, "model")
    return out, cache


def head_dim_rope(x, positions, theta: float, mesh):
    """``rope`` of this rank's head_dim columns ``x`` [..., T, N, H / m] of
    a layer split on head_dim over "model": rotate-half pairs column i
    with i + H / 2, which another rank holds, so the columns are gathered
    over "model" (a decode step's one token), rotated whole and cut back
    to the rank's.  The gathered columns' gradient is summed over "model"
    (each rank's rotated columns read its partner's)."""
    from ..launch import mesh as lm
    n = x.shape[-1]
    whole = lm.gather_shards(x, mesh, [("model", x.dim() - 1)],
                             summed=("model",))
    return rope(whole, positions, theta).narrow(
        -1, mesh.coordinate("model") * n, n)


def model_scores(partial, mesh):
    """Partial float32 scores of each rank's head_dim columns summed over
    "model" into the whole scores; their gradient is summed over "model"
    as well, since each rank's value columns read the whole scores."""
    from ..launch import mesh as lm
    return lm.sum_grads(lm.reduce_parts(partial, mesh, "model"), mesh,
                        "model")


def _partial_score_attention(p, x, *, heads, mesh, positions, rope_theta,
                             window, cache, cache_index, memory, causal):
    """A decode step (or a query past position 0) of a layer split on
    head_dim: this rank's output part [B, T, D] (summed over "model" by
    the caller).  q, k and v are the rank's H / m columns of every head
    (``p``'s leaves as they are); k and v go into the cache's columns;
    the partial scores over the cached positions are summed over "model"
    (``model_scores``: [B, K, g, T, S] float32), then the mask, the
    softmax with the whole head_dim's scale, the rank's value columns and
    ``wo``'s rows."""
    n_heads, n_kv, hd = heads
    b, t, _ = x.shape
    src = memory if memory is not None else x
    q = torch.einsum("btd,dnh->btnh", x, p["wq"].to(Compute))
    k = torch.einsum("bsd,dkh->bskh", src, p["wk"].to(Compute))
    v = torch.einsum("bsd,dkh->bskh", src, p["wv"].to(Compute))
    if memory is None:
        q = head_dim_rope(q, positions, rope_theta, mesh)
        k = head_dim_rope(k, positions, rope_theta, mesh)
    kv_valid = None
    if cache is not None:
        cache["k"][:, cache_index:cache_index + t] = k
        cache["v"][:, cache_index:cache_index + t] = v
        k, v = cache["k"], cache["v"]
        kv_valid = cache_index + t
    qg = q.reshape(b, t, n_kv, n_heads // n_kv, q.shape[-1])
    ctx = direct_attention(
        qg, k, v, q_offset=cache_index if cache is not None else 0,
        causal=causal and memory is None, window=window, kv_valid=kv_valid,
        head_dim=hd, reduce=lambda s: model_scores(s, mesh))
    return torch.einsum("btnh,nhd->btd", ctx.reshape(b, t, n_heads, -1),
                        p["wo"].to(Compute))


def _model_parallel(p, heads: tuple, mesh) -> tuple[dict, Optional[str]]:
    """(the attention leaves this rank computes with, how the layer splits
    over "model": ``"heads"``, ``"head_dim"``, or ``None``, computing as
    on one device with no sum over "model").

    ``"heads"``: ``wq`` holds this rank's query heads and they fill whole
    kv groups or fall within one (``sharding.model_heads``); ``wq`` and
    ``wo`` are used as they are, and ``wk``/``wv`` keep the kv heads those
    query heads read: their own shard where the rules split them on the kv
    heads, else made whole over "model" (from a head_dim split: their
    gradient is summed, since the ranks read different heads of it) and
    cut to those heads.  ``"head_dim"``: the query heads do not divide
    "model" and the rules split all four leaves on head_dim
    (``sharding.model_head_dim``); they are used as they are (``attention``
    makes whole what it needs).  Otherwise every leaf is made whole over
    "model" and the layer computes every head on every rank (its gradient
    is this rank's part of identical ones): leaves the rules keep whole,
    and the residual case where the rules split ``wq`` on its heads but
    ``model_heads`` finds no plan (a rank's query heads neither fill whole
    kv groups nor fall within one; no published config at m = 2, 4, 8 or
    16)."""
    from ..distributed.sharding import model_head_dim, model_heads
    from ..launch import mesh as lm

    n_heads, n_kv, hd = heads
    m = mesh.axis_size("model")
    span = model_head_dim(n_heads, hd, m, mesh.coordinate("model"))
    if span is not None and p["wq"].shape[2] == span[1] < hd:
        return p, "head_dim"
    plan = model_heads(n_heads, n_kv, m, mesh.coordinate("model")) \
        if p["wq"].shape[1] < n_heads else None
    full = {"wq": (None, n_heads, hd), "wk": (None, n_kv, hd),
            "wv": (None, n_kv, hd), "wo": (n_heads, hd, None)}

    def whole(k, summed):
        w = p[k]
        dims = [i for i, n in enumerate(full[k])
                if n is not None and w.shape[i] < n]
        if dims:
            return lm.gather_shards(w, mesh, [("model", dims[0])],
                                    summed=("model",) if summed else ())
        return lm.sum_grads(w, mesh, "model") if summed else w

    if plan is None:
        return {k: whole(k, False) for k in full}, None
    _, _, k0, nk = plan
    out = dict(p)
    for k in ("wk", "wv"):
        if p[k].shape[1] * m != n_kv:       # not split on the kv heads
            out[k] = whole(k, True).narrow(1, k0, nk)
    return out, "heads"


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


def swiglu_mlp(p, x, *, mesh=None, d_ff: int = 0):
    """SwiGLU.  ``mesh`` (an LM mesh's "model" axis) with ``d_ff`` the
    whole hidden width: where ``p``'s leaves are this rank's hidden columns
    (``wi_gate``, ``wi_up``) and rows (``wo``), the output is this rank's
    part, summed over "model"."""
    if model_size(mesh) > 1 and p["wi_gate"].shape[1] < d_ff:
        from ..launch import mesh as lm
        out = swiglu_mlp(p, lm.sum_grads(x, mesh, "model"))
        return lm.reduce_parts(out, mesh, "model")
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
