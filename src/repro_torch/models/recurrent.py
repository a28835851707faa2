"""Hybrid RG-LRU + local-attention model (RecurrentGemma / Griffin family).

The port of the JAX package's ``models/recurrent.py``.  The block pattern
(``cfg.block_pattern``, default ("rglru", "rglru", "attn")) repeats in
groups whose parameters are stacked ``[n_groups, ...]``; the remainder
layers form an unstacked ``tail``.  A Python loop over groups takes the
place of ``lax.scan``.

The RG-LRU prefill solves the linear recurrence ``h_t = a_t * h_{t-1} +
b_t`` in chunks of 2,048 steps: inside a chunk a log-depth doubling scan
composes the elements (a, b) as ``(a2*a1, a2*b1 + b2)`` (the reference's
``associative_scan``, in another association order), and the state is
carried from chunk to chunk in sequence.

Decode state: RG-LRU hidden [B, d_rnn] + causal-conv tail [B, 3, d_rnn] per
recurrent layer; a ring buffer of ``attn_window`` K/V slots per attention
layer.  ``decode_step_hybrid`` updates the state tensors in place and
returns them, as the transformer's decode step does its cache.

On an LM mesh (``mesh=``) the blocks run tensor parallelism over its
"model" axis with the shards ``distributed.sharding.param_specs`` gives a
rank there.  The RG-LRU block is channel-parallel: ``wx``, ``wgate``,
``conv_w``, ``conv_b`` and ``lam`` hold the rank's d_rnn / m channels, and
the row-parallel gates ``w_r``/``w_i`` give partial pre-activations over
all channels, reduce-scattered to the rank's (``launch.mesh
.scatter_parts``, one collective for both), so the conv, the scan and the
state [B, d_rnn / m] stay on the rank's channels; ``wo`` is row-parallel
(one sum over "model").  The attention block splits as
``layers.attention`` does: its query heads where they divide "model",
the ring holding the kv heads they read; else (recurrentgemma-2b's 10
heads at m = 4, 8 or 16) head_dim, the ring holding every kv head's
head_dim / m columns as ``state_specs`` places them
(``transformer.cache_block``), and a decode step sums its partial scores
over the ring's positions over "model".  The MLPs, the embedding and the
head are the transformer's.  A leaf given whole computes as on one
device.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L
from .transformer import (attn_heads, cache_block, embed_tokens,
                          head_logits, model_axis)

__all__ = ["init_hybrid", "forward_hybrid", "init_hybrid_state",
           "decode_step_hybrid", "rglru_block", "attn_block",
           "attn_block_decode", "init_ring_cache", "CONV_W"]

CONV_W = 4  # causal temporal-conv width (Griffin)
SCAN_CHUNK = 2048


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

def init_rglru_block(gen, d_model: int, d_rnn: int, d_ff: int, *, device):
    tn = L.truncated_normal
    return {
        "ln2": L.init_rmsnorm(d_model, device=device),
        "mlp": L.init_mlp(gen, d_model, d_ff, device=device),
        "ln": L.init_rmsnorm(d_model, device=device),
        "wx": tn(gen, (d_model, d_rnn), d_model ** -0.5, device=device),
        "wgate": tn(gen, (d_model, d_rnn), d_model ** -0.5, device=device),
        "conv_w": tn(gen, (CONV_W, d_rnn), CONV_W ** -0.5, device=device),
        "conv_b": torch.zeros((d_rnn,), dtype=torch.float32, device=device),
        "w_r": tn(gen, (d_rnn, d_rnn), d_rnn ** -0.5, device=device),
        "w_i": tn(gen, (d_rnn, d_rnn), d_rnn ** -0.5, device=device),
        "lam": torch.linspace(0.9, 0.999, d_rnn, dtype=torch.float32,
                              device=device),                    # a ~ U
        "wo": tn(gen, (d_rnn, d_model), d_rnn ** -0.5, device=device),
    }


def _rglru_coeffs(p, u, mesh=None):
    """Per-step gate coefficients: h_t = a_t * h_{t-1} + b_t.  ``mesh``:
    ``u`` holds the rank's channels and ``w_r``/``w_i`` their rows, so
    both gates' partial pre-activations are reduce-scattered to those
    channels in one collective."""
    pre_r = torch.matmul(u, p["w_r"].to(L.Compute))
    pre_i = torch.matmul(u, p["w_i"].to(L.Compute))
    if mesh is not None:
        from ..launch import mesh as lm
        pre_r, pre_i = lm.scatter_parts(torch.stack([pre_r, pre_i]), mesh,
                                        "model", -1).unbind(0)
    r = torch.sigmoid(pre_r.float())
    i = torch.sigmoid(pre_i.float())
    log_a = -8.0 * F.softplus(p["lam"]) * r               # [B,T,d_rnn] fp32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * u.float()
    return a, b


def _doubling_scan(a, b):
    """Inclusive scan of (a, b) along axis 1 under ``(a2*a1, a2*b1 + b2)``
    in log2(T) doubling steps: after the step of offset s, element t holds
    the composition of elements max(0, t - 2s + 1) .. t."""
    t = a.shape[1]
    s = 1
    while s < t:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def _chunked_linear_scan(a, b, *, chunk: int = SCAN_CHUNK):
    """h_t = a_t * h_{t-1} + b_t (h_{-1} = 0): a doubling scan within each
    chunk, the state carried across chunks in sequence."""
    bsz, t, d = a.shape
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    h_in = torch.zeros((bsz, d), dtype=a.dtype, device=a.device)
    outs = []
    for c in range(t // chunk):
        acoef, bcoef = _doubling_scan(a[:, c * chunk:(c + 1) * chunk],
                                      b[:, c * chunk:(c + 1) * chunk])
        h_out = acoef * h_in[:, None] + bcoef
        outs.append(h_out)
        h_in = h_out[:, -1]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def _causal_conv(p, u, tail=None):
    """Depthwise causal conv width CONV_W; tail [B, CONV_W-1, d] for decode.
    bf16 products summed in bf16, in the reference's order."""
    pad = (torch.zeros((u.shape[0], CONV_W - 1, u.shape[2]), dtype=u.dtype,
                       device=u.device) if tail is None else tail.to(u.dtype))
    ext = torch.cat([pad, u], dim=1)
    t = u.shape[1]
    out = sum(ext[:, i:i + t] * p["conv_w"][i].to(u.dtype)
              for i in range(CONV_W))
    return out + p["conv_b"].to(u.dtype), ext[:, -(CONV_W - 1):]


def rglru_block(p, x, *, eps: float, state=None, mesh=None, d_ff: int = 0):
    """x [B,T,D] -> (y, state).  state = {"h": [B,d], "conv": [B,3,d]}
    (decode, T == 1: updated in place).  ``mesh`` (an LM mesh's "model"
    axis) with ``d_ff`` the MLP's whole hidden width: channel-parallel
    where ``p``'s leaves hold the rank's channels (d = d_rnn / m in the
    state; see the module's docstring)."""
    from ..launch import mesh as lm
    split = L.model_size(mesh) > 1 and p["wx"].shape[1] < p["w_r"].shape[1]
    xn = L.rms_norm(p["ln"], x, eps)
    if split:
        xn = lm.sum_grads(xn, mesh, "model")
    u = torch.matmul(xn, p["wx"].to(L.Compute))
    gate = torch.matmul(xn, p["wgate"].to(L.Compute))
    u, conv_tail = _causal_conv(p, u, None if state is None
                                else state["conv"])
    a, b = _rglru_coeffs(p, u, mesh if split else None)
    if state is None:
        h = _chunked_linear_scan(a, b)
    else:
        h = a[:, 0] * state["h"] + b[:, 0]                # single step (T==1)
        state["h"].copy_(h)
        state["conv"].copy_(conv_tail)
        h = h[:, None]
    y = torch.matmul(h.to(L.Compute) * L.gelu(gate),
                     p["wo"].to(L.Compute))
    if split:
        y = lm.reduce_parts(y, mesh, "model")
    x = x + y
    x = x + L.swiglu_mlp(p["mlp"], L.rms_norm(p["ln2"], x, eps), mesh=mesh,
                         d_ff=d_ff)
    return x, state


# --------------------------------------------------------------------------
# Local attention with ring-buffer cache
# --------------------------------------------------------------------------

def init_attn_block(gen, cfg: ModelConfig, *, device):
    return {
        "ln": L.init_rmsnorm(cfg.d_model, device=device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, device=device),
        "ln2": L.init_rmsnorm(cfg.d_model, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def attn_block(p, x, cfg: ModelConfig, *, positions, mesh=None):
    h, _ = L.attention(p["attn"], L.rms_norm(p["ln"], x, cfg.norm_eps),
                       positions=positions, rope_theta=cfg.rope_theta,
                       window=cfg.attn_window, mesh=mesh,
                       heads=attn_heads(cfg))
    x = x + h
    return x + L.swiglu_mlp(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps),
                            mesh=mesh, d_ff=cfg.d_ff)


def init_ring_cache(cfg: ModelConfig, batch: int, *, lead=(), device,
                    mesh=None):
    """A zero ring [*lead, batch, window, K, H]; on ``mesh`` (K, H) is
    this rank's block (``transformer.cache_block``: the kv heads its query
    heads read, or every kv head's H / m columns)."""
    shape = (*lead, batch, cfg.attn_window, *cache_block(cfg, mesh))
    return {"k": torch.zeros(shape, dtype=L.Compute, device=device),
            "v": torch.zeros(shape, dtype=L.Compute, device=device)}


def attn_block_decode(p, x, cfg: ModelConfig, ring: dict, pos: int, *,
                      mesh=None):
    """Single-token local attention against the ring buffer (written in
    place at slot ``pos % w``).  ``mesh``: the layer splits as
    ``layers.attention`` splits it, the ring holding the rank's block:
    the kv heads its query heads read, or, split on head_dim, every kv
    head's H / m columns, whose partial scores are summed over "model"
    (``layers.model_scores``: [B, K, g, 1, w] float32) before the mask
    and the softmax."""
    from ..launch import mesh as lm
    w = cfg.attn_window
    xn = L.rms_norm(p["ln"], x, cfg.norm_eps)
    ap, mode = p["attn"], None
    if L.model_size(mesh) > 1:
        ap, mode = L._model_parallel(ap, attn_heads(cfg), mesh)
        if mode is not None:
            xn = lm.sum_grads(xn, mesh, "model")
    q = torch.einsum("btd,dnh->btnh", xn, ap["wq"].to(L.Compute))
    k = torch.einsum("btd,dkh->btkh", xn, ap["wk"].to(L.Compute))
    v = torch.einsum("btd,dkh->btkh", xn, ap["wv"].to(L.Compute))
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    if mode == "head_dim":
        q = L.head_dim_rope(q, positions, cfg.rope_theta, mesh)
        k = L.head_dim_rope(k, positions, cfg.rope_theta, mesh)
    else:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    slot = pos % w
    ring["k"][:, slot] = k[:, 0]
    ring["v"][:, slot] = v[:, 0]
    # absolute position held by each slot (within the last w writes): floor
    # modulo, as the reference's ``%`` on integers
    idx = torch.arange(w, device=x.device)
    slot_pos = pos - torch.remainder(pos - idx, w)
    b, t = x.shape[0], 1
    n_kv = k.shape[2]
    hd = cfg.hd
    qg = q.reshape(b, t, n_kv, -1, q.shape[-1])
    # keys were stored post-rope at their absolute positions; mask invalids
    if mode == "head_dim":
        logits = L.model_scores(torch.einsum(
            "btkgh,bskh->bkgts", qg.float(), ring["k"].float()), mesh)
        logits = logits.to(L.Compute).float()
    else:
        logits = torch.einsum("btkgh,bskh->bkgts", qg, ring["k"]).float()
    logits = logits * hd ** -0.5
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    logits = torch.where(ok[None, None, None, None], logits,
                         torch.tensor(-1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1).to(L.Compute)
    ctx = torch.einsum("bkgts,bskh->btkgh", probs, ring["v"])
    h = torch.einsum("btnh,nhd->btd", ctx.reshape(b, t, q.shape[2], -1),
                     ap["wo"].to(L.Compute))
    if mode is not None:
        h = lm.reduce_parts(h, mesh, "model")
    x = x + h
    x = x + L.swiglu_mlp(p["mlp"], L.rms_norm(p["ln2"], x, cfg.norm_eps),
                         mesh=mesh, d_ff=cfg.d_ff)
    return x, ring


# --------------------------------------------------------------------------
# Model assembly
# --------------------------------------------------------------------------

def _pattern(cfg: ModelConfig) -> tuple[str, ...]:
    return cfg.block_pattern or ("rglru", "rglru", "attn")


def _pattern_layout(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    pat = _pattern(cfg)
    n_groups = cfg.n_layers // len(pat)
    tail = cfg.n_layers - n_groups * len(pat)
    return n_groups, pat[:tail]


def init_group(cfg: ModelConfig, gen, pattern, *, device) -> dict:
    d_rnn = cfg.rglru_dim or cfg.d_model
    return {f"b{i}_{kind}": (
        init_rglru_block(gen, cfg.d_model, d_rnn, cfg.d_ff, device=device)
        if kind == "rglru" else init_attn_block(gen, cfg, device=device))
        for i, kind in enumerate(pattern)}


def init_hybrid(cfg: ModelConfig, gen: torch.Generator, *, device,
                keep=None) -> dict:
    """Random parameters from ``gen`` on ``device`` (the JAX initialisers'
    distributions; not their numbers); ``keep`` as ``layers.keep_tree``."""
    n_groups, tail = _pattern_layout(cfg)
    groups = L.stack_trees([
        L.keep_tree(keep, ("groups",),
                    init_group(cfg, gen, _pattern(cfg), device=device))
        for _ in range(n_groups)])
    params = {
        "embed": L.keep_tree(keep, ("embed",), L.init_embedding(
            gen, cfg.padded_vocab, cfg.d_model, device=device)),
        "groups": groups,
        "final_norm": L.keep_tree(keep, ("final_norm",), L.init_rmsnorm(
            cfg.d_model, device=device)),
    }
    if tail:
        params["tail"] = L.keep_tree(keep, ("tail",), init_group(
            cfg, gen, tail, device=device))
    if not cfg.tie_embeddings:
        params["head"] = L.keep_tree(keep, ("head",), L.init_dense(
            gen, cfg.d_model, cfg.padded_vocab, device=device))
    return params


def _groups(cfg: ModelConfig, tree: dict):
    """(group tree, pattern, its ``weights`` path) of every group in
    order: the stacked groups, then the tail."""
    _, tail = _pattern_layout(cfg)
    for gp in L.unstack_tree(tree["groups"]):
        yield gp, _pattern(cfg), ("groups",)
    if tail:
        yield tree["tail"], tail, ("tail",)


def _run_pattern(cfg: ModelConfig, x, gp: dict, pattern, positions,
                 gather=None, mesh=None):
    if gather is not None:
        gp = gather(gp)
    for i, kind in enumerate(pattern):
        p = gp[f"b{i}_{kind}"]
        if kind == "rglru":
            x, _ = rglru_block(p, x, eps=cfg.norm_eps, mesh=mesh,
                               d_ff=cfg.d_ff)
        else:
            x = attn_block(p, x, cfg, positions=positions, mesh=mesh)
    return x


def forward_hybrid(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                   last_only: bool = False, mesh=None, weights=None):
    """Training / prefill forward. Returns (logits, None, aux=0).  Each
    stacked group's body is rematerialised unless ``cfg.remat_policy`` is
    ``"none"``, the tail's never (as the reference's scan body).
    ``mesh`` (an LM mesh): tensor parallelism over its "model" axis (see
    the module's docstring); ``tokens`` are the rows this rank computes.
    ``weights(path, tree)`` (the FSDP gather of mesh serving and the
    sharded train step) gathers each group's parameters over "data" inside
    its rematerialised body, and the embedding's, the tail's and the
    head's just before use."""
    mesh = model_axis(mesh)
    x = embed_tokens(params, cfg, tokens, mesh, weights)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    group = L.remat_all(functools.partial(
        _run_pattern, cfg, gather=None if weights is None
        else functools.partial(weights, ("groups",)), mesh=mesh),
        cfg.remat_policy)
    for gp in L.unstack_tree(params["groups"]):
        x = group(x, gp, _pattern(cfg), positions)
    _, tail = _pattern_layout(cfg)
    if tail:
        x = _run_pattern(cfg, x, params["tail"], tail, positions,
                         gather=None if weights is None
                         else functools.partial(weights, ("tail",)),
                         mesh=mesh)
    if last_only:
        x = x[:, -1:]
    return (head_logits(params, cfg, x, weights, mesh), None,
            torch.zeros((), device=x.device))


def _group_state(cfg: ModelConfig, batch: int, pattern, *, lead=(),
                 device, mesh=None) -> dict:
    from ..distributed.sharding import model_span
    d_rnn = cfg.rglru_dim or cfg.d_model
    span = model_span(d_rnn, L.model_size(mesh), 0)
    d_rnn = d_rnn if span is None else span[1]
    st = {}
    for i, kind in enumerate(pattern):
        if kind == "rglru":
            st[f"b{i}_{kind}"] = {
                "h": torch.zeros((*lead, batch, d_rnn), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((*lead, batch, CONV_W - 1, d_rnn),
                                    dtype=L.Compute, device=device),
            }
        else:
            st[f"b{i}_{kind}"] = init_ring_cache(cfg, batch, lead=lead,
                                                 device=device, mesh=mesh)
    return st


def init_hybrid_state(cfg: ModelConfig, batch: int, *, device,
                      mesh=None) -> dict:
    """The zero decode state of ``batch`` rows; on ``mesh`` (any mesh, or a
    ``MeshLayout``) a rank's: the RG-LRU's d_rnn / m channels where the
    rules split them, the ring's block of ``transformer.cache_block``
    (the rows are the caller's)."""
    n_groups, tail = _pattern_layout(cfg)
    state = {"groups": _group_state(cfg, batch, _pattern(cfg),
                                    lead=(n_groups,), device=device,
                                    mesh=mesh)}
    if tail:
        state["tail"] = _group_state(cfg, batch, tail, device=device,
                                     mesh=mesh)
    return state


def decode_step_hybrid(params: dict, cfg: ModelConfig, state: dict,
                       tokens: torch.Tensor, pos: int, *, mesh=None,
                       weights=None):
    """One-token decode: O(window + d_rnn) state, O(1) in sequence length.
    Returns (logits, state); the state is updated in place.  ``mesh`` and
    ``weights`` as ``forward_hybrid``'s; the state is this rank's
    (``init_hybrid_state(..., mesh=)``)."""
    pos = int(pos)
    mesh = model_axis(mesh)
    x = embed_tokens(params, cfg, tokens, mesh, weights)
    for (gp, pattern, path), (st, _, _) in zip(_groups(cfg, params),
                                               _groups(cfg, state)):
        if weights is not None:
            gp = weights(path, gp)
        for i, kind in enumerate(pattern):
            key = f"b{i}_{kind}"
            if kind == "rglru":
                x, _ = rglru_block(gp[key], x, eps=cfg.norm_eps,
                                   state=st[key], mesh=mesh, d_ff=cfg.d_ff)
            else:
                x, _ = attn_block_decode(gp[key], x, cfg, st[key], pos,
                                         mesh=mesh)
    return head_logits(params, cfg, x, weights, mesh), state
