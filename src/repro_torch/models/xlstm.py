"""xLSTM (sLSTM + mLSTM) stack — the ssm family.

The port of the JAX package's ``models/xlstm.py``.  mLSTM: a matrix-memory
cell with outer-product updates; prefill runs the chunkwise-parallel form
(chunks of ``CHUNK`` steps: intra-chunk quadratic with a decay mask, the
recurrent state (C, n) carried across chunks in sequence); decode is the
O(1) recurrent step on (C, n).  sLSTM: a strictly sequential scalar-memory
cell, a Python loop over time steps in prefill.

Numerics follow the reference: the exponential input gate is clamped to
``|logit| <= GATE_CLAMP`` and forget gates are sigmoids; where the
reference multiplies bf16 operands into float32 (``preferred_element_type``)
the port multiplies their float32 copies (exact products, float32 sums),
and it rounds the stored ``scores`` and ``w`` tiles to bf16 where the
reference does.

Block pattern: 7 mLSTM : 1 sLSTM (``cfg.block_pattern``), d_ff = 0 — the
cells hold their own projections, there is no separate FFN.  The decode
state is updated in place and returned.

On an LM mesh (``mesh=``) the blocks run tensor parallelism over its
"model" axis with the shards ``distributed.sharding.param_specs`` gives a
rank there.  mLSTM: where the rules split ``wq``/``wk``/``wv`` and
``wi``/``wf`` on the heads, the rank runs the cell for its N / m heads
(state ``C``/``n`` of those heads), whose outputs are its D / m columns of
``h``.  Where they split q/k/v on head_dim (xlstm-1.3b's 4 heads at m =
8 or 16; ``_mlstm_head_dim``), the rank runs every head on its head_dim /
m value columns: a prefill makes ``wq``/``wk`` whole and computes q . k
whole, the same on every rank, and its value side (``intra``, ``inter``,
the state update) on its columns; a decode step keeps ``C``'s value
columns and ``n``'s key columns, as ``state_specs`` places them, and sums
the partial ``q . n`` over "model".  An uneven all-to-all then brings the
rank's columns of every head to its D / m contiguous columns of ``h``
(``launch.mesh.exchange_v``).  Either way those columns meet the rank's
``wog`` columns and ``wo`` rows (one sum over "model").  sLSTM:
``wz``/``wi``/``wf``/``wo_gate`` are column-parallel, so the recurrence
runs on the rank's D / m channels (state [B, D / m]) with no collective
inside the loop, and ``wo`` is row-parallel (one sum).  A leaf given
whole computes as on one device.
"""

from __future__ import annotations

import functools

import torch

from ..configs.base import ModelConfig
from . import layers as L
from .transformer import embed_tokens, head_logits, model_axis

__all__ = ["init_xlstm", "forward_xlstm", "init_xlstm_state",
           "decode_step_xlstm", "mlstm_block", "slstm_block", "state_block",
           "CHUNK", "GATE_CLAMP"]

CHUNK = 256
GATE_CLAMP = 8.0


def _proj(x, w):
    """x [B,T,D] @ w.astype(bf16) [D, ...] -> [B, T, ...] (bf16)."""
    return torch.matmul(x, w.to(L.Compute).reshape(w.shape[0], -1)) \
        .reshape(*x.shape[:-1], *w.shape[1:])


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def init_mlstm_block(gen, d_model: int, n_heads: int, *, device):
    hd = d_model // n_heads
    s = d_model ** -0.5
    tn = L.truncated_normal
    return {
        "ln": L.init_rmsnorm(d_model, device=device),
        "wq": tn(gen, (d_model, n_heads, hd), s, device=device),
        "wk": tn(gen, (d_model, n_heads, hd), s, device=device),
        "wv": tn(gen, (d_model, n_heads, hd), s, device=device),
        "wi": tn(gen, (d_model, n_heads), s, device=device),
        "wf": tn(gen, (d_model, n_heads), s, device=device),
        "wog": tn(gen, (d_model, d_model), s, device=device),
        "wo": tn(gen, (d_model, d_model), s, device=device),
    }


def _mlstm_gates(p, xn):
    i_log = torch.clamp(_proj(xn, p["wi"]).float(), -GATE_CLAMP, GATE_CLAMP)
    f = torch.sigmoid(_proj(xn, p["wf"]).float())
    return i_log, f


def _mlstm_chunk(C, n, qj, kj, vj, ij, fj):
    """One chunk of the chunkwise-parallel mLSTM: (C, n) [B,N,h,h], [B,N,h]
    float32; qj/kj/vj [B,K,N,h] bf16, ij/fj [B,K,N] float32.  Returns
    (C', n', h [B,K,N,h] float32)."""
    ck = qj.shape[1]
    lf = torch.log(torch.clamp(fj, min=1e-9))           # [B,K,N]
    cum = torch.cumsum(lf, dim=1)                        # inclusive
    total = cum[:, -1:]
    # intra-chunk decay: D[t,s] = exp(cum_t - cum_s + i_s), s <= t
    dmat = cum[:, :, None] - cum[:, None, :] + ij[:, None, :]
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                 device=qj.device))
    dmat = torch.where(mask[None, :, :, None], dmat,
                       torch.tensor(-1e30, device=qj.device))
    dexp = torch.exp(torch.clamp(dmat, max=GATE_CLAMP))
    qf, kf, vf = qj.float(), kj.float(), vj.float()
    # float32 product, one rounding into the stored bf16 tile
    scores = (torch.einsum("btnh,bsnh->btsn", qf, kf) * dexp).to(L.Compute)
    intra = torch.einsum("btsn,bsnh->btnh", scores.float(), vf)
    # inter-chunk: state decayed to position t
    qdec = torch.exp(cum)[..., None] * qf
    inter = torch.einsum("btnh,bnhg->btng", qdec, C)
    inter_n = torch.einsum("btnh,bnh->btn", qdec, n)
    num = intra + inter
    # normaliser: q . n_t = sum_s decay_s * (q . k_s)  (= scores summed)
    den = torch.abs(scores.float().sum(dim=2) + inter_n)
    h = num / torch.clamp(den, min=1.0)[..., None]
    # state update: C' = F C + sum_s exp(total - cum_s + i_s) k v^T
    w = torch.exp(total - cum + ij).to(L.Compute).float()    # [B,K,N]
    wk = w[..., None] * kf
    kv = torch.einsum("bsnh,bsng->bnhg", wk, vf)
    ksum = wk.sum(dim=1)
    ftot = torch.exp(total[:, 0])[..., None]             # [B,N,1]
    return ftot[..., None] * C + kv, ftot * n + ksum, h


def _mlstm_model_parallel(p, xn, n_heads: int, mesh):
    """(the leaves this rank computes with, ``xn``, how the block splits
    over "model") on ``mesh``'s "model" axis: ``None`` where ``wog`` is
    whole (no leaf split over "model"); ``"heads"``: ``p`` as it is, the
    rank's heads giving its columns; ``"head_dim"``: q/k/v split on
    head_dim (``sharding.model_head_dim``), ``_mlstm_head_dim``'s; else
    ``"whole"``: every head on every rank (head_dim does not divide "model"
    either), whose ``h`` is cut to the rank's columns.  Outside
    ``"heads"``, the leaves every rank holds whole have their gradient
    summed over "model" (each rank's columns read every head)."""
    from ..distributed.sharding import model_head_dim
    from ..launch import mesh as lm
    d = xn.shape[-1]
    m = L.model_size(mesh)
    if m == 1 or p["wog"].shape[1] == d:
        return p, xn, None
    xn = lm.sum_grads(xn, mesh, "model")
    if p["wq"].shape[1] < n_heads:
        return p, xn, "heads"
    hd = d // n_heads
    span = model_head_dim(n_heads, hd, m, mesh.coordinate("model"))
    mode = ("head_dim" if span is not None and p["wq"].shape[2] == span[1]
            < hd else "whole")
    p = dict(p)
    for k in (("wi", "wf") if mode == "head_dim"
              else ("wq", "wk", "wv", "wi", "wf")):
        p[k] = lm.sum_grads(p[k], mesh, "model")
    return p, xn, mode


def _head_dim_to_cols(h, mesh):
    """``h`` [B, T, N, c], this rank's c = head_dim / m value columns of
    every head, -> [B, T, N·c], its D / m contiguous columns of the whole
    ``h`` [B, T, D] (``wog``'s columns, ``wo``'s rows): one uneven
    all-to-all over "model" (``launch.mesh.exchange_v``).  Block u = n·m +
    s of the D columns (head n's columns of rank s) goes to rank u // N;
    the backward sends each block's gradient back."""
    from ..launch import mesh as lm
    b, t, n, c = h.shape
    m, r = mesh.axis_size("model"), mesh.coordinate("model")
    dest = [(j * m + r) // n for j in range(n)]      # ascending in j
    got = sorted(range(r * n, (r + 1) * n), key=lambda u: (u % m, u))
    x = lm.exchange_v(h.permute(2, 0, 1, 3), mesh, "model",
                      [dest.count(s) for s in range(m)],
                      [sum(u % m == s for u in got) for s in range(m)])
    order = sorted(range(n), key=lambda i: got[i])
    x = x[torch.tensor(order, device=x.device)]
    return x.permute(1, 2, 0, 3).reshape(b, t, n * c)


def _mlstm_prefill(q, k, v, i_log, f):
    """The chunkwise-parallel form from a zero state: h [B, T, N, g]
    float32, g the columns ``v`` [B, T, N, g] holds (q and k whole
    heads)."""
    b, t, nh, hd = k.shape
    ck = min(CHUNK, t)
    assert t % ck == 0, (t, CHUNK)
    C = torch.zeros((b, nh, hd, v.shape[-1]), dtype=torch.float32,
                    device=k.device)
    n = torch.zeros((b, nh, hd), dtype=torch.float32, device=k.device)
    hs = []
    for lo in range(0, t, ck):
        sl = slice(lo, lo + ck)
        C, n, hj = _mlstm_chunk(C, n, q[:, sl], k[:, sl], v[:, sl],
                                i_log[:, sl], f[:, sl])
        hs.append(hj)
    return torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]


def _mlstm_step(state, q, k, v, i_log, f, qn=None, kn=None, reduce=None):
    """One decode step (T == 1) on ``state`` {"C": [B, N, h, g], "n": [B,
    N, h_n]}, updated in place: h [B, 1, N, g] float32.  q and k [B, 1, N,
    h] (whole heads) read and update ``C``'s g columns (``v``'s); ``n``
    takes ``kn`` and ``q . n`` reads ``qn`` (q and k by default), the
    columns ``n`` holds, and ``reduce`` sums that partial ``q . n`` over
    the ranks holding the other columns (a head_dim split)."""
    i = torch.exp(i_log[:, 0])                                     # [B,N]
    f0 = f[:, 0]
    q0, k0, v0 = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    qn0 = q0 if qn is None else qn[:, 0].float()
    kn0 = k0 if kn is None else kn[:, 0].float()
    c_new = f0[..., None, None] * state["C"] + \
        i[..., None, None] * torch.einsum("bnh,bng->bnhg", k0, v0)
    n_new = f0[..., None] * state["n"] + i[..., None] * kn0
    num = torch.einsum("bnh,bnhg->bng", q0, c_new)
    qdotn = torch.einsum("bnh,bnh->bn", qn0, n_new)
    den = torch.abs(qdotn if reduce is None else reduce(qdotn))
    state["C"].copy_(c_new)
    state["n"].copy_(n_new)
    return (num / torch.clamp(den, min=1.0)[..., None])[:, None]


def _mlstm_head_dim(p, xn, n_heads: int, state, mesh):
    """The mLSTM cell of a block split on head_dim over "model": this
    rank's D / m columns of ``h`` [B, T, D / m] (compute dtype).  ``p``'s
    ``wq``/``wk``/``wv`` hold the rank's head_dim / m columns of every
    head, ``wi``/``wf`` are whole.  Prefill: ``wq``/``wk`` made whole over
    "model" (their gradient summed), q . k and ``n`` whole on every rank,
    ``v``, ``C`` and ``h`` on the rank's value columns; no collective
    inside the chunks.  Decode (``state``: ``C`` [B, N, h, h / m], the
    value columns, ``n`` [B, N, h / m], the key columns, updated in
    place): the token's q and k gathered over "model", ``C`` and the
    numerator local, ``q . n`` the rank's part of the key dims summed over
    "model" ([B, N] float32, ``layers.model_scores``)."""
    from ..launch import mesh as lm
    hd = xn.shape[-1] // n_heads
    v = _proj(xn, p["wv"])
    i_log, f = _mlstm_gates(p, xn)
    if state is not None:
        q_r = _proj(xn, p["wq"]) * hd ** -0.5
        k_r = _proj(xn, p["wk"])
        q, k = (lm.gather_shards(a, mesh, [("model", 3)], summed=("model",))
                for a in (q_r, k_r))
        h = _mlstm_step(state, q, k, v, i_log, f, qn=q_r, kn=k_r,
                        reduce=lambda x: L.model_scores(x, mesh))
    else:
        wq, wk = (lm.gather_shards(p[k], mesh, [("model", 2)],
                                   summed=("model",)) for k in ("wq", "wk"))
        h = _mlstm_prefill(_proj(xn, wq) * hd ** -0.5, _proj(xn, wk), v,
                           i_log, f)
    return _head_dim_to_cols(h.to(L.Compute), mesh)


def mlstm_block(p, x, *, n_heads: int, eps: float, state=None, mesh=None):
    """x [B,T,D].  state = {"C": [B,N,h,h], "n": [B,N,h]} for decode
    (T == 1; updated in place).  ``mesh`` (an LM mesh's "model" axis):
    tensor parallelism where ``p``'s leaves are this rank's shards (see the
    module's docstring); the state is the rank's block
    (``state_block``)."""
    b, t, d = x.shape
    hd = d // n_heads
    xn = L.rms_norm(p["ln"], x, eps)
    p, xn, mode = _mlstm_model_parallel(p, xn, n_heads, mesh)
    if mode == "head_dim":
        h = _mlstm_head_dim(p, xn, n_heads, state, mesh)
    else:
        q = _proj(xn, p["wq"]) * hd ** -0.5
        k = _proj(xn, p["wk"])
        v = _proj(xn, p["wv"])
        i_log, f = _mlstm_gates(p, xn)
        h = (_mlstm_prefill(q, k, v, i_log, f) if state is None
             else _mlstm_step(state, q, k, v, i_log, f)).reshape(b, t, -1)
        if mode == "whole":
            from ..distributed.sharding import model_span
            h = h.narrow(-1, *model_span(d, L.model_size(mesh),
                                         mesh.coordinate("model")))
        h = h.to(L.Compute)
    og = L.sigmoid(_proj(xn, p["wog"]))
    y = _proj(h * og, p["wo"])
    if mode is not None:
        from ..launch import mesh as lm
        y = lm.reduce_parts(y, mesh, "model")
    return x + y, state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def init_slstm_block(gen, d_model: int, *, device):
    s = d_model ** -0.5
    tn = L.truncated_normal
    return {
        "ln": L.init_rmsnorm(d_model, device=device),
        "wz": tn(gen, (d_model, d_model), s, device=device),
        "wi": tn(gen, (d_model, d_model), s, device=device),
        "wf": tn(gen, (d_model, d_model), s, device=device),
        "wo_gate": tn(gen, (d_model, d_model), s, device=device),
        "wo": tn(gen, (d_model, d_model), s, device=device),
    }


def slstm_block(p, x, *, eps: float, state=None, mesh=None):
    """Sequential scalar-memory cell.  state = {"c": [B,D], "n": [B,D]}
    (decode; updated in place).  ``mesh`` (an LM mesh's "model" axis):
    channel-parallel where ``p``'s gates hold the rank's D / m columns
    (the state's D is then D / m)."""
    from ..launch import mesh as lm
    split = L.model_size(mesh) > 1 and p["wz"].shape[1] < x.shape[-1]
    xn = L.rms_norm(p["ln"], x, eps)
    if split:
        xn = lm.sum_grads(xn, mesh, "model")
    z = torch.tanh(_proj(xn, p["wz"]).float())
    i = torch.exp(torch.clamp(_proj(xn, p["wi"]).float(), -GATE_CLAMP,
                              GATE_CLAMP))
    f = torch.sigmoid(_proj(xn, p["wf"]).float())
    o = L.sigmoid(_proj(xn, p["wo_gate"]))

    if state is not None:
        c = f[:, 0] * state["c"] + i[:, 0] * z[:, 0]
        n = f[:, 0] * state["n"] + i[:, 0]
        h = (c / torch.clamp(n, min=1.0))[:, None]
        state["c"].copy_(c)
        state["n"].copy_(n)
    else:
        b, t, d = z.shape
        c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        hs = []
        for s in range(t):
            c = f[:, s] * c + i[:, s] * z[:, s]
            n = f[:, s] * n + i[:, s]
            hs.append(c / torch.clamp(n, min=1.0))
        h = torch.stack(hs, dim=1)
    y = _proj(h.to(L.Compute) * o, p["wo"])
    if split:
        y = lm.reduce_parts(y, mesh, "model")
    return x + y, state


# --------------------------------------------------------------------------
# Stack assembly (pattern groups, like recurrent.py)
# --------------------------------------------------------------------------

def _pattern_layout(cfg: ModelConfig):
    pat = cfg.block_pattern or ("mlstm",) * 7 + ("slstm",)
    n_groups = cfg.n_layers // len(pat)
    return n_groups, pat, pat[: cfg.n_layers - n_groups * len(pat)]


def init_group(cfg: ModelConfig, gen, pattern, *, device) -> dict:
    return {f"b{i}_{kind}": (
        init_mlstm_block(gen, cfg.d_model, cfg.n_heads, device=device)
        if kind == "mlstm" else init_slstm_block(gen, cfg.d_model,
                                                 device=device))
        for i, kind in enumerate(pattern)}


def init_xlstm(cfg: ModelConfig, gen: torch.Generator, *, device,
               keep=None) -> dict:
    """Random parameters from ``gen`` on ``device`` (the JAX initialisers'
    distributions; not their numbers); ``keep`` as ``layers.keep_tree``."""
    n_groups, pat, tail = _pattern_layout(cfg)
    groups = L.stack_trees([
        L.keep_tree(keep, ("groups",), init_group(cfg, gen, pat,
                                                  device=device))
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
    _, pat, tail = _pattern_layout(cfg)
    for gp in L.unstack_tree(tree["groups"]):
        yield gp, pat, ("groups",)
    if tail:
        yield tree["tail"], tail, ("tail",)


def _run_pattern(cfg, x, gp, pattern, states=None, gather=None, mesh=None):
    if gather is not None:
        gp = gather(gp)
    for i, kind in enumerate(pattern):
        key = f"b{i}_{kind}"
        st = states[key] if states is not None else None
        if kind == "mlstm":
            x, _ = mlstm_block(gp[key], x, n_heads=cfg.n_heads,
                               eps=cfg.norm_eps, state=st, mesh=mesh)
        else:
            x, _ = slstm_block(gp[key], x, eps=cfg.norm_eps, state=st,
                               mesh=mesh)
    return x


def _gather(weights, path):
    return None if weights is None else functools.partial(weights, path)


def forward_xlstm(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
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
    group = L.remat_all(functools.partial(
        _run_pattern, cfg, gather=_gather(weights, ("groups",)), mesh=mesh),
        cfg.remat_policy)
    _, pat, tail = _pattern_layout(cfg)
    for gp in L.unstack_tree(params["groups"]):
        x = group(x, gp, pat)
    if tail:
        x = _run_pattern(cfg, x, params["tail"], tail,
                         gather=_gather(weights, ("tail",)), mesh=mesh)
    if last_only:
        x = x[:, -1:]
    return (head_logits(params, cfg, x, weights, mesh), None,
            torch.zeros((), device=x.device))


def state_block(cfg: ModelConfig, mesh=None) -> tuple[int, int]:
    """(heads, columns) of a rank's mLSTM state on ``mesh``'s "model" axis
    (any mesh, or a ``MeshLayout``): ``C`` is [heads, h, columns], ``n``
    [heads, columns].  N / m whole heads where the rules split the heads;
    every head's h / m columns (``C``'s value columns, ``n``'s key
    columns) where they split head_dim (``sharding.model_head_dim``), as
    ``state_specs`` places them; else the whole state."""
    from ..distributed.sharding import model_head_dim, model_span
    m = L.model_size(mesh)
    hd = cfg.d_model // cfg.n_heads
    span = model_head_dim(cfg.n_heads, hd, m, 0)
    if span is not None:
        return cfg.n_heads, span[1]
    span = model_span(cfg.n_heads, m, 0)
    return (cfg.n_heads if span is None else span[1]), hd


def _group_state(cfg: ModelConfig, batch: int, pattern, *, lead=(),
                 device, mesh=None) -> dict:
    from ..distributed.sharding import model_span
    hd = cfg.d_model // cfg.n_heads
    nh, cols = state_block(cfg, mesh)
    span = model_span(cfg.d_model, L.model_size(mesh), 0)
    d = cfg.d_model if span is None else span[1]
    f32 = dict(dtype=torch.float32, device=device)
    st = {}
    for i, kind in enumerate(pattern):
        if kind == "mlstm":
            st[f"b{i}_{kind}"] = {
                "C": torch.zeros((*lead, batch, nh, hd, cols), **f32),
                "n": torch.zeros((*lead, batch, nh, cols), **f32),
            }
        else:
            st[f"b{i}_{kind}"] = {
                "c": torch.zeros((*lead, batch, d), **f32),
                "n": torch.zeros((*lead, batch, d), **f32),
            }
    return st


def init_xlstm_state(cfg: ModelConfig, batch: int, *, device,
                     mesh=None) -> dict:
    """The zero decode state of ``batch`` rows; on ``mesh`` (any mesh, or a
    ``MeshLayout``) a rank's: the mLSTM block of ``state_block``, the
    sLSTM's D / m channels where the rules split them (the rows are the
    caller's)."""
    n_groups, pat, tail = _pattern_layout(cfg)
    state = {"groups": _group_state(cfg, batch, pat, lead=(n_groups,),
                                    device=device, mesh=mesh)}
    if tail:
        state["tail"] = _group_state(cfg, batch, tail, device=device,
                                     mesh=mesh)
    return state


def decode_step_xlstm(params: dict, cfg: ModelConfig, state: dict,
                      tokens: torch.Tensor, pos: int, *, mesh=None,
                      weights=None):
    """One-token decode; returns (logits, state), the state updated in
    place.  ``pos`` is unused (the cells keep no positions).  ``mesh`` and
    ``weights`` as ``forward_xlstm``'s; the state is this rank's
    (``init_xlstm_state(..., mesh=)``)."""
    mesh = model_axis(mesh)
    x = embed_tokens(params, cfg, tokens, mesh, weights)
    for (gp, pattern, path), (st, _, _) in zip(_groups(cfg, params),
                                               _groups(cfg, state)):
        x = _run_pattern(cfg, x, gp, pattern, states=st,
                         gather=_gather(weights, path), mesh=mesh)
    return head_logits(params, cfg, x, weights, mesh), state
