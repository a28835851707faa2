"""Mixture-of-Experts FFN with top-k token-choice routing.

The port of the JAX package's ``models/moe.py``.  Two paths with the
reference's semantics:

  * ``local``   -- every expert on this device;
  * ``sharded`` -- expert parallelism on an LM mesh (``launch.mesh
    .LMMesh``) with the expert axis: each rank routes its token block,
    dispatches into per-expert capacity buffers, exchanges them with an
    ``all_to_all`` over the expert axis (experts live there), runs its own
    experts and exchanges the results back (the reference's
    ``_moe_sharded``).

Capacity: C = max(top_k, ceil(tokens * top_k * capacity_factor / E));
overflowing token choices are dropped (their residual stream passes
through), the standard GShard/Switch behaviour, on exactly the choices the
reference drops.  The reference builds one-hot dispatch and combine
tensors from an ``[n·k, E, C]`` transient and contracts them with einsums;
the port computes each choice's slot ``e·C + rank`` once, gathers the
tokens into the ``[E, C, d]`` expert buffer and gathers the expert outputs
back: the same buffer bit for bit (a 0/1 dispatch moves values unchanged),
the same gate-weighted sum.
"""

from __future__ import annotations

import math

import torch

from .layers import Compute, silu, truncated_normal

__all__ = ["init_moe", "moe_mlp"]

MOE_EXPERTS = ("wi_gate", "wi_up", "wo")


def init_moe(gen, d_model: int, d_ff: int, n_experts: int, *, device):
    return {
        "router": truncated_normal(gen, (d_model, n_experts),
                                   d_model ** -0.5, device=device),
        "wi_gate": truncated_normal(gen, (n_experts, d_model, d_ff),
                                    d_model ** -0.5, device=device),
        "wi_up": truncated_normal(gen, (n_experts, d_model, d_ff),
                                  d_model ** -0.5, device=device),
        "wo": truncated_normal(gen, (n_experts, d_ff, d_model),
                               d_ff ** -0.5, device=device),
    }


def _route(p, x_flat, top_k: int, logits=None):
    """Router: probs -> top-k (gates renormalised, Mixtral-style).

    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them
    (bf16 router logits tie exactly): a stable descending sort keeps equal
    probabilities in index order.  ``logits`` (the router's, when the
    caller computed them) stand in for ``x_flat @ router``.
    """
    if logits is None:
        logits = torch.matmul(x_flat, p["router"].to(Compute))
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k].to(torch.int32)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch eq. 4): E * sum_e f_e * p_e
    e = probs.shape[-1]
    me = probs.mean(dim=0)
    flat = ids.reshape(-1).long()
    ce = torch.zeros(e, device=ids.device).scatter_add_(
        0, flat, torch.ones(flat.shape, device=ids.device)) / ids.numel()
    aux = e * torch.sum(me * ce)
    return gates.to(Compute), ids, aux


def _slots(ids, n_experts: int, capacity: int):
    """Each choice's slot ``e * capacity + rank`` in the expert buffer, -1
    where the choice is dropped.  ids [n, k]; the rank of a choice within
    its expert counts the earlier choices, token-major, as the reference's
    one-hot cumsum does: a stable sort by expert keeps that order, and a
    choice's rank is its sorted position less its expert's first one."""
    flat = ids.reshape(-1).long()                         # [n*k], token-major
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) \
        - first[flat[order]]
    slot = torch.where(rank < capacity, flat * capacity + rank,
                       torch.full_like(flat, -1))
    return slot.reshape(ids.shape)


def _dispatch_tensors(ids, gates, n_experts: int, capacity: int):
    """Position-in-expert assignment -> dispatch/combine one-hots.

    ids [n, k] int32, gates [n, k].  Returns dispatch [n, E, C] (0/1,
    Compute) and combine [n, E, C] (Compute), the reference's tensors,
    scattered from ``_slots``: a token's k choices name distinct experts,
    so no two land in one (token, slot) cell.  Dropped choices land in a
    spare last column, cut off.
    """
    n = ids.shape[0]
    spare = n_experts * capacity
    slot = _slots(ids, n_experts, capacity)
    cols = torch.where(slot >= 0, slot, spare)
    disp = torch.zeros((n, spare + 1), dtype=Compute, device=ids.device)
    combine = torch.zeros_like(disp).scatter_(1, cols, gates.to(Compute))
    disp.scatter_(1, cols, 1.0)
    shape = (n, n_experts, capacity)
    return disp[:, :spare].reshape(shape), combine[:, :spare].reshape(shape)


def _expert_ffn(p, h):
    """h [E, C, d] -> [E, C, d] SwiGLU per expert (E-major grouped GEMM)."""
    gate = torch.bmm(h, p["wi_gate"].to(Compute))
    up = torch.bmm(h, p["wi_up"].to(Compute))
    return torch.bmm(silu(gate) * up, p["wo"].to(Compute))


def moe_mlp(p, x, *, top_k: int, capacity_factor: float = 1.25,
            mesh=None, expert_axis: str = "model",
            batch_axes: tuple[str, ...] = ("pod", "data")):
    """x [B, T, D] -> ([B, T, D], aux_loss).

    ``mesh`` (a ``launch.mesh.LMMesh``) with an ``expert_axis`` asks for
    expert parallelism (``_moe_sharded``); without one the local path
    runs.  On a mesh ``x`` is the caller's rows, the same on every rank of
    the expert axis, and so is the result: the transformer hands its "model"
    axis alone (its rows already split over the data axes, its attention
    run tensor-parallel before), and the block split then cuts the sequence
    over "model"; a mesh with data axes also splits the rows over them.
    The expert leaves of ``p`` (``wi_gate``, ``wi_up``, ``wo``) are this
    rank's own ``[E / ep, ...]`` shard, as ``distributed.sharding
    .param_specs`` places them, and the router is whole.
    """
    if mesh is None or expert_axis not in tuple(mesh.mesh_dim_names or ()):
        return _moe_local(p, x, top_k, capacity_factor)
    return _moe_sharded(p, x, top_k, capacity_factor, mesh, expert_axis,
                        batch_axes)


def _dispatch(x_flat, slot, n_experts: int, capacity: int):
    """The [E, C, d] expert buffer: each kept choice's token at its slot;
    dropped choices write to a spare last row (no host sync on a mask)."""
    top_k = slot.shape[1]
    d = x_flat.shape[1]
    spare = n_experts * capacity
    keep = slot >= 0
    buf = torch.zeros((spare + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    buf = buf.index_put((torch.where(keep, slot, spare).reshape(-1),),
                        x_flat.repeat_interleave(top_k, dim=0))
    return buf[:spare].reshape(n_experts, capacity, d)


def _combine(h, slot, gates, dtype):
    """Each token's gate-weighted sum of its kept choices' expert outputs
    (h [E, C, d])."""
    h = h.reshape(-1, h.shape[-1])
    keep = slot >= 0
    picked = h[slot.clamp(min=0)].float()                 # [n, k, d]
    w = torch.where(keep, gates.float(), torch.zeros((), device=h.device))
    return (picked * w[..., None]).sum(1).to(dtype)


def _moe_local(p, x, top_k, capacity_factor):
    b, t, d = x.shape
    e = p["router"].shape[1]
    x_flat = x.reshape(-1, d)
    n = x_flat.shape[0]
    capacity = max(top_k, int(math.ceil(n * top_k * capacity_factor / e)))
    gates, ids, aux = _route(p, x_flat, top_k)
    slot = _slots(ids, e, capacity)                       # [n, k]
    h = _expert_ffn(p, _dispatch(x_flat, slot, e, capacity))
    return _combine(h, slot, gates, x.dtype).reshape(b, t, d), aux


def _moe_sharded(p, x, top_k, capacity_factor, mesh, expert_axis,
                 batch_axes):
    """Expert parallelism, one SPMD program a rank (the reference's
    ``shard_map`` region, ``_moe_sharded``).

    Each rank takes a [b_loc, t_loc, d] block: the batch split over the
    batch axes when they divide it, the sequence over the expert axis when
    that divides it (a decode step, t = 1, keeps it whole).  It routes its
    tokens with the capacity of its own token count, builds [E, C, d] send
    buffers, exchanges them (experts split, capacity concatenated) so each
    rank runs its resident experts on tokens from every peer, and
    exchanges the results back.  The aux loss is averaged over the axes
    that split the tokens (over the others every rank holds the same).

    The router's logits are one product over all of the caller's tokens,
    split into blocks like the tokens: a token's routing does not depend
    on its block, and one product of the caller's shape rounds each logit
    as the local path does (a block's smaller product may take another
    accumulation order, and a bf16 logit one ulp off flips top-k picks).

    Gradients: the block split's backward all-gathers, the result's
    gather keeps this rank's part, the exchanges reverse, and, where the
    batch is split, the expert shard sums its gradient over the batch
    axes (``launch.mesh``'s differentiable collectives).
    """
    from ..launch import mesh as lmesh

    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in batch_axes if a in names)
    ep = mesh.axis_size(expert_axis)
    e = p["router"].shape[1]
    if e % ep:
        raise ValueError(f"{e} experts do not split over the "
                         f"{ep}-way {expert_axis!r} axis")
    if p["wi_gate"].shape[0] != e // ep:
        raise ValueError(f"expert leaves hold {p['wi_gate'].shape[0]} "
                         f"experts; a rank of the {ep}-way "
                         f"{expert_axis!r} axis takes its {e // ep}")
    dp_size = mesh.axis_size(axes)
    batch_split = bool(axes) and dp_size > 1 and x.shape[0] % dp_size == 0
    seq_split = x.shape[1] % ep == 0
    split_axes = (axes if batch_split else ()) + \
        ((expert_axis,) if seq_split else ())

    def block(y):
        if batch_split:
            y = lmesh.split(y, mesh, axes, 0)
        if seq_split:
            y = lmesh.split(y, mesh, expert_axis, 1)
        return y

    x_loc = block(x)
    b_loc, t_loc, d = x_loc.shape
    logits = block(torch.matmul(x, p["router"].to(Compute)))
    experts = {k: p[k] for k in MOE_EXPERTS}
    if batch_split:
        experts = {k: lmesh.sum_grads(v, mesh, axes)
                   for k, v in experts.items()}
    x_flat = x_loc.reshape(-1, d)
    n = x_flat.shape[0]
    capacity = max(top_k, int(math.ceil(n * top_k * capacity_factor / e)))
    gates, ids, aux = _route(None, x_flat, top_k,
                             logits=logits.reshape(n, e))
    slot = _slots(ids, e, capacity)
    send = _dispatch(x_flat, slot, e, capacity)           # [E, C, d]
    recv = lmesh.exchange(send, mesh, expert_axis, 0, 1)  # [E/ep, ep*C, d]
    h = _expert_ffn(experts, recv)
    back = lmesh.exchange(h, mesh, expert_axis, 1, 0)     # [E, C, d]
    out = _combine(back, slot, gates, x.dtype).reshape(b_loc, t_loc, d)
    aux = lmesh.replica_mean(aux, mesh, split_axes)
    if seq_split:
        out = lmesh.gather(out, mesh, expert_axis, 1)
    if batch_split:
        out = lmesh.gather(out, mesh, axes, 0)
    return out, aux
