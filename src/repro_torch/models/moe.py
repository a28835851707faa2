"""Mixture-of-Experts FFN with top-k token-choice routing.

The port of the JAX package's ``models/moe.py``, local path only: every
expert lives on this device.  The expert-parallel path (the JAX package's
``_moe_sharded``: ``all_to_all`` over the LM mesh's "model" axis) is not
ported yet (ROADMAP A15), so ``moe_mlp`` refuses a mesh with that axis.

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


def _route(p, x_flat, top_k: int):
    """Router: probs -> top-k (gates renormalised, Mixtral-style).

    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them
    (bf16 router logits tie exactly): a stable descending sort keeps equal
    probabilities in index order.
    """
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
            mesh=None, expert_axis: str = "model"):
    """x [B, T, D] -> ([B, T, D], aux_loss).  ``mesh`` (a ``DeviceMesh``)
    with an ``expert_axis`` dimension asks for expert parallelism, which
    raises."""
    if mesh is not None and expert_axis in tuple(mesh.mesh_dim_names or ()):
        raise NotImplementedError(
            f"expert parallelism over the mesh's {expert_axis!r} axis is not "
            "ported yet (ROADMAP A15, moe._moe_sharded); pass mesh=None for "
            "the local path")
    return _moe_local(p, x, top_k, capacity_factor)


def _moe_local(p, x, top_k, capacity_factor):
    b, t, d = x.shape
    e = p["router"].shape[1]
    x_flat = x.reshape(-1, d)
    n = x_flat.shape[0]
    capacity = max(top_k, int(math.ceil(n * top_k * capacity_factor / e)))
    gates, ids, aux = _route(p, x_flat, top_k)
    slot = _slots(ids, e, capacity)                       # [n, k]
    keep = slot >= 0
    # dropped choices write to a spare last row (no host sync on a mask)
    spare = e * capacity
    buf = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, spare).reshape(-1)] = \
        x_flat.repeat_interleave(top_k, dim=0)
    h = _expert_ffn(p, buf[:spare].reshape(e, capacity, d)).reshape(spare, d)
    picked = h[slot.clamp(min=0)].float()                 # [n, k, d]
    w = torch.where(keep, gates.float(), torch.zeros((), device=x.device))
    out = (picked * w[..., None]).sum(1).to(x.dtype)
    return out.reshape(b, t, d), aux
