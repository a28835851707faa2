"""Blockwise (flash-style) attention in plain PyTorch ops.

The port of the JAX package's XLA attention path.  Prefill and long queries
run blockwise with online-softmax carries over the **static list of valid
(q-block, kv-block) pairs**: causal masking skips the upper triangle and a
sliding window keeps only the band, so dead tiles are never computed.

The numerics mirror the JAX code step for step: logit tiles are bf16
products cast to float32, the max and the sum are float32, ``p`` is rounded
to bf16 before it is summed and multiplied with V, and the accumulator is
**bf16** (the query dtype), unlike the float32 accumulator of the fused
kernel B9.  ``scaled_dot_product_attention`` is deliberately not used: it
computes something else numerically.

Decode (short query) takes the direct path: scores are [.., t, S] with
t <= 16.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flash_attention", "direct_attention", "valid_block_pairs"]

NEG = -1e30


def _block_mask(q_pos, k_pos, *, causal: bool, window: int, kv_valid):
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if kv_valid is not None:
        ok &= k_pos[None, :] < kv_valid
    return ok


def direct_attention(q, k, v, *, q_offset=0, causal=True, window: int = 0,
                     kv_valid=None):
    """q [b,t,n_kv,g,h]; k,v [b,s,n_kv,h] -> [b,t,n_kv,g,h]."""
    b, t, n_kv, g, h = q.shape
    s = k.shape[1]
    logits = torch.einsum("btkgh,bskh->bkgts", q, k).float() * h ** -0.5
    q_pos = torch.arange(t, device=q.device) + q_offset
    k_pos = torch.arange(s, device=q.device)
    ok = _block_mask(q_pos, k_pos, causal=causal, window=window,
                     kv_valid=kv_valid)
    logits = torch.where(ok[None, None, None], logits,
                         torch.tensor(NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskh->btkgh", probs, v)


def valid_block_pairs(nq: int, ns: int, q_block: int, kv_block: int,
                      q_offset_static: int, *, causal: bool,
                      window: int) -> np.ndarray:
    """Static (i, j) block pairs that can contain unmasked entries."""
    pairs = []
    for i in range(nq):
        q_lo = i * q_block + q_offset_static
        q_hi = q_lo + q_block - 1
        for j in range(ns):
            k_lo = j * kv_block
            k_hi = k_lo + kv_block - 1
            if causal and k_lo > q_hi:
                continue  # entirely in the future
            if window > 0 and k_hi <= q_lo - window:
                continue  # entirely out of the lookback band
            pairs.append((i, j))
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def flash_attention(q, k, v, *, q_offset=0, causal=True, window: int = 0,
                    kv_valid=None, q_block: int = 512, kv_block: int = 1024,
                    q_offset_static: int = 0):
    """Blockwise attention with static causal/window block pruning.

    Each q block loops over only its statically valid kv prefix/band.
    ``q_offset`` may differ from ``q_offset_static`` (the pruning offset, 0
    in prefill); in-tile masking stays exact.  Shapes as in
    ``direct_attention``; ``t % min(q_block, t) == 0`` and
    ``s % min(kv_block, s) == 0`` as in the JAX path.
    """
    b, t, n_kv, g, h = q.shape
    s = k.shape[1]
    q_block = min(q_block, t)
    kv_block = min(kv_block, s)
    assert t % q_block == 0 and s % kv_block == 0, (t, s, q_block, kv_block)
    nq = t // q_block
    scale = h ** -0.5
    neg = torch.tensor(NEG, device=q.device)

    outs = []
    for i in range(nq):
        q_lo_s = i * q_block + q_offset_static
        q_hi_s = q_lo_s + q_block - 1
        j_hi = (min(q_hi_s, s - 1) // kv_block) if causal \
            else (s - 1) // kv_block
        j_lo = max(0, (q_lo_s - window + 1) // kv_block) if window > 0 else 0
        j_hi = max(j_hi, j_lo)

        qi = q[:, i * q_block:(i + 1) * q_block]
        q_pos = torch.arange(q_block, device=q.device) + i * q_block + q_offset
        m = torch.full((b, n_kv, g, q_block), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, n_kv, g, q_block), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, n_kv, g, q_block, h), dtype=q.dtype,
                          device=q.device)
        for j in range(j_lo, j_hi + 1):
            kj = k[:, j * kv_block:(j + 1) * kv_block]
            vj = v[:, j * kv_block:(j + 1) * kv_block]
            k_pos = torch.arange(kv_block, device=q.device) + j * kv_block
            logit = torch.einsum("bqkgh,bskh->bkgqs", qi, kj).float() * scale
            ok = _block_mask(q_pos, k_pos, causal=causal, window=window,
                             kv_valid=kv_valid)
            logit = torch.where(ok[None, None, None], logit, neg)
            m_new = torch.maximum(m, logit.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logit - m_new[..., None]).to(q.dtype)  # bf16 tile
            l = l * alpha + p.float().sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p, vj)
            acc = acc * alpha[..., None].to(acc.dtype) + pv
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out_i.permute(0, 3, 1, 2, 4))  # [b,qb,k,g,h]
    return torch.cat(outs, dim=1) if nq > 1 else outs[0]
