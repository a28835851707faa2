"""Launch wrapper of the fused flash-attention forward kernel (B9).

``flash_attn_cuda`` launches the Hopper kernel of ``csrc/flash_attn.cu``: the
online-softmax recurrence over 128-row kv tiles that a producer warpgroup
loads by TMA, with ``wgmma`` bf16 products on two consumer warpgroups,
float32 m/l/acc in registers and dead causal/window tiles skipped.  It replaces
the Pallas kernel ``repro/kernels/flash_attn.py::flash_attn_kernel``.
``flash_attn_torch`` is its plain PyTorch version (the same recurrence, tile
by tile), and ``launches`` counts kernel launches only.

Operands: q [BH, T, D], k and v [BH / group, S, D], bfloat16, contiguous, on
one CUDA device; head h attends with kv head h // group, so a GQA caller
hands over its kv heads without repeating them.  D is 16, 32, 64 or 128.
Returns [BH, T, D] bfloat16.

``FakeTensor`` operands (a dry run's trace of the card's program,
``launch.dryrun``: fake CPU tensors inside ``census_hooks.fake_card``, or
fake CUDA ones) take a path of their own in
``flash_attn_cuda``: it counts one launch and its work (``flash_work``) in
the census being taken and returns an empty output of the right shape,
launching nothing.  Real tensors never take it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import census_hooks as _hooks

__all__ = ["flash_attn_cuda", "flash_attn_torch", "flash_plan", "flash_work",
           "launches", "reset_launches", "HEAD_DIMS"]

# kernel launches; incremented only where the kernel launches
launches = {"flash_attn": 0}

HEAD_DIMS = (16, 32, 64, 128)   # template instances in csrc/flash_attn.cu
NEG = -1e30
KV_BLK = 64                     # the plain version's kv tile
BLK_CUDA = 128                  # kBlockQ = kBlockK in csrc/flash_attn.cu


def reset_launches() -> None:
    launches["flash_attn"] = 0


def flash_plan(t: int, s: int, d: int, *, causal: bool = True,
               window: int = 0) -> dict:
    """The kernel's launch plan, as ``csrc/flash_attn.cu`` computes it:
    ``swizzle`` bytes of a shared-memory row and ``parts`` (64-column TMA
    boxes) per row, ``stages`` of the K/V ring, ``smem`` bytes (with the
    1 KiB alignment slack), ``q_blocks`` of 128 rows per head, and for q
    block b (rows 128 b ..) the live kv tiles ``tiles[b] = (j_lo, j_hi)``
    of 128 rows that the producer loads and the consumers walk."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    sw = min(2 * d, 128)
    stages = 2 if d == 128 else 3
    # two Q blocks, the K/V ring, barriers, alignment slack
    smem = BLK_CUDA * d * 2 * (2 + 2 * stages) + 8 * (2 * stages + 4) + 1024
    n_tiles = -(-s // BLK_CUDA)
    tiles = []
    for b in range(-(-t // BLK_CUDA)):
        q_lo, q_hi = b * BLK_CUDA, min(b * BLK_CUDA + BLK_CUDA, t) - 1
        j_hi = min(n_tiles, q_hi // BLK_CUDA + 1) if causal else n_tiles
        k_first = q_lo - window + 1
        j_lo = min(j_hi, k_first // BLK_CUDA
                   if window > 0 and k_first > 0 else 0)
        tiles.append((j_lo, j_hi))
    return dict(swizzle=sw, parts=2 * d // sw, stages=stages, smem=smem,
                q_blocks=len(tiles), tiles=tiles)


def flash_work(q, k, v, *, causal: bool = True, window: int = 0,
               group: int = 1) -> tuple[float, float]:
    """(flops, bytes) of one call: 4 * D flops per unmasked (q, k) pair
    (QK^T and PV), and Q, K, V read once and O written once."""
    bh, t, s, d = _shapes(q, k, v, group)
    pos = np.arange(t)
    hi = np.minimum(pos + 1, s) if causal else np.full(t, s)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(t, int)
    pairs = float(np.maximum(hi - lo, 0).sum())
    n_bytes = q.element_size() * d * (2 * bh * t + 2 * k.shape[0] * s)
    return 4.0 * d * bh * pairs, float(n_bytes)


def _entry():
    fn = _build.load("flash_attn").flash_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _shapes(q, k, v, group):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be [BH, T, D] and k, v [BH / group, S, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, t, d = q.shape
    if group < 1 or bh % group or k.shape[0] != bh // group \
            or k.shape[2] != d:
        raise ValueError(f"k/v heads {k.shape[0]} do not serve {bh} query "
                         f"heads in groups of {group}")
    return bh, t, k.shape[1], d


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, group: int = 1):
    """B9 on the card -> [BH, T, D] bf16; never synchronises.  Fake
    operands launch nothing (see the module's docstring)."""
    dev = q.device
    fake = _hooks.is_fake(q)
    for x in (q, k, v):
        if x.device != dev or not _hooks.on_card(x):
            raise ValueError("flash_attn_cuda needs every operand on one "
                             f"CUDA device, got {x.device}")
        if _hooks.is_fake(x) != fake:
            raise ValueError("flash_attn_cuda got FakeTensors and real "
                             "tensors together")
        if x.dtype != torch.bfloat16 or not x.is_contiguous() \
                or (not fake and x.data_ptr() % 16):
            raise ValueError("flash_attn_cuda needs contiguous, 16-byte "
                             "aligned bfloat16 operands")
    bh, t, s, d = _shapes(q, k, v, group)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if bh == 0 or t == 0:
        return out
    if s == 0:                  # no key: acc = l = 0, out = 0 / 1e-30
        return out.zero_()
    if fake:                    # a trace: count the launch, run nothing
        _hooks.record_kernel("flash_attn", 1, *flash_work(
            q, k, v, causal=causal, window=window, group=group))
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), bh, t, s, d, group, int(bool(causal)),
                       int(window), d ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err}")
    launches["flash_attn"] += 1
    return out


def flash_attn_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0, group: int = 1):
    """Plain version of B9: the recurrence over 64-row kv tiles (the
    kernel takes two such steps per 128-row tile).

    Products of bf16 values summed in float32 (the tensor cores' bf16 x bf16
    -> f32), f32 m/l/acc, p rounded to bf16 before it is summed into l and
    multiplied with V.
    """
    bh, t, s, d = _shapes(q, k, v, group)
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = d ** -0.5
    qf = q.float()
    m = torch.full((bh, t), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, t, d), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(t, device=q.device)[:, None]
    neg = torch.tensor(NEG, device=q.device)
    for k_lo in range(0, s, KV_BLK):
        kj = k[:, k_lo:k_lo + KV_BLK].float()
        vj = v[:, k_lo:k_lo + KV_BLK].float()
        k_pos = torch.arange(k_lo, k_lo + kj.shape[1], device=q.device)[None]
        logit = torch.matmul(qf, kj.transpose(1, 2)) * scale
        ok = torch.ones_like(logit[0], dtype=torch.bool)
        if causal:
            ok &= k_pos <= q_pos
        if window > 0:
            ok &= k_pos > q_pos - window
        logit = torch.where(ok[None], logit, neg)
        m_new = torch.maximum(m, logit.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logit - m_new[..., None]).to(torch.bfloat16).float()
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vj)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
