"""Launch wrapper of the one-hot product block-map kernel (B8).

``onehot_block_maps_cuda`` launches the Hopper kernel of
``csrc/onehot_match.cu``: per (chunk, symbol block) the product of the
one-hot transition matrices ``P_c[k, n] = (table[k, c] == n)`` of the
block's symbols on the tensor cores (``wgmma`` bf16, float32 accumulate,
the accumulator in registers, 64 rows per warpgroup), then the argmax of
every row: the block's map ``delta*(q, block)`` for every state q.  It replaces the Pallas kernel
``repro/kernels/onehot_match.py::onehot_match_kernel``, batched over chunks:
one launch covers every (chunk, block).  Products of one-hot matrices keep
one 1 per row, so bf16 is exact; Q is at most 256.

``onehot_block_maps_torch`` is its plain version, the same products in
float32 through ``build_pmats``; ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["build_pmats", "onehot_block_maps_cuda", "onehot_block_maps_torch",
           "onehot_plan", "launches", "reset_launches", "MAX_STATES"]

# kernel launches per wrapper; incremented only where the kernel launches
launches = {"onehot_block_maps": 0}

MAX_STATES = 256          # the kernel keeps a state in a byte
SMEM_BUDGET = 232_448     # dynamic shared memory one block may use (H100)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def onehot_plan(q: int) -> dict:
    """The kernel's launch plan for Q states, as ``csrc/onehot_match.cu``'s
    ``Cfg`` computes it: Q padded to ``qp``, ``slabs`` of 64 rows, one
    consumer warpgroup per slab and up to two per CTA (``consumers``,
    ``ctas`` per symbol block, ``threads`` with the producer: a warp, or
    from ``qp`` = 192 a warpgroup that lends its registers), and
    the ring of P_c buffers: ``chunks`` per P_c (2 when two full P_c do
    not fit in shared memory), ``stages`` buffers, ``smem`` bytes (with
    the 1 KiB alignment slack)."""
    if not 1 <= q <= MAX_STATES:
        raise ValueError(f"the one-hot kernel takes 1 <= Q <= {MAX_STATES}, "
                         f"got {q}")
    qp = -(-q // 16) * 16
    slabs = -(-qp // 64)
    consumers = 2 if slabs >= 2 else 1
    region = qp * 128                      # 64 k columns of QP rows, bf16
    split = 2 * slabs * region + 1024 + 64 > SMEM_BUDGET
    buf = 2 * region if split else slabs * region
    stages = 3 if split else min(8, max(2, 65536 // buf))
    return dict(qp=qp, slabs=slabs, consumers=consumers,
                ctas=-(-slabs // consumers),
                threads=consumers * 128 + (128 if qp >= 192 else 32),
                chunks=2 if split else 1, stages=stages,
                smem=stages * buf + 16 * stages + 1024)


def build_pmats(table: torch.Tensor) -> torch.Tensor:
    """Per-class one-hot transition matrices, flattened [n_cls * Q, Q] bf16
    (row q of block c is onehot(table[q, c]))."""
    q, n_cls = table.shape
    eye = torch.eye(q, dtype=torch.bfloat16, device=table.device)
    return eye[table.T.long()].reshape(n_cls * q, q)


def _check_blocks(symbols, l_blk: int) -> tuple[int, int]:
    if symbols.dim() != 2:
        raise ValueError(f"symbols must be [C, L], got {tuple(symbols.shape)}")
    c, l = symbols.shape
    if l_blk < 1 or l % l_blk:
        raise ValueError(f"L={l} is not a multiple of l_blk={l_blk}")
    return c, l // l_blk


def onehot_block_maps_cuda(table, symbols, *, l_blk: int):
    """B8 on the card: symbols [C, L] (L a multiple of ``l_blk``, class ids
    < n_cls) -> block maps [C, L / l_blk, Q] int32; table [Q, n_cls] with
    Q <= 256, all contiguous int32 on one CUDA device.  Never
    synchronises."""
    dev = symbols.device
    for t in (table, symbols):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("onehot_block_maps_cuda needs every operand on "
                             f"one CUDA device, got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("operands must be contiguous int32 tensors")
    q, n_cls = table.shape
    if q > MAX_STATES:
        raise ValueError(f"the one-hot kernel takes Q <= {MAX_STATES}, "
                         f"got {q}")
    c, nb = _check_blocks(symbols, l_blk)
    out = torch.empty((c, nb, q), dtype=torch.int32, device=dev)
    if c * nb == 0 or q == 0:
        return out
    fn = _build.load("onehot_match").onehot_block_maps_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), symbols.data_ptr(), out.data_ptr(),
                 c * nb, q, n_cls, nb, l_blk, stream)
    if err:
        raise RuntimeError("onehot_block_maps kernel launch failed: CUDA "
                           f"error {err}")
    launches["onehot_block_maps"] += 1
    return out


def onehot_block_maps_torch(table, symbols, *, l_blk: int):
    """Plain version of B8: the block products of ``build_pmats``'s
    matrices in float32 (exact for 0/1 entries), then the row argmax ->
    [C, L / l_blk, Q] int32."""
    c, nb = _check_blocks(symbols, l_blk)
    q, n_cls = table.shape
    pmats = build_pmats(table).float().reshape(n_cls, q, q)
    blocks = symbols.reshape(c * nb, l_blk).long()
    acc = torch.eye(q, device=symbols.device).expand(c * nb, q, q)
    for t in range(l_blk):
        acc = torch.bmm(acc, pmats[blocks[:, t]])
    return acc.argmax(-1).to(torch.int32).reshape(c, nb, q)
