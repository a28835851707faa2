"""Launch wrapper of the one-hot product block-map kernel (B8).

``onehot_block_maps_cuda`` launches the Hopper kernel of
``csrc/onehot_match.cu``: per (chunk, symbol block) the product of the
one-hot transition matrices ``P_c[k, n] = (table[k, c] == n)`` of the
block's symbols on the tensor cores (``mma.sync`` bf16, float32
accumulate), then the argmax of every row: the block's map
``delta*(q, block)`` for every state q.  It replaces the Pallas kernel
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
           "launches", "reset_launches", "MAX_STATES"]

# kernel launches per wrapper; incremented only where the kernel launches
launches = {"onehot_block_maps": 0}

MAX_STATES = 256          # the kernel keeps a state in a byte
SMEM_BUDGET = 232_448     # dynamic shared memory one block may use (H100)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    qp = -(-q // 16) * 16
    smem = qp * (qp // 2 + 4) * 4 + n_cls * qp + l_blk * 4
    if smem > SMEM_BUDGET:
        raise ValueError(f"l_blk={l_blk} does not fit in shared memory")
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
