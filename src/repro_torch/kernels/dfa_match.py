"""Launch wrappers of the fused speculative match + merge kernels (B1, B2).

``spec_match_merge_cuda`` and ``spec_match_merge_lanes_cuda`` launch the
Hopper kernel of ``csrc/dfa_match.cu`` (one CTA per document: chunk x
candidate-lane scan through the packed table, block-granular all-absorbed
early exit, in-CTA Eq. 8 fold).  They replace the Pallas kernels
``repro/kernels/dfa_match.py::spec_match_merge_kernel`` and
``spec_match_merge_lanes_kernel``.  Each has its plain PyTorch version beside
it (``*_torch``), with the same block-granular ``skipped`` count, and a launch
counter in ``launches`` that only a kernel launch increments.

Operands (all int32, contiguous, on one CUDA device): table [Q, n_cls_pad]
with the identity pad column, chunks [B, C, L] (L a multiple of ``l_blk``),
init [B, C, K*S], lookahead [B, C] boundary keys, cand_index
[n_keys + 1, Q], sinks [K], absorbing [Q] 0/1.  ``pad_key`` is the boundary
key the fold passes through (the pad class under r=1, ``n_classes ** 2``
under r=2).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["spec_match_merge_cuda", "spec_match_merge_lanes_cuda",
           "spec_match_merge_torch", "spec_match_merge_lanes_torch",
           "launches", "reset_launches", "smem_plan"]

# kernel launches per wrapper; incremented only where the kernel launches
launches = {"spec_match_merge": 0, "spec_match_merge_lanes": 0}

SMEM_BUDGET = 232_448   # dynamic shared memory one block may use (H100)
SYM_TILE = 64           # must equal SYM_TILE in csrc/dfa_match.cu


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def smem_plan(q: int, n_cls_pad: int, c: int, n_lanes: int,
              table_in_smem: bool | None = None,
              carry_in_smem: bool | None = None) -> tuple[bool, bool]:
    """(table in shared memory, lane carry in shared memory) for one launch.

    The table goes to shared memory first (every symbol step reads it), the
    per-document lane carry (touched once per staged symbol tile) next;
    what does not fit is read from global memory.  ``table_in_smem`` and
    ``carry_in_smem`` force a placement and raise if a forced shared
    placement cannot fit.
    """
    sym = c * SYM_TILE * 4
    tbl = q * n_cls_pad * 4
    if table_in_smem is None:
        table_in_smem = sym + tbl <= SMEM_BUDGET
    elif table_in_smem and sym + tbl > SMEM_BUDGET:
        raise ValueError(f"a {tbl}-byte table does not fit in shared memory")
    fits = sym + (tbl if table_in_smem else 0) + n_lanes * 4 <= SMEM_BUDGET
    if carry_in_smem is None:
        carry_in_smem = fits
    elif carry_in_smem and not fits:
        raise ValueError(f"a {n_lanes}-lane carry does not fit in shared "
                         "memory")
    return bool(table_in_smem), bool(carry_in_smem)


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def _entry(name: str):
    fn = getattr(_build.load("dfa_match"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(lanes: bool, table, chunks, init_states, lookahead, cand_index,
            sinks, absorbing, *, pad_key: int, l_blk: int, early_exit: bool,
            table_in_smem: bool | None, carry_in_smem: bool | None):
    ops = (table, chunks, init_states, lookahead, cand_index, sinks,
           absorbing)
    dev = chunks.device
    for t in ops:
        if t.device != dev or dev.type != "cuda":
            raise ValueError("spec_match_merge_cuda needs every operand on "
                             f"one CUDA device, got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("operands must be contiguous int32 tensors")
    q, n_cls_pad = table.shape
    b, c, l = chunks.shape
    k = sinks.shape[0]
    n_lanes = init_states.shape[-1]
    s = n_lanes // k
    if (init_states.shape != (b, c, k * s) or lookahead.shape != (b, c)
            or cand_index.shape[1] != q or absorbing.shape != (q,)):
        raise ValueError("operand shapes disagree")
    if l_blk < 1 or l % l_blk:
        raise ValueError(f"L={l} is not a multiple of l_blk={l_blk}")
    smem_table, smem_carry = smem_plan(q, n_cls_pad, c, c * n_lanes,
                                       table_in_smem, carry_in_smem)
    out = torch.empty((b, n_lanes if lanes else k), dtype=torch.int32,
                      device=dev)
    skipped = torch.empty(b, dtype=torch.int32, device=dev)
    scratch = (None if smem_carry else
               torch.empty((b, c * n_lanes), dtype=torch.int32, device=dev))
    name = "spec_match_merge_lanes" if lanes else "spec_match_merge"
    if b == 0:
        return out, skipped
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(f"{name}_launch")(
            *(t.data_ptr() for t in ops), out.data_ptr(), skipped.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, c, l, q, n_cls_pad, k, s, int(pad_key), int(l_blk),
            int(bool(early_exit)), int(smem_table), int(smem_carry), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out, skipped


def spec_match_merge_cuda(table, chunks, init_states, lookahead, cand_index,
                          sinks, absorbing, *, pad_key: int, l_blk: int,
                          early_exit: bool = True,
                          table_in_smem: bool | None = None,
                          carry_in_smem: bool | None = None):
    """B1 on the card: ``(finals [B, K], skipped [B])``; never synchronises.
    ``table_in_smem``/``carry_in_smem`` force a placement (``smem_plan``)."""
    return _launch(False, table, chunks, init_states, lookahead, cand_index,
                   sinks, absorbing, pad_key=pad_key, l_blk=l_blk,
                   early_exit=early_exit, table_in_smem=table_in_smem,
                   carry_in_smem=carry_in_smem)


def spec_match_merge_lanes_cuda(table, chunks, init_states, lookahead,
                                cand_index, sinks, absorbing, *, pad_key: int,
                                l_blk: int, early_exit: bool = True,
                                table_in_smem: bool | None = None,
                                carry_in_smem: bool | None = None):
    """B2 on the card: ``(lanes [B, K*S], skipped [B])``."""
    return _launch(True, table, chunks, init_states, lookahead, cand_index,
                   sinks, absorbing, pad_key=pad_key, l_blk=l_blk,
                   early_exit=early_exit, table_in_smem=table_in_smem,
                   carry_in_smem=carry_in_smem)


# --------------------------------------------------------------------------
# plain versions (same arithmetic, same block-granular skip count)
# --------------------------------------------------------------------------

def _scan_blocks(table, chunks, init_states, absorbing, *, l_blk: int,
                 early_exit: bool):
    """[B, C, N] lane states after the block scan, and skipped blocks [B].

    Block j of a document runs unless all its lanes were absorbing after
    block j-1; every block that does not run counts into ``skipped``.
    """
    b, c, l = chunks.shape
    n_cls_pad = table.shape[1]
    flat = table.reshape(-1).long()
    absorb = absorbing.bool()
    cols = chunks.long()
    st = init_states.long()
    done = torch.zeros(b, dtype=torch.bool, device=chunks.device)
    skipped = torch.zeros(b, dtype=torch.int32, device=chunks.device)
    l_blocks = l // l_blk
    for j in range(l_blocks):
        if early_exit and bool(done.all()):
            skipped += l_blocks - j
            break
        nxt = st
        for pos in range(j * l_blk, (j + 1) * l_blk):
            nxt = flat[nxt * n_cls_pad + cols[:, :, pos:pos + 1]]
        st = torch.where(done[:, None, None], st, nxt)
        skipped += done.to(torch.int32)
        if early_exit:
            done |= absorb[st].reshape(b, -1).all(dim=1)
    return st.to(torch.int32), skipped


def spec_match_merge_torch(table, chunks, init_states, lookahead, cand_index,
                           sinks, absorbing, *, pad_key: int, l_blk: int,
                           early_exit: bool = True):
    """Plain version of B1: ``(finals [B, K], skipped [B])``."""
    b, c, _ = chunks.shape
    k = sinks.shape[0]
    lv, skipped = _scan_blocks(table, chunks, init_states, absorbing,
                               l_blk=l_blk, early_exit=early_exit)
    finals = ref.spec_merge_ref(lv.reshape(b, c, k, -1), lookahead,
                                cand_index, sinks, pad_cls=pad_key)
    return finals, skipped


def spec_match_merge_lanes_torch(table, chunks, init_states, lookahead,
                                 cand_index, sinks, absorbing, *,
                                 pad_key: int, l_blk: int,
                                 early_exit: bool = True):
    """Plain version of B2: ``(lanes [B, K*S], skipped [B])``."""
    b, c, _ = chunks.shape
    k = sinks.shape[0]
    lv, skipped = _scan_blocks(table, chunks, init_states, absorbing,
                               l_blk=l_blk, early_exit=early_exit)
    lanes = ref.spec_merge_lanes_ref(lv.reshape(b, c, k, -1), lookahead,
                                     cand_index, sinks, pad_cls=pad_key)
    return lanes.reshape(b, -1), skipped
