"""Launch wrappers of the speculative match kernels (B1, B2, B6).

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

``spec_match_cuda`` launches the plain chunk x lane scan of the same source
(B6, replacing ``repro/kernels/dfa_match.py::spec_match_kernel``): table
[Q, n_cls], chunks [C, L], init [C, S] -> final states [C, S], no fold.
It is the matcher of the paper engine (``core/engine/baselines.py``), and
with one chunk and one lane its sequential matcher.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["spec_match_merge_cuda", "spec_match_merge_lanes_cuda",
           "spec_match_merge_torch", "spec_match_merge_lanes_torch",
           "spec_match_cuda", "spec_match_torch", "launches",
           "reset_launches", "smem_plan", "spec_plan", "spec_table_in_smem"]

# kernel launches per wrapper; incremented only where the kernel launches
launches = {"spec_match_merge": 0, "spec_match_merge_lanes": 0,
            "spec_match": 0}

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


SPEC_CTA_LANES = 4096    # most lanes one B6 CTA holds (shared-memory carry)
SPEC_CTAS = 264          # B6 aims at two CTAs per SM of the H100's 132
SPEC_MAX_CHUNKS = 64     # most chunks one B6 CTA stages symbols for


def spec_plan(c: int, s: int) -> tuple[int, int]:
    """(chunks, lanes per chunk) of one B6 CTA for C chunks x S lanes.

    Spreads the C*S lanes over about ``SPEC_CTAS`` CTAs of 32 to 4096
    lanes: narrow speculation groups several chunks into one CTA, wide
    speculation (up to 22,857 lanes in a PROSITE search DFA) splits a
    chunk's lanes over several CTAs.
    """
    target = min(SPEC_CTA_LANES, max(32, -(-c * s // SPEC_CTAS)))
    if s <= target:
        return max(1, min(c, SPEC_MAX_CHUNKS, target // s)), s
    parts = -(-s // target)
    return 1, -(-s // parts)


def spec_table_in_smem(q: int, n_cls: int, c: int, s: int,
                       table_in_smem: bool | None = None) -> bool:
    """Whether B6 stages the [Q, n_cls] table in shared memory beside one
    CTA's symbol tiles and lane carry (``spec_plan``); ``table_in_smem``
    forces a placement and raises if a shared one cannot fit."""
    c_blk, s_blk = spec_plan(c, s)
    fits = 4 * (c_blk * SYM_TILE + c_blk * s_blk + q * n_cls) <= SMEM_BUDGET
    if table_in_smem is None:
        return fits
    if table_in_smem and not fits:
        raise ValueError(f"a {4 * q * n_cls}-byte table does not fit in "
                         "shared memory")
    return bool(table_in_smem)


def spec_match_cuda(table, chunks, init_states, *,
                    table_in_smem: bool | None = None):
    """B6 on the card: C chunks x S lanes -> final states [C, S]; never
    synchronises.  table [Q, n_cls], chunks [C, L] class ids < n_cls, init
    [C, S] states < Q, all contiguous int32 on one CUDA device.  The table
    goes to shared memory when it fits beside the symbol tiles and the lane
    carry; ``table_in_smem`` forces a placement."""
    dev = chunks.device
    for t in (table, chunks, init_states):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("spec_match_cuda needs every operand on one "
                             f"CUDA device, got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("operands must be contiguous int32 tensors")
    q, n_cls = table.shape
    c, l = chunks.shape
    s = init_states.shape[1]
    if init_states.shape[0] != c:
        raise ValueError("chunks and init_states disagree on C")
    c_blk, s_blk = spec_plan(c, s)
    table_in_smem = spec_table_in_smem(q, n_cls, c, s, table_in_smem)
    out = torch.empty((c, s), dtype=torch.int32, device=dev)
    if c == 0 or s == 0:
        return out
    fn = _build.load("dfa_match").spec_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), chunks.data_ptr(), init_states.data_ptr(),
                 out.data_ptr(), c, l, q, n_cls, s, c_blk, s_blk,
                 int(bool(table_in_smem)), stream)
    if err:
        raise RuntimeError(f"spec_match kernel launch failed: CUDA error {err}")
    launches["spec_match"] += 1
    return out


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


def spec_match_torch(table, chunks, init_states):
    """Plain version of B6: one gather per symbol over every lane ->
    [C, S]."""
    return ref.spec_match_ref(table, chunks, init_states)
