"""Launch wrappers of the speculative match kernels (B1, B2, B6).

``spec_match_merge_cuda`` and ``spec_match_merge_lanes_cuda`` launch the
Hopper kernel of ``csrc/dfa_match.cu`` on a thread-block cluster per
document (``merge_plan``: the document's chunks split over up to 8 CTAs,
lanes in registers, a cluster-wide block-granular all-absorbed early exit,
the Eq. 8 fold over the cluster's distributed shared memory).  They replace
the Pallas kernels ``repro/kernels/dfa_match.py::spec_match_merge_kernel``
and ``spec_match_merge_lanes_kernel``.  Each has its plain PyTorch version
beside it (``*_torch``), with the same block-granular ``skipped`` count, and
a launch counter in ``launches`` that only a kernel launch increments.

Operands (all int32, contiguous, on one CUDA device): table [Q, n_cls_pad]
with the identity pad column, chunks [B, C, L] (L a multiple of ``l_blk``),
init [B, C, K*S], lookahead [B, C] boundary keys, cand_index
[n_keys + 1, Q], sinks [K], absorbing [Q] 0/1.  ``pad_key`` is the boundary
key the fold passes through (the pad class under r=1, ``n_classes ** 2``
under r=2).

``spec_match_cuda`` launches the plain chunk x lane scan of the same
template (B6, replacing ``repro/kernels/dfa_match.py::spec_match_kernel``):
table [Q, n_cls], chunks [C, L], init [C, S] -> final states [C, S], no
fold.  It is the matcher of the paper engine (``core/engine/baselines.py``),
and with one chunk and one lane its sequential matcher.

The plans below mirror the kernel's launch arithmetic (``csrc/dfa_match.cu``
``layout``/``row_words``), so the CPU tests hold them to the card's limits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["spec_match_merge_cuda", "spec_match_merge_lanes_cuda",
           "spec_match_merge_torch", "spec_match_merge_lanes_torch",
           "spec_match_cuda", "spec_match_torch", "launches",
           "reset_launches", "smem_plan", "merge_plan", "spec_launch_plan"]

# kernel launches per wrapper; incremented only where the kernel launches
launches = {"spec_match_merge": 0, "spec_match_merge_lanes": 0,
            "spec_match": 0}

SMS = 132               # streaming multiprocessors of the H100
SMEM_BUDGET = 232_448   # dynamic shared memory one block may use (H100)
# these equal csrc/spec_scan.cuh's constants
STAGES = 4              # symbol tiles in the ring
GROUP = 32              # symbols per unrolled step group
MAX_CONSUMERS = 992     # consumer threads of a CTA (+ one producer warp)
LPT = 4                 # lanes one consumer thread carries
MAX_CLUSTER = 8         # portable thread-block cluster size
TILE_MAX = 4096         # most symbols of one ring tile
RING_BYTES = 64 * 1024  # the ring's target size
RING_BYTES_GLOBAL = 16 * 1024  # ... beside a table in global memory, whose
                               # reads the rest of the SM's L1 caches


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def row_words(tile: int) -> int:
    """Ring row stride (int32 words) of a ``tile``-symbol tile: whole
    16-byte units, an odd count of them (bank-spread rows)."""
    w = -(-tile // 4) + 1
    return 4 * (w + (w % 2 == 0))


def smem_bytes(rows: int, tile: int, q: int, n_cls: int, *, table: bool,
               absorbing: bool = False, carry_lanes: int = 0) -> int:
    """Shared memory of one CTA (``layout`` in csrc/dfa_match.cu): the ring,
    the class-major table, the absorbing bitmap, the lane carry, the
    barriers and the vote words."""
    n = 4 * STAGES * rows * row_words(tile)
    if table:
        n += 4 * (q | 1) * n_cls
    if absorbing:
        n += 4 * -(-q // 32)
    n += 4 * carry_lanes
    return -(-n // 8) * 8 + (2 * STAGES + 2) * 8 + 16 * 4


def _cluster_rows(c: int, cluster: int) -> int:
    return -(-c // cluster)


def smem_plan(q: int, n_cls_pad: int, c: int, n_lanes: int,
              table_in_smem: bool | None = None,
              carry_in_smem: bool | None = None, *,
              cluster: int = 1) -> tuple[bool, bool]:
    """(table in shared memory, lane carry in shared memory) for one B1/B2
    CTA of a ``cluster``-CTA document of C chunks and ``n_lanes`` lanes.

    The table goes to shared memory first (every symbol step reads it), the
    CTA's share of the final lanes (which the fold reads) next, beside the
    ring at its smallest tile and the absorbing bitmap; what does not fit
    is read from global memory.  ``table_in_smem`` and ``carry_in_smem``
    force a placement and raise if a forced shared placement cannot fit.
    """
    rows = _cluster_rows(c, cluster)
    base = smem_bytes(rows, GROUP, q, n_cls_pad, table=False, absorbing=True)
    tbl = 4 * (q | 1) * n_cls_pad
    if table_in_smem is None:
        table_in_smem = base + tbl <= SMEM_BUDGET
    elif table_in_smem and base + tbl > SMEM_BUDGET:
        raise ValueError(f"a {tbl}-byte table does not fit in shared memory")
    carry = 4 * rows * (n_lanes // max(c, 1))
    fits = base + (tbl if table_in_smem else 0) + carry <= SMEM_BUDGET
    if carry_in_smem is None:
        carry_in_smem = fits
    elif carry_in_smem and not fits:
        raise ValueError(f"a {n_lanes}-lane carry does not fit in shared "
                         "memory")
    return bool(table_in_smem), bool(carry_in_smem)


def _ring_tile(rows: int, room: int, *, table_in_smem: bool,
               limit: int = TILE_MAX, divides: int | None = None) -> int:
    """Symbols per ring tile: the most that fit ``room`` bytes (and the
    ring's target size), a multiple of GROUP, or the largest divisor of
    ``divides`` that fits."""
    room = min(room, RING_BYTES if table_in_smem else RING_BYTES_GLOBAL)
    if divides is None:
        t = max(GROUP, min(limit, TILE_MAX) // GROUP * GROUP)
        while t > GROUP and 4 * STAGES * rows * row_words(t) > room:
            t -= GROUP
        return t
    for t in range(min(divides, TILE_MAX), 0, -1):
        if divides % t == 0 and (4 * STAGES * rows * row_words(t) <= room
                                 or t == 1):
            return t
    return 1


def merge_plan(b: int, c: int, ks: int, q: int, n_cls_pad: int, l: int,
               l_blk: int, *, early_exit: bool = True,
               table_in_smem: bool | None = None,
               carry_in_smem: bool | None = None,
               aligned: bool = True) -> dict:
    """The cluster launch of B1/B2 for B documents of C chunks x ``ks``
    (= K*S) lanes.

    A document's chunks are split over a cluster of ``cluster`` CTAs (a
    power of two <= 8 and <= C): first as large as the lanes need to fit
    one CTA's threads, then larger while the batch keeps within two CTAs
    per SM.  Each consumer thread carries ``LPT`` lanes of one chunk; a
    CTA whose lanes still exceed ``MAX_CONSUMERS * LPT`` runs them in
    ``passes``.  ``tile`` divides ``l_blk`` (symbol blocks are whole
    tiles); ``bulk`` when every ring row is a 16-byte aligned bulk copy.
    """
    tpc = -(-ks // LPT)
    top = 1
    while top * 2 <= min(MAX_CLUSTER, c):
        top *= 2
    cluster = 1
    while cluster < top and _cluster_rows(c, cluster) * tpc > MAX_CONSUMERS:
        cluster *= 2
    while cluster < top and b * cluster * 2 <= 2 * SMS:
        cluster *= 2
    rows = _cluster_rows(c, cluster)
    slots = rows * tpc
    passes = -(-slots // MAX_CONSUMERS)
    per_pass = -(-slots // passes)
    cons = -(-per_pass // 32) * 32
    table, carry = smem_plan(q, n_cls_pad, c, c * ks, table_in_smem,
                             carry_in_smem, cluster=cluster)
    fixed = smem_bytes(0, 0, q, n_cls_pad, table=table,
                       absorbing=early_exit,
                       carry_lanes=rows * ks if carry else 0)
    tile = _ring_tile(rows, SMEM_BUDGET - fixed, table_in_smem=table,
                      divides=l_blk)
    smem = smem_bytes(rows, tile, q, n_cls_pad, table=table,
                      absorbing=early_exit,
                      carry_lanes=rows * ks if carry else 0)
    return dict(cluster=cluster, rows=rows, tpc=tpc, cons=cons,
                threads=cons + 32, passes=passes, tile=tile,
                bulk=bool(aligned and l % 4 == 0 and tile % 4 == 0),
                table_in_smem=table, carry_in_smem=carry, smem=smem,
                ctas=b * cluster)


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 17
             + [ctypes.c_void_p])


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
    plan = merge_plan(b, c, n_lanes, q, n_cls_pad, l, l_blk,
                      early_exit=early_exit, table_in_smem=table_in_smem,
                      carry_in_smem=carry_in_smem,
                      aligned=chunks.data_ptr() % 16 == 0)
    out = torch.empty((b, n_lanes if lanes else k), dtype=torch.int32,
                      device=dev)
    skipped = torch.empty(b, dtype=torch.int32, device=dev)
    scratch = (None if plan["carry_in_smem"] else
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
            int(bool(early_exit)), int(plan["table_in_smem"]),
            int(plan["carry_in_smem"]), plan["cluster"], plan["cons"],
            plan["passes"], plan["tile"], int(plan["bulk"]), stream)
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


def spec_launch_plan(c: int, s: int, l: int, q: int, n_cls: int,
                     table_in_smem: bool | None = None, *,
                     aligned: bool = True) -> dict:
    """The B6 launch for C chunks x S lanes of L symbols through a [Q,
    n_cls] table: CTAs of ``c_blk`` chunks x ``s_blk`` lanes, consumer
    threads, grid, ring tile, bulk copies, table placement and shared
    memory.

    Whole chunks where a chunk's lanes fit one CTA's consumer threads
    (``LPT`` lanes each): as many per CTA as put the C chunks on the 132
    SMs in whole waves of one CTA each; with fewer chunks than SMs a
    chunk's lanes are split over CTAs to reach more SMs.  Wider
    speculation (up to 22,857 lanes in a PROSITE search DFA) splits a
    chunk's lanes into as many CTAs as fill whole waves.  The table goes
    to shared memory when it fits beside the ring at its smallest tile;
    ``table_in_smem`` forces a placement and raises if a shared one cannot
    fit.
    """
    tpc = -(-s // LPT)
    if tpc > MAX_CONSUMERS:
        parts = -(-tpc // MAX_CONSUMERS)
        parts = max(parts, SMS * -(-c * parts // SMS) // c)
        c_blk, s_blk = 1, -(-s // parts)
    else:
        per_sm = -(-c // SMS)
        waves = -(-per_sm * tpc // MAX_CONSUMERS)
        c_blk = min(-(-c // (SMS * waves)), MAX_CONSUMERS // tpc)
        s_blk = s
        if c_blk == 1 and c < SMS:
            s_blk = -(-s // max(1, min(SMS // c, s // 64)))
    fits = smem_bytes(c_blk, GROUP, q, n_cls, table=True) <= SMEM_BUDGET
    if table_in_smem and not fits:
        raise ValueError(f"a {4 * q * n_cls}-byte table does not fit in "
                         "shared memory")
    table = fits if table_in_smem is None else bool(table_in_smem)
    tpc = -(-s_blk // LPT)
    cons = -(-(c_blk * tpc) // 32) * 32
    fixed = smem_bytes(0, 0, q, n_cls, table=table)
    tile = _ring_tile(c_blk, SMEM_BUDGET - fixed, table_in_smem=table,
                      limit=-(-max(l, 1) // GROUP) * GROUP)
    return dict(c_blk=c_blk, s_blk=s_blk, tpc=tpc, cons=cons,
                threads=cons + 32, grid=(-(-c // c_blk), -(-s // s_blk)),
                tile=tile, bulk=bool(aligned and l % 4 == 0),
                table_in_smem=table,
                smem=smem_bytes(c_blk, tile, q, n_cls, table=table))


def spec_match_cuda(table, chunks, init_states, *,
                    table_in_smem: bool | None = None):
    """B6 on the card: C chunks x S lanes -> final states [C, S]; never
    synchronises.  table [Q, n_cls], chunks [C, L] class ids < n_cls, init
    [C, S] states < Q, all contiguous int32 on one CUDA device.  The table
    goes to shared memory when it fits beside the symbol ring;
    ``table_in_smem`` forces a placement."""
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
    out = torch.empty((c, s), dtype=torch.int32, device=dev)
    if c == 0 or s == 0:
        return out
    plan = spec_launch_plan(c, s, l, q, n_cls, table_in_smem,
                            aligned=chunks.data_ptr() % 16 == 0)
    fn = _build.load("dfa_match").spec_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), chunks.data_ptr(), init_states.data_ptr(),
                 out.data_ptr(), c, l, q, n_cls, s, plan["c_blk"],
                 plan["s_blk"], int(plan["table_in_smem"]), plan["cons"],
                 plan["tile"], int(plan["bulk"]), stream)
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
