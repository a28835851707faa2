"""Launch wrappers of the L-vector compose kernels (B3, B4, B7).

``spec_compose_lanes_cuda`` (B3, the sequential carry fold) and
``spec_compose_lanes_tree_cuda`` (B4, the pairwise tree reduce) launch the
Hopper kernels of ``csrc/lvec_compose.cu``.  They replace the Pallas kernels
``repro/kernels/lvec_compose.py::spec_compose_lanes_kernel`` and
``spec_compose_lanes_tree_kernel``: the out-of-order gap-close fold of
``Matcher.compose_lane_maps``.  B3 streams each element's key row of
``cand_index`` and its lane map through a shared-memory ring that a producer
warp fills, several runs a CTA (``carry_plan``; elements that do not fit
the ring take a wide instance that reads them from global memory).  B4
stages each run's maps and each distinct key's row in shared memory and
runs the levels of several runs a CTA on their own named barriers; a batch
of few long runs splits each run into aligned segments on a thread-block
cluster, folded in the tree's pairing (``tree_plan``).
Each has its plain PyTorch version beside it (``*_torch``) and a launch
counter in ``launches`` that only a kernel launch increments.

Operands (all int32, contiguous, on one CUDA device): lanes [B, N, K, S]
keyed lane-map runs, keys [B, N] boundary keys (element 0's never read;
``pad_key`` elements are identities), cand_index [n_keys + 1, Q] with the
all -1 pad row, sinks [K].  Both return the composition [B, K, S].  The
carry fold is the sequential oracle's order, so it equals
``ref.spec_compose_lanes_ref`` on every lane; the tree pairs elements as the
Pallas tree does and may differ from the oracle on pad lanes only.

``lvec_compose_cuda`` (B7, replacing ``lvec_compose_kernel``) composes full
[Q] maps left to right, batched over a leading axis: maps [B, N, Q] ->
[B, Q].  The paper engine's basic and holub modes compose every chunk's
one-hot block maps with it.  ``lvec_plan`` splits each composition into
segments on a thread-block cluster (and a second launch past a cluster) so
that a batch of few long compositions fills the card; maps too large for
its shared-memory ring take a wide instance that reads them from global
memory.

The plans mirror the kernels' launch arithmetic, so the CPU tests hold them
to the card's limits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import compose_lanes_torch, lvec_compose_ref

__all__ = ["spec_compose_lanes_cuda", "spec_compose_lanes_tree_cuda",
           "spec_compose_lanes_torch", "spec_compose_lanes_tree_torch",
           "lvec_compose_cuda", "lvec_compose_torch", "launches",
           "reset_launches", "tree_plan", "lvec_plan", "carry_plan"]

# kernel launches per wrapper; incremented only where a kernel launches
launches = {"spec_compose_lanes": 0, "spec_compose_lanes_tree": 0,
            "lvec_compose": 0}

SMS = 132               # streaming multiprocessors of the H100
SMEM_BUDGET = 232_448   # dynamic shared memory one block may use (H100)
# these equal csrc/lvec_compose.cu's constants
STAGES = 4              # tiles in each ring
MAX_CONSUMERS = 992     # consumer threads of a CTA (+ one producer warp)
MAX_CLUSTER = 8         # portable thread-block cluster size
QPT = 16                # most states a B7 thread carries
LPT = 4                 # lanes a B4 thread carries (a B3 one: in a large
                        # batch)
PAIRS = 32              # most (run, element) pairs of a B3 tile
WIDE_THREADS = 256      # threads of a CTA of the instances for operands
                        # that do not fit the rings
WPT = 4                 # lanes (B3) or states (B7) a thread of those carries
BARRIERS = 2 * STAGES * 8   # the full and empty mbarriers of a ring
# planning targets
MIN_SEGMENT = 16        # fewest maps a B7 segment takes: its ring's loads
                        # overlap its walk
MAP_STAGE_BYTES = 8 * 1024   # a B7 ring tile's target size
PACK_THREADS = 128      # consumer threads of a B7 CTA of small maps
CARRY_RING_BYTES = 112 * 1024   # a B3 ring's target size: two CTAs an SM
MAX_RUNS = 4            # most runs of one B3 CTA
TREE_SMEM_BYTES = 112 * 1024   # a B4 CTA's target: two CTAs an SM
TREE_THREADS = 224      # consumer threads a B4 CTA takes at most for its
                        # pair groups: at 58 registers a thread (64 once
                        # rounded), threads bound how many CTAs an SM holds
TREE_RUNS = 2           # runs a B4 CTA takes where a large batch has short
                        # runs (they share the CTA's staged rows)
MIN_TREE_SEGMENT = 16   # fewest elements a segment of a split B4 run takes;
                        # runs this short are the ones a CTA shares


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def slot_words(words: int) -> int:
    """Words of a ring slot for ``words`` int32 (``slot_words`` in
    csrc/lvec_compose.cu): room for the aligned 16-byte units that hold
    them wherever they start."""
    return (words + 6) & ~3


def lvec_smem(pack: int, tile: int, q: int, cluster: int) -> int:
    """Shared memory of one B7 CTA (``lvec_bars`` in csrc/lvec_compose.cu):
    the ring [STAGES, pack, slot of tile * Q], the partials [pack, Q] of a
    cluster, the barriers."""
    part = 4 * pack * q if cluster > 1 else 0
    return _up(4 * STAGES * pack * slot_words(tile * q) + part, 8) + BARRIERS


def _lvec_tile(pack: int, n: int, q: int, cluster: int) -> int:
    """Maps per composition in a ring tile: up to ``MAP_STAGE_BYTES`` a
    tile, no more than the segment's ``n``, within the budget."""
    tile = max(1, min(n, MAP_STAGE_BYTES // (4 * pack * q)))
    while tile > 1 and lvec_smem(pack, tile, q, cluster) > SMEM_BUDGET:
        tile -= 1
    if lvec_smem(pack, tile, q, cluster) > SMEM_BUDGET:
        raise ValueError(f"{STAGES} maps of {q} states do not fit the "
                         "compose ring in shared memory")
    return tile


def _lvec_segments(groups: int, n: int) -> int:
    """Segments per composition: as many as put ``groups`` CTA groups on
    the 132 SMs, no segment under ``MIN_SEGMENT`` maps, a multiple of 8
    past one cluster."""
    g = 1
    if groups < SMS:
        g = max(1, min(-(-SMS // groups), n // MIN_SEGMENT))
    return g - g % MAX_CLUSTER if g > MAX_CLUSTER else g


def _wide_blocks(width: int) -> int:
    """CTAs along the lanes or states of one run or composition of a wide
    instance (``wide_blocks`` in csrc/lvec_compose.cu)."""
    return -(-width // (WIDE_THREADS * WPT))


def lvec_plan(b: int, n: int, q: int) -> dict:
    """The B7 launch for B compositions of N maps of Q states.

    One consumer thread per state (``nq`` <= QPT states a thread past
    ``MAX_CONSUMERS`` states).  Maps of fewer than 64 states pack ``pack``
    compositions into one CTA (up to ``PACK_THREADS`` consumer threads):
    the most that still leave 0.9 of a wave of CTAs.  Each composition is
    split into ``segments`` (G) CTAs (``_lvec_segments``; 1 where the
    partials would not fit beside the ring).  G <= 8 CTAs fold their
    partials within one cluster; a larger G (a multiple of 8) folds in
    clusters of 8 and a second launch composes the ``folds`` = G / 8
    cluster partials.  A map that does not fit the ring (four slots of one
    map past shared memory, or more than QPT states a thread) takes the
    ``wide`` instance: maps read from global memory, ``WPT`` states a
    thread over several CTAs a segment, no clusters (``folds`` = G)."""
    return _lvec_plan(b, n, q, None)


@functools.lru_cache(maxsize=256)
def _lvec_plan(b: int, n: int, q: int, segments: int | None) -> dict:
    """``lvec_plan`` with G forced to ``segments`` where it is not None
    (1..8 or a multiple of 8 on the ring instance, any G >= 1 on the wide
    one): the card tests reach splits the plan itself never makes."""
    nq = -(-q // MAX_CONSUMERS)
    if nq > QPT or lvec_smem(1, 1, q, 1) > SMEM_BUDGET:
        blocks = _wide_blocks(q)
        g = segments
        if g is None:
            g = 1 if b * blocks >= SMS else max(
                1, min(-(-SMS // (b * blocks)), n // MIN_SEGMENT))
        if g < 1:
            raise ValueError(f"segments={g}: at least 1")
        return dict(wide=True, segments=g, cluster=1, folds=g, pack=1,
                    tpu=WIDE_THREADS, nq=WPT, cons=WIDE_THREADS, tile=1,
                    fold_tile=1, smem=0, ctas=b * g * blocks)
    if q < 64:
        tpu, nq = 1 << max(0, q - 1).bit_length(), 1
        top = max(1, min(PACK_THREADS // tpu, b))
        pack = next((p for p in range(top, 1, -1)
                     if -(-b // p) * _lvec_segments(-(-b // p), n)
                     >= 0.9 * SMS), 1)
    else:
        tpu, pack = _up(-(-q // nq), 32), 1
    groups = -(-b // pack)
    if segments is None:
        g = _lvec_segments(groups, n)
        if lvec_smem(pack, 1, q, min(g, MAX_CLUSTER)) > SMEM_BUDGET:
            g = 1
    else:
        g = int(segments)
        if g < 1 or (g > MAX_CLUSTER and g % MAX_CLUSTER):
            raise ValueError(f"segments={g}: 1..{MAX_CLUSTER} or a multiple "
                             f"of {MAX_CLUSTER}")
    cluster = min(g, MAX_CLUSTER)
    folds = g // cluster
    tile = _lvec_tile(pack, -(-n // g), q, cluster)
    cons = max(32, _up(pack * tpu, 32))
    return dict(wide=False, segments=g, cluster=cluster, folds=folds,
                pack=pack, tpu=tpu, nq=nq, cons=cons, tile=tile,
                fold_tile=_lvec_tile(pack, folds, q, 1),
                smem=lvec_smem(pack, tile, q, cluster), ctas=groups * g)


def carry_stage_bytes(runs: int, tile: int, q: int, ks: int) -> int:
    """One B3 ring tile (``CarryLayout`` in csrc/lvec_compose.cu): the
    header [3, PAIRS] (keys, row addresses, map offsets), the key rows
    [runs * tile, slot of Q], the maps [runs, slot of tile * K*S]."""
    return 4 * (3 * PAIRS + runs * tile * slot_words(q)
                + runs * slot_words(tile * ks))


def carry_smem(runs: int, tile: int, q: int, ks: int) -> int:
    """Shared memory of one B3 CTA: the ring, the row of -1s a pad_key
    element reads, the barriers."""
    return (STAGES * carry_stage_bytes(runs, tile, q, ks)
            + 4 * slot_words(q) + BARRIERS)


@functools.lru_cache(maxsize=256)
def carry_plan(b: int, n: int, q: int, k: int, s: int) -> dict:
    """The B3 launch for B runs of N elements of K*S lanes, keyed rows of Q.

    A consumer thread carries ``lpt`` lanes of one run (``tpr`` threads a
    run): one lane where the batch leaves SMs to spare (fewer than two runs
    an SM: more warps walk each run's chain), LPT in a larger batch, where
    ``runs`` runs share a CTA while the batch still fills the 132 SMs at
    two CTAs an SM.  A ring tile holds ``tile`` elements of every run (a
    multiple of 4 where it can: whole 16-byte map spans), ``runs * tile <=
    PAIRS``, the ring within ``CARRY_RING_BYTES`` (two CTAs an SM) where
    the CTAs outnumber the SMs.  Where an element does not fit the ring (a
    key row and a lane map past four slots of shared memory) or a run has
    more lanes than one CTA carries, the ``wide`` instance: rows and maps
    read from global memory, ``WPT`` lanes a thread, the lanes of a run
    over ``ctas / B`` CTAs of ``WIDE_THREADS``."""
    ks = k * s
    lpt = 1 if b < 2 * SMS and ks <= MAX_CONSUMERS else LPT
    tpr = -(-ks // lpt)
    runs = max(1, min(MAX_CONSUMERS // tpr, b // SMS, MAX_RUNS))
    top = min(PAIRS // runs, _up(max(n, 1), 4))
    fits = [t for t in range(top, 0, -1)
            if carry_smem(runs, t, q, ks) <= SMEM_BUDGET]
    if tpr > MAX_CONSUMERS or not fits:
        return dict(wide=True, runs=1, tile=1, lpt=WPT,
                    tpr=_wide_blocks(ks) * WIDE_THREADS, cons=WIDE_THREADS,
                    smem=0, ctas=b * _wide_blocks(ks))
    # two CTAs an SM where the batch fills the card; one (the whole budget,
    # longer tiles over which the producer spreads its per-tile work) where
    # it does not
    cap = CARRY_RING_BYTES if -(-b // runs) > SMS else SMEM_BUDGET
    near = [t for t in fits
            if STAGES * carry_stage_bytes(runs, t, q, ks) <= cap]
    tile = (near or fits[-1:])[0]
    if tile >= 4:
        tile -= tile % 4
    cons = _up(runs * tpr, 32)
    return dict(wide=False, runs=runs, tile=tile, lpt=lpt, tpr=tpr,
                cons=cons, smem=carry_smem(runs, tile, q, ks),
                ctas=-(-b // runs))


def tree_threads(ks: int, hp: int) -> int:
    """Threads of one B4 unit (``tree_threads`` in csrc/lvec_compose.cu):
    LPT lanes a thread, ``hp`` pair groups, whole warps."""
    return _up(-(-ks // LPT) * hp, 32)


def tree_smem(runs: int, seg: int, cluster: int, q: int, ks: int,
              slots: int, hsize: int) -> int:
    """Shared memory of one B4 CTA (``TreeLayout`` in csrc/lvec_compose.cu):
    each unit's maps [runs, slot of width * K*S] (width = max(seg,
    cluster)), the key rows [slots, slot of Q], the element entries [runs,
    width], the key hash [2, hsize], a copy barrier for each unit."""
    width = max(seg, cluster)
    return _up(4 * (runs * slot_words(width * ks) + slots * slot_words(q)
                    + runs * width + 2 * hsize), 8) + 8 * runs


def _hash_size(runs: int, width: int) -> int:
    """Entries of a B4 CTA's key hash: a power of two, at least twice the
    keys it can hold."""
    return max(32, 1 << (2 * runs * width - 1).bit_length())


def tree_plan(b: int, n: int, q: int, k: int, s: int) -> dict:
    """The B4 launch for B runs of N (a power of two) elements of K*S
    lanes, keyed rows of Q.

    A unit — a run, or one of its ``segments`` (G) aligned segments of
    ``seg`` = N / G elements — sits in shared memory with the rows of its
    keys.  A thread carries LPT lanes over ``hp`` pair groups of one unit
    (``threads`` a unit, up to TREE_THREADS a CTA: at this kernel's
    registers, threads bound how many CTAs, and so how many runs' copies,
    an SM holds).  Where a batch of runs of <= MIN_TREE_SEGMENT elements
    gives each SM two runs or more, ``runs`` = TREE_RUNS runs share a CTA
    and its staged rows, if their maps and a row slot for every key fit
    TREE_SMEM_BYTES.  A batch that does not fill the SMs twice over splits
    each run into G segments of >= MIN_TREE_SEGMENT elements, and so does
    a run that does not fit shared memory.  G <= 8 segments fold within
    one cluster (``cluster`` = min(G, 8)); a larger G leaves ``folds`` =
    G / 8 cluster partials a run to a second launch (``fold``, its own
    plan of one segment).  The
    CTA stages up to ``slots`` distinct keys' rows (the rest read from
    global memory) in a hash of ``hsize`` keys.  A unit of two elements
    that does not fit, or more lanes than a CTA's threads carry, takes the
    ``wide`` instance: one CTA a run, the levels in global memory."""
    return _tree_plan(b, n, q, k, s, None)


@functools.lru_cache(maxsize=256)
def _tree_plan(b: int, n: int, q: int, k: int, s: int,
               segments: int | None, wide: bool = False) -> dict:
    """``tree_plan`` with G forced to ``segments`` where it is not None (a
    power of two dividing N) and the wide instance forced by ``wide``: the
    card tests reach placements the plan itself never makes."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"the tree compose needs N a power of two, got {n}")
    ks = k * s

    def smem(runs, seg, cl, slots=0):
        width = max(seg, cl)
        return tree_smem(runs, seg, cl, q, ks, slots, _hash_size(runs, width))

    g = 1 if segments is None else int(segments)
    if g < 1 or g & (g - 1) or n % g:
        raise ValueError(f"segments={g}: a power of two dividing N={n}")
    if segments is None:
        while g < n and smem(1, n // g, min(g, MAX_CLUSTER)) > SMEM_BUDGET:
            g *= 2
        while b * g < 2 * SMS and n // (2 * g) >= MIN_TREE_SEGMENT:
            g *= 2
    cl = min(g, MAX_CLUSTER)
    seg, folds = n // g, g // cl
    fold = _tree_plan(b, folds, q, k, s, 1) if folds > 1 else None
    if (wide or tree_threads(ks, 1) > MAX_CONSUMERS
            or smem(1, seg, cl) > SMEM_BUDGET or (fold and fold["wide"])):
        return dict(wide=True, segments=1, seg=n, cluster=1, folds=1, runs=1,
                    hp=1, threads=_up(min(max(1, n // 2) * ks, 1024), 32),
                    slots=0, hsize=0, smem=0, ctas=b, fold=None)
    runs = 1
    if (g == 1 and n <= MIN_TREE_SEGMENT and b >= TREE_RUNS * SMS
            and TREE_RUNS * tree_threads(ks, 1) <= TREE_THREADS
            and smem(TREE_RUNS, n, 1, TREE_RUNS * (n - 1))
            <= TREE_SMEM_BYTES):
        runs = TREE_RUNS
    width = max(seg, cl)
    hp = next((h for h in range(max(1, width // 2), 1, -1)
               if runs * tree_threads(ks, h) <= TREE_THREADS), 1)
    bare = smem(runs, seg, cl)
    cap = TREE_SMEM_BYTES if bare <= TREE_SMEM_BYTES else SMEM_BUDGET
    slots = max(0, min(runs * (seg - 1), (cap - bare) // (4 * slot_words(q))))
    return dict(wide=False, segments=g, seg=seg, cluster=cl, folds=folds,
                runs=runs, hp=hp, threads=tree_threads(ks, hp), slots=slots,
                hsize=_hash_size(runs, width), smem=smem(runs, seg, cl, slots),
                ctas=b * g if g > 1 else -(-b // runs), fold=fold)


_fns: dict[str, object] = {}


def _entry(name: str, n_ptrs: int, n_ints: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("lvec_compose"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(lanes, keys, cand_index, sinks):
    dev = lanes.device
    for t in (lanes, keys, cand_index, sinks):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("the compose kernels need every operand on one "
                             f"CUDA device, got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("operands must be contiguous int32 tensors")
    if lanes.dim() != 4:
        raise ValueError(f"lanes must be [B, N, K, S], got {tuple(lanes.shape)}")
    b, n, k, s = lanes.shape
    if (keys.shape != (b, n) or sinks.shape != (k,) or cand_index.dim() != 2
            or n < 1):
        raise ValueError("operand shapes disagree")
    return dev, b, n, k, s


def _launch(name, dev, args, ints, kernels=1):
    """One call of ``<name>_launch`` on ``dev``'s current stream (entering
    ``dev`` only when it is not the current device); it launches
    ``kernels`` kernels."""
    fn = _entry(f"{name}_launch", len(args), len(ints))
    ptrs = [None if t is None else t.data_ptr() for t in args]
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    # the raw handle of torch.cuda.current_stream(index).cuda_stream, without
    # building a Stream object on every call
    if index == current:
        err = fn(*ptrs, *ints, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, *ints, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += kernels


def spec_compose_lanes_cuda(lanes, keys, cand_index, sinks, *,
                            pad_key: int):
    """B3 on the card: the carry fold of each run -> [B, K, S]; never
    synchronises."""
    dev, b, n, k, s = _check(lanes, keys, cand_index, sinks)
    out = torch.empty((b, k, s), dtype=torch.int32, device=dev)
    if b:
        rows, q = cand_index.shape
        plan = carry_plan(b, n, q, k, s)
        _launch("spec_compose_lanes", dev,
                (lanes, keys, cand_index, sinks, out),
                (b, n, q, k, s, int(pad_key), rows, plan["runs"],
                 plan["tile"], plan["cons"], plan["lpt"], plan["wide"]))
    return out


def spec_compose_lanes_tree_cuda(lanes, keys, cand_index, sinks, *,
                                 pad_key: int):
    """B4 on the card: the pairwise tree reduce of each run (N a power of
    two) -> [B, K, S]; ``tree_plan`` picks the launch (two launches where a
    run splits past one cluster).  Never synchronises."""
    dev, b, n, k, s = _check(lanes, keys, cand_index, sinks)
    if n & (n - 1):
        raise ValueError(f"the tree compose needs N a power of two, got {n}")
    return _tree_launch(lanes, keys, cand_index, sinks, pad_key,
                        tree_plan(b, n, cand_index.shape[1], k, s) if b
                        else None)


def _tree_launch(lanes, keys, cand_index, sinks, pad_key, plan):
    """B4 on operands ``_check`` accepted, as ``plan`` (a ``tree_plan``
    dict) says."""
    b, n, k, s = lanes.shape
    out = torch.empty((b, k, s), dtype=torch.int32, device=lanes.device)
    if b:
        folds, fold = plan["folds"], plan["fold"] or {}
        scratch = (torch.empty_like(lanes) if plan["wide"] else
                   torch.empty((b, folds, k, s), dtype=torch.int32,
                               device=lanes.device) if folds > 1 else None)
        rows, q = cand_index.shape
        _launch("spec_compose_lanes_tree", lanes.device,
                (lanes, keys, cand_index, sinks, out, scratch),
                (b, n, q, k, s, int(pad_key), rows, plan["segments"],
                 plan["cluster"], plan["runs"], plan["hp"], plan["slots"],
                 plan["hsize"], fold.get("runs", 0), fold.get("hp", 0),
                 fold.get("slots", 0), fold.get("hsize", 0), plan["wide"]),
                kernels=2 if folds > 1 else 1)
    return out


def lvec_compose_cuda(maps):
    """B7 on the card: maps [B, N, Q] int32 (contiguous, every entry < Q)
    composed left to right -> [B, Q]; N = 0 gives identities.  Never
    synchronises.  ``lvec_plan`` picks the instance and the segments per
    composition (one launch, or two when they exceed a cluster)."""
    dev = maps.device
    if dev.type != "cuda":
        raise ValueError(f"lvec_compose_cuda needs a CUDA tensor, got {dev}")
    if maps.dtype != torch.int32 or not maps.is_contiguous():
        raise ValueError("maps must be a contiguous int32 tensor")
    if maps.dim() != 3:
        raise ValueError(f"maps must be [B, N, Q], got {tuple(maps.shape)}")
    b, n, q = maps.shape
    return _lvec_launch(maps, lvec_plan(b, n, q) if b and q else None)


def _lvec_launch(maps, plan):
    """B7 on ``maps`` [B, N, Q] as ``plan`` (an ``lvec_plan`` dict) says."""
    b, n, q = maps.shape
    out = torch.empty((b, q), dtype=torch.int32, device=maps.device)
    if b and q:
        folds = plan["folds"]
        scratch = (torch.empty((b, folds, q), dtype=torch.int32,
                               device=maps.device) if folds > 1 else None)
        _launch("lvec_compose", maps.device, (maps, out, scratch),
                (b, n, q, plan["segments"], plan["cluster"], plan["pack"],
                 plan["tpu"], plan["nq"], plan["cons"], plan["tile"],
                 plan["fold_tile"], plan["wide"]),
                kernels=2 if folds > 1 else 1)
    return out


# --------------------------------------------------------------------------
# plain versions (same combine, same order)
# --------------------------------------------------------------------------

def spec_compose_lanes_torch(lanes, keys, cand_index, sinks, *,
                             pad_key: int):
    """Plain version of B3: a sequential fold over N -> [B, K, S]."""
    acc = lanes[:, 0].to(torch.int32)
    for i in range(1, lanes.shape[1]):
        acc = compose_lanes_torch(acc, lanes[:, i], keys[:, i], cand_index,
                                  sinks, pad_key=pad_key)
    return acc


def spec_compose_lanes_tree_torch(lanes, keys, cand_index, sinks, *,
                                  pad_key: int):
    """Plain version of B4: pairwise levels, each pair keeping its left key
    (N a power of two) -> [B, K, S]."""
    n = lanes.shape[1]
    if n & (n - 1):
        raise ValueError(f"the tree compose needs N a power of two, got {n}")
    lanes = lanes.to(torch.int32)
    while n > 1:
        lanes = compose_lanes_torch(lanes[:, 0::2], lanes[:, 1::2],
                                    keys[:, 1::2], cand_index, sinks,
                                    pad_key=pad_key)
        keys = keys[:, 0::2]
        n //= 2
    return lanes[:, 0]


def lvec_compose_torch(maps):
    """Plain version of B7: one gather per map, left to right -> [B, Q]."""
    return lvec_compose_ref(maps)
