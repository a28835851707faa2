"""Launch wrappers of the keyed lane-map compose kernels (B3, B4).

``spec_compose_lanes_cuda`` (the sequential carry fold) and
``spec_compose_lanes_tree_cuda`` (the pairwise tree reduce) launch the
Hopper kernels of ``csrc/lvec_compose.cu``, one CTA per run.  They replace
the Pallas kernels ``repro/kernels/lvec_compose.py::spec_compose_lanes_kernel``
and ``spec_compose_lanes_tree_kernel``: the out-of-order gap-close fold of
``Matcher.compose_lane_maps``.  Each has its plain PyTorch version beside it
(``*_torch``) and a launch counter in ``launches`` that only a kernel launch
increments.

Operands (all int32, contiguous, on one CUDA device): lanes [B, N, K, S]
keyed lane-map runs, keys [B, N] boundary keys (element 0's never read;
``pad_key`` elements are identities), cand_index [n_keys + 1, Q] with the
all -1 pad row, sinks [K].  Both return the composition [B, K, S].  The
carry fold is the sequential oracle's order, so it equals
``ref.spec_compose_lanes_ref`` on every lane; the tree pairs elements as the
Pallas tree does and may differ from the oracle on pad lanes only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import compose_lanes_torch

__all__ = ["spec_compose_lanes_cuda", "spec_compose_lanes_tree_cuda",
           "spec_compose_lanes_torch", "spec_compose_lanes_tree_torch",
           "launches", "reset_launches", "tree_in_smem"]

# kernel launches per wrapper; incremented only where the kernel launches
launches = {"spec_compose_lanes": 0, "spec_compose_lanes_tree": 0}

SMEM_BUDGET = 232_448   # dynamic shared memory one block may use (H100)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def tree_in_smem(n: int, k: int, s: int, in_smem: bool | None = None) -> bool:
    """Whether the tree stages a run of ``n`` [k, s] maps in shared memory;
    ``in_smem`` forces a placement and raises if a shared one cannot fit."""
    fits = n * k * s * 4 <= SMEM_BUDGET
    if in_smem is None:
        return fits
    if in_smem and not fits:
        raise ValueError(f"a run of {n} [{k}, {s}] maps does not fit in "
                         "shared memory")
    return bool(in_smem)


def _entry(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(_build.load("lvec_compose"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
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


def _launch(name, dev, args, ints):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(f"{name}_launch", len(args), len(ints))(
            *(None if t is None else t.data_ptr() for t in args),
            *(int(i) for i in ints), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def spec_compose_lanes_cuda(lanes, keys, cand_index, sinks, *,
                            pad_key: int):
    """B3 on the card: the carry fold of each run -> [B, K, S]; never
    synchronises."""
    dev, b, n, k, s = _check(lanes, keys, cand_index, sinks)
    out = torch.empty((b, k, s), dtype=torch.int32, device=dev)
    if b:
        _launch("spec_compose_lanes", dev,
                (lanes, keys, cand_index, sinks, out),
                (b, n, cand_index.shape[1], k, s, pad_key))
    return out


def spec_compose_lanes_tree_cuda(lanes, keys, cand_index, sinks, *,
                                 pad_key: int, in_smem: bool | None = None):
    """B4 on the card: the pairwise tree reduce of each run (N a power of
    two) -> [B, K, S].  ``in_smem`` forces the run into shared memory or
    into a global scratch copy (``tree_in_smem``)."""
    dev, b, n, k, s = _check(lanes, keys, cand_index, sinks)
    if n & (n - 1):
        raise ValueError(f"the tree compose needs N a power of two, got {n}")
    smem = tree_in_smem(n, k, s, in_smem)
    out = torch.empty((b, k, s), dtype=torch.int32, device=dev)
    scratch = None if smem else torch.empty_like(lanes)
    if b:
        _launch("spec_compose_lanes_tree", dev,
                (lanes, keys, cand_index, sinks, out, scratch),
                (b, n, cand_index.shape[1], k, s, pad_key, smem))
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
