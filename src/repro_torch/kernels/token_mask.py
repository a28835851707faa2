"""Launch wrapper of the constrained-decoding logit mask kernel (B5).

``token_mask_cuda`` launches the Hopper kernel of ``csrc/token_mask.cu``: per
decode row, gather the row of ``allowed`` at the row's grammar-DFA state and
select each logit or the masked value in one pass, so the [B, V] mask never
reaches device memory.  It replaces the Pallas kernel
``repro/kernels/token_mask.py::token_mask_kernel``.  ``token_mask_torch`` is
its plain PyTorch version, and ``launches`` counts kernel launches only.

Operands: states [B] int32, allowed [Q, V] uint8 (or bool), logits [B, V]
float32 or bfloat16, contiguous, on one CUDA device; the output has the
logits' dtype.  The kernel copies bits, so it equals the plain version
exactly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["token_mask_cuda", "token_mask_torch", "launches",
           "reset_launches"]

# kernel launches; incremented only where the kernel launches
launches = {"token_mask": 0}

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def reset_launches() -> None:
    launches["token_mask"] = 0


def _entry():
    fn = _build.load("token_mask").token_mask_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def neg_bits(neg: float, dtype: torch.dtype) -> int:
    """Bit pattern of ``neg`` rounded to ``dtype`` (the masked logit)."""
    bits = torch.tensor(neg, dtype=dtype).view(_BITS[dtype]).item()
    return int(bits) & ((1 << (8 * dtype.itemsize)) - 1)


def token_mask_cuda(states: torch.Tensor, allowed: torch.Tensor,
                    logits: torch.Tensor, *, neg: float = -1e30):
    """B5 on the card -> masked logits [B, V]; never synchronises."""
    dev = logits.device
    for t in (states, allowed, logits):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("token_mask_cuda needs every operand on one "
                             f"CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("token_mask_cuda needs contiguous operands")
    if logits.dtype not in _BITS:
        raise ValueError(f"logits must be float32 or bfloat16, got "
                         f"{logits.dtype}")
    if states.dtype != torch.int32:
        raise ValueError("states must be int32")
    if allowed.dtype == torch.bool:
        allowed = allowed.view(torch.uint8)
    if allowed.dtype != torch.uint8:
        raise ValueError("allowed must be uint8 or bool")
    b, v = logits.shape
    if states.shape != (b,) or allowed.dim() != 2 or allowed.shape[1] != v:
        raise ValueError("operand shapes disagree")
    out = torch.empty_like(logits)
    if b == 0 or v == 0:
        return out
    size = logits.element_size()
    vec = 16 // size
    aligned = (v % vec == 0 and logits.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0 and allowed.data_ptr() % vec == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(states.data_ptr(), allowed.data_ptr(),
                       logits.data_ptr(), out.data_ptr(), b, v, size,
                       neg_bits(neg, logits.dtype), int(aligned), stream)
    if err:
        raise RuntimeError(f"token_mask kernel launch failed: CUDA error "
                           f"{err}")
    launches["token_mask"] += 1
    return out


def token_mask_torch(states: torch.Tensor, allowed: torch.Tensor,
                     logits: torch.Tensor, *, neg: float = -1e30):
    """Plain version of B5: gather the mask rows, then select
    (``ref.token_mask_ref``)."""
    return ref.token_mask_ref(states, allowed, logits, neg)
