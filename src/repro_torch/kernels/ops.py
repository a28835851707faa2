"""Public wrappers of the matching kernels: padding, block size, dispatch.

Each op pads its inputs to kernel-legal shapes and dispatches on the device
of its tensors: a CPU tensor runs the kernel's plain PyTorch version, a CUDA
tensor launches the hand-written kernel (or the call raises).  Semantics are
those of the ``ref.py`` oracles; the return contract is the JAX package's
``kernels/ops.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dfa_match, flash_attn as _flash_attn, lvec_compose
from . import token_mask as _token_mask

__all__ = ["spec_match_merge", "spec_match_merge_lanes",
           "spec_compose_lanes", "token_mask", "flash_attn"]


def _pad_to_block(n: int, target: int) -> tuple[int, int]:
    """Block size and padded extent for a length-``n`` axis.

    Returns ``(block, n_padded)`` with ``block = min(n, target)`` and
    ``n_padded`` the next multiple of ``block``; callers pad the axis with
    identity-class symbols, so the extra tail is a semantic no-op.
    """
    blk = max(1, min(n, target))
    return blk, n + (-n) % blk


def _pad_merge_chunks(chunks: torch.Tensor, pad_cls: int,
                      l_blk_target: int) -> tuple[torch.Tensor, int]:
    """Pad the symbol axis of [B, C, L] chunks with the identity pad class."""
    l = chunks.shape[-1]
    l_blk, l_pad = _pad_to_block(l, l_blk_target)
    if l_pad != l:
        chunks = F.pad(chunks, (0, l_pad - l), value=pad_cls)
    return chunks.contiguous(), l_blk


def _dispatch(cuda_fn, torch_fn, x, args, kw,
              cuda_only=("table_in_smem", "carry_in_smem")):
    """CUDA tensors launch ``cuda_fn``; CPU tensors run the plain
    ``torch_fn`` without the CUDA-only placement keywords."""
    if x.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if x.device.type == "cpu":
        for name in cuda_only:
            kw.pop(name)
        return torch_fn(*args, **kw)
    raise ValueError(f"no kernel for device {x.device}")


def spec_match_merge(table, chunks, init_states, lookahead, cand_index, sinks,
                     absorbing, *, pad_cls: int, pad_key: int | None = None,
                     early_exit: bool = True, l_blk: int = 512,
                     table_in_smem: bool | None = None,
                     carry_in_smem: bool | None = None):
    """Fused chunk scan + Eq. 8 merge of a document bucket (kernel B1).

    ``table`` is the padded packed table (identity ``pad_cls`` column); L is
    padded with ``pad_cls`` symbols up to the block multiple.  ``pad_key``
    is the fold's passthrough boundary key: ``pad_cls`` under r=1,
    ``n_classes ** 2`` under r=2.  Returns ``(finals [B, K], skipped [B],
    l_blk)`` — symbol blocks skipped per document by the all-absorbed early
    exit, and the block size that converts them into an exit position.
    ``table_in_smem``/``carry_in_smem`` force the kernel's table and lane
    carry placements (CUDA only; ``dfa_match.smem_plan``).
    """
    pad_key = pad_cls if pad_key is None else pad_key
    chunks, l_blk = _pad_merge_chunks(chunks, pad_cls, l_blk)
    out, skipped = _dispatch(
        dfa_match.spec_match_merge_cuda, dfa_match.spec_match_merge_torch,
        chunks, (table, chunks, init_states, lookahead, cand_index, sinks,
                 absorbing),
        dict(pad_key=pad_key, l_blk=l_blk, early_exit=early_exit,
             table_in_smem=table_in_smem, carry_in_smem=carry_in_smem))
    return out, skipped, l_blk


def spec_match_merge_lanes(table, chunks, init_states, lookahead, cand_index,
                           sinks, absorbing, *, pad_cls: int,
                           pad_key: int | None = None,
                           early_exit: bool = True, l_blk: int = 512,
                           table_in_smem: bool | None = None,
                           carry_in_smem: bool | None = None):
    """Lane-carrying fused match + merge (kernel B2): the [K, S] candidate
    lane axis survives the fold.  Returns ``(lanes [B, K, S], skipped [B],
    l_blk)``; ``pad_key`` as in ``spec_match_merge``."""
    pad_key = pad_cls if pad_key is None else pad_key
    chunks, l_blk = _pad_merge_chunks(chunks, pad_cls, l_blk)
    out, skipped = _dispatch(
        dfa_match.spec_match_merge_lanes_cuda,
        dfa_match.spec_match_merge_lanes_torch,
        chunks, (table, chunks, init_states, lookahead, cand_index, sinks,
                 absorbing),
        dict(pad_key=pad_key, l_blk=l_blk, early_exit=early_exit,
             table_in_smem=table_in_smem, carry_in_smem=carry_in_smem))
    k = sinks.shape[0]
    return out.reshape(out.shape[0], k, -1), skipped, l_blk


def spec_compose_lanes(lane_maps, entry_keys, cand_index, sinks, *,
                       pad_key: int, mode: str = "carry", n_blk: int = 8):
    """Fold [B, N, K, S] keyed lane-map runs in one kernel launch.

    The out-of-order gap-close compose (``Matcher.compose_lane_maps``): per
    row, element 0's lanes seed the result and elements 1..N-1 fold in keyed
    by ``entry_keys`` (``pad_key`` elements are identities, so ragged runs
    arrive right-padded).  ``mode="carry"`` is the sequential fold (kernel
    B3; N padded to an ``n_blk`` multiple, the Pallas block contract);
    ``mode="tree"`` the pairwise reduce (kernel B4; N padded to a power of
    two).  Padding is zero maps with ``pad_key`` keys.  Returns [B, K, S]
    with the semantics of ``ref.spec_compose_lanes_ref``.

    Real candidate lanes (the only lanes ``cand_index`` selects for a
    consumer) agree across every order.  Pad lanes — filler states a key's
    candidate row repeats to reach width S — carry order-dependent
    passthrough values: the carry fold equals the oracle on every lane, the
    tree may differ from it on pad lanes only.
    """
    n = lane_maps.shape[1]
    assert n >= 1, "empty runs are the caller's fast path"
    if mode == "tree":
        n_pad = 1 << (n - 1).bit_length()
        cuda_fn = lvec_compose.spec_compose_lanes_tree_cuda
        torch_fn = lvec_compose.spec_compose_lanes_tree_torch
    elif mode == "carry":
        _, n_pad = _pad_to_block(n, n_blk)
        cuda_fn = lvec_compose.spec_compose_lanes_cuda
        torch_fn = lvec_compose.spec_compose_lanes_torch
    else:
        raise ValueError(f"unknown compose mode {mode!r}")
    if n_pad != n:  # pad_key tail elements compose as identities
        lane_maps = F.pad(lane_maps, (0, 0, 0, 0, 0, n_pad - n))
        entry_keys = F.pad(entry_keys, (0, n_pad - n), value=pad_key)
    return _dispatch(cuda_fn, torch_fn, lane_maps,
                     (lane_maps.contiguous(), entry_keys.contiguous(),
                      cand_index, sinks),
                     dict(pad_key=pad_key), cuda_only=())


def token_mask(states, allowed, logits, *, neg: float = -1e30):
    """Fused grammar mask (kernel B5); see ``ref.token_mask_ref``.

    states [B] int32, allowed [Q, V] uint8/bool, logits [B, V] float32 or
    bfloat16 -> masked logits of the logits' dtype.  Any V: the kernel masks
    the vocab tail itself, so nothing is padded.
    """
    return _dispatch(_token_mask.token_mask_cuda, _token_mask.token_mask_torch,
                     logits, (states, allowed, logits), dict(neg=neg),
                     cuda_only=())


def flash_attn(q, k, v, *, causal: bool = True, window: int = 0,
               group: int = 1):
    """Fused flash-attention forward (kernel B9); see ``ref.flash_attn_ref``.

    q [BH, T, D]; k, v [BH / group, S, D] (``group = 1``: the [BH, S, D]
    contract of the JAX op; a GQA caller may pass its kv heads unrepeated
    with ``group`` query heads each) -> [BH, T, D].  Any T and S: the kernel
    masks both tails, so no block size has to divide them.
    """
    return _dispatch(_flash_attn.flash_attn_cuda, _flash_attn.flash_attn_torch,
                     q, (q, k, v), dict(causal=causal, window=window,
                                        group=group), cuda_only=())
