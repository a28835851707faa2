"""Public wrappers of the matching kernels: padding, block size, dispatch.

Each op pads its inputs to kernel-legal shapes and dispatches on the device
of its tensors: a CPU tensor runs the kernel's plain PyTorch version, a CUDA
tensor launches the hand-written kernel (or the call raises).  Semantics are
those of the ``ref.py`` oracles; the return contract is the JAX package's
``kernels/ops.py``.  While a census is taken (``launch.census``), each
launch is counted in it with its work (``census_hooks``).  Of the kernels
only B9 takes the ``FakeTensor``s of a trace of the card's program
(``census_hooks.on_card``; ``flash_attn.flash_attn_cuda``); the others
refuse them.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from . import census_hooks as _hooks
from . import dfa_match, flash_attn as _flash_attn, lvec_compose as _lvec
from . import onehot_match, token_mask as _token_mask

__all__ = ["spec_match", "spec_match_merge", "spec_match_merge_lanes",
           "spec_compose_lanes", "lvec_compose", "onehot_block_maps",
           "mxu_profitable", "token_mask", "flash_attn"]


def _pad_to_block(n: int, target: int) -> tuple[int, int]:
    """Block size and padded extent for a length-``n`` axis.

    Returns ``(block, n_padded)`` with ``block = min(n, target)`` and
    ``n_padded`` the next multiple of ``block``; callers pad the axis with
    identity-class symbols, so the extra tail is a semantic no-op.
    """
    blk = max(1, min(n, target))
    return blk, n + (-n) % blk


def _identity_padded_table(table: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Append an identity class column (state q maps to itself).

    Raw transition tables have no reserved padding class; this returns a
    widened table plus the new class index, giving padded symbols a sound
    no-op transition.
    """
    q = table.shape[0]
    ident = torch.arange(q, dtype=table.dtype, device=table.device)[:, None]
    return torch.cat([table, ident], dim=1), table.shape[1]


def mxu_profitable(q: int, s: int, *, vpu_lanes: int = 1024,
                   mxu_dim: int = 128) -> bool:
    """The JAX package's crossover between the gather route (B6) and the
    one-hot product route (B8 + B7) of ``spec_match``.

    Its constants are the TPU's (a 1024-lane vector unit, a 128 x 128
    matrix unit): the product route when the DFA is small (Q <= 256) and
    the speculation wide (S >= Q / 2, S > 8).  The route changes only the
    speed, never a result; the port keeps the JAX decision so both packages
    pick the same route, and ``chip_smoke.py`` measures both routes on the
    card.
    """
    return q <= mxu_dim * 2 and s >= q // 2 and s > vpu_lanes // mxu_dim


def spec_match(table, chunks, init_states, *, use_mxu: bool | None = None):
    """Match [C] chunks x [S] lanes; the semantics of ``ref.spec_match_ref``.

    table [Q, n_cls], chunks [C, L] class ids, init_states [C, S] -> [C, S]
    final states.  ``use_mxu`` picks the route (``mxu_profitable`` when
    None): the gather route is one launch of kernel B6 on the unpadded
    operands (the kernel takes any C and L); the product route pads L to
    the 256-symbol block with an appended identity class, computes every
    chunk's full [Q] map with one B8 launch over all (chunk, block) pairs
    and one B7 launch over chunks, and reads the lanes' states from it.
    """
    c, l = chunks.shape
    q = table.shape[0]
    s = init_states.shape[1]
    if use_mxu is None:
        use_mxu = mxu_profitable(q, s)
    if use_mxu:
        l_blk, l_pad = _pad_to_block(l, 256)
        if l_pad != l:
            table, id_cls = _identity_padded_table(table)
            chunks = F.pad(chunks, (0, l_pad - l), value=id_cls)
        maps = _dispatch(onehot_match.onehot_block_maps_cuda,
                         onehot_match.onehot_block_maps_torch, chunks,
                         (table.contiguous(), chunks.contiguous()),
                         dict(l_blk=l_blk), cuda_only=())
        full = lvec_compose(maps)                               # [C, Q]
        return torch.gather(full, 1, init_states.long())
    return _dispatch(dfa_match.spec_match_cuda, dfa_match.spec_match_torch,
                     chunks, (table.contiguous(), chunks.contiguous(),
                              init_states.contiguous()), {}, cuda_only=())


def lvec_compose(maps):
    """Compose maps left to right (kernel B7); ``ref.lvec_compose_ref``.

    maps [C, Q] -> [Q], or [B, C, Q] -> [B, Q] in one launch of any C.
    """
    batched = maps.dim() == 3
    maps = maps if batched else maps[None]
    out = _dispatch(_lvec.lvec_compose_cuda, _lvec.lvec_compose_torch, maps,
                    (maps.contiguous(),), {}, cuda_only=())
    return out if batched else out[0]


def onehot_block_maps(table, symbols, *, block_l: int = 256):
    """Block maps of the one-hot product formulation (kernel B8); see
    ``ref.onehot_block_maps_ref``.

    symbols [L] -> [L / l_blk, Q], or [C, L] -> [C, L / l_blk, Q] in one
    launch, with ``l_blk = min(L, block_l)``.  A length that is not a
    multiple is padded with an appended identity class, so the extra
    trailing block maps are identities.
    """
    batched = symbols.dim() == 2
    symbols = symbols if batched else symbols[None]
    l = symbols.shape[1]
    l_blk, l_pad = _pad_to_block(l, block_l)
    if l_pad != l:
        table, id_cls = _identity_padded_table(table)
        symbols = F.pad(symbols, (0, l_pad - l), value=id_cls)
    out = _dispatch(onehot_match.onehot_block_maps_cuda,
                    onehot_match.onehot_block_maps_torch, symbols,
                    (table.contiguous(), symbols.contiguous()),
                    dict(l_blk=l_blk), cuda_only=())
    return out if batched else out[0]


def _pad_merge_chunks(chunks: torch.Tensor, pad_cls: int,
                      l_blk_target: int) -> tuple[torch.Tensor, int]:
    """Pad the symbol axis of [B, C, L] chunks with the identity pad class."""
    l = chunks.shape[-1]
    l_blk, l_pad = _pad_to_block(l, l_blk_target)
    if l_pad != l:
        chunks = F.pad(chunks, (0, l_pad - l), value=pad_cls)
    return chunks.contiguous(), l_blk


# kernels whose wrapper has a path for FakeTensors
_FAKE_PATHS = {"flash_attn"}


def _kernel_name(cuda_fn) -> str:
    return cuda_fn.__name__.removesuffix("_cuda")


def _counted_launch(cuda_fn, args, kw):
    """``cuda_fn(*args, **kw)``, its launches counted in the census being
    taken with their flops and their operands' bytes read and written
    once (B9: ``flash_attn.flash_work``)."""
    name = _kernel_name(cuda_fn)
    counter = getattr(sys.modules.get(cuda_fn.__module__), "launches", {})
    before = counter.get(name, 0)
    out = cuda_fn(*args, **kw)
    n = counter.get(name, 0) - before
    if n:
        if name == "flash_attn":
            flops, n_bytes = _flash_attn.flash_work(*args, **kw)
        else:
            flops, n_bytes = 0.0, float(_hooks.tensor_bytes(args)
                                        + _hooks.tensor_bytes(out))
        _hooks.record_kernel(name, n, flops, n_bytes)
    return out


def _dispatch(cuda_fn, torch_fn, x, args, kw,
              cuda_only=("table_in_smem", "carry_in_smem")):
    """CUDA tensors launch ``cuda_fn`` (counted while a census is taken:
    ``_counted_launch``); CPU tensors run the plain ``torch_fn`` without
    the CUDA-only placement keywords."""
    if _hooks.on_card(x):
        if _hooks.is_fake(x) and _kernel_name(cuda_fn) not in _FAKE_PATHS:
            raise ValueError(f"kernel {_kernel_name(cuda_fn)} cannot take "
                             f"FakeTensors: only {sorted(_FAKE_PATHS)} can "
                             "be traced without a card")
        if _hooks.active():
            return _counted_launch(cuda_fn, args, kw)
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
        cuda_fn = _lvec.spec_compose_lanes_tree_cuda
        torch_fn = _lvec.spec_compose_lanes_tree_torch
    elif mode == "carry":
        _, n_pad = _pad_to_block(n, n_blk)
        cuda_fn = _lvec.spec_compose_lanes_cuda
        torch_fn = _lvec.spec_compose_lanes_torch
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
