"""Plain PyTorch oracles of the kernels.

Each ``*_ref`` function defines the semantics its kernel must reproduce, on
tensors of any device.  The matching oracles return integer state ids, so
every comparison against them is exact; documents are batched on the
leading axis and the folds loop over chunks and symbols, never over
documents.  ``token_mask_ref`` selects bits and is exact too;
``flash_attn_ref`` is the one float oracle (bf16 products, f32 softmax).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["classify_pad_ref", "spec_match_ref", "spec_match_merge_ref",
           "spec_match_merge_lanes_ref", "spec_merge_ref",
           "spec_merge_lanes_ref", "cursor_merge_ref", "scan_lanes",
           "compose_lanes_torch", "spec_merge_lanes_scan_ref",
           "spec_compose_lanes_ref", "lvec_compose_ref",
           "onehot_block_maps_ref", "token_mask_ref", "flash_attn_ref"]


def classify_pad_ref(byte_to_class: torch.Tensor, bytes_buf: torch.Tensor,
                     lengths: torch.Tensor, pad_cls: int) -> torch.Tensor:
    """Batched padded classification: positions >= length become ``pad_cls``.

    bytes_buf [B, W] uint8 (pad bytes arbitrary); lengths [B]; returns
    [B, W] int32 class ids.
    """
    cls = byte_to_class[bytes_buf.long()]
    pos = torch.arange(bytes_buf.shape[1], device=bytes_buf.device)[None, :]
    return torch.where(pos < lengths.long()[:, None], cls,
                       torch.full_like(cls, pad_cls)).to(torch.int32)


def scan_lanes(table: torch.Tensor, chunks: torch.Tensor,
               states: torch.Tensor) -> torch.Tensor:
    """``states [R, N]`` through ``chunks [R, L]`` class columns -> [R, N].

    table [Q, n_cls_pad] int32; one gather per symbol over all lanes.
    """
    n_cls_pad = table.shape[1]
    flat = table.reshape(-1).long()
    st = states.long()
    cols = chunks.long()
    for pos in range(cols.shape[1]):
        st = flat[st * n_cls_pad + cols[:, pos:pos + 1]]
    return st.to(torch.int32)


def spec_match_ref(table: torch.Tensor, chunks: torch.Tensor,
                   init_states: torch.Tensor) -> torch.Tensor:
    """Match [C] chunks x [S] speculative lanes; table [Q, n_cls] int32.

    chunks [C, L] int32 class ids; init_states [C, S] int32.  Returns [C, S]
    final states, one gather per symbol over every lane: the semantics of
    paper Listing 2.
    """
    return scan_lanes(table, chunks, init_states)


def compose_lanes_torch(a: torch.Tensor, b: torch.Tensor,
                        b_keys: torch.Tensor, cand_index: torch.Tensor,
                        sinks: torch.Tensor, *, pad_key: int) -> torch.Tensor:
    """The keyed Eq. 8 combine of two lane maps: ``a`` then ``b``.

    ``a [..., K, Sa]`` carries states; ``b [..., K, S]`` is a map keyed by
    ``b_keys [...]`` (its lane j of pattern k assumed entry
    ``candidates[key, k, j]``).  Every carried state ``q`` reads
    ``b[..., k, cand_index[key, q]]``, gathered within pattern k's own S
    lanes; a miss is the pattern's sink, or ``q`` itself when the pattern
    has none; a ``pad_key`` key makes ``b`` the identity.  Returns
    ``[..., K, Sa]`` int32.
    """
    a = a.to(torch.int32)
    bk = b_keys.long()[..., None, None]
    lane = cand_index[bk, a.long()]
    hit = torch.gather(b.to(torch.int32), -1, lane.clamp(min=0).long())
    sk = sinks.to(torch.int32)[:, None]
    out = torch.where(lane < 0, torch.where(sk >= 0, sk, a), hit)
    return torch.where(bk == pad_key, a, out).to(torch.int32)


def _merge_fold(start: torch.Tensor, lvecs: torch.Tensor,
                lookahead: torch.Tensor, exact: torch.Tensor,
                cand_index: torch.Tensor, sinks: torch.Tensor, *,
                pad_cls: int, exact_lane0: bool) -> torch.Tensor:
    """The one Eq. 8 fold shared by every merge entry point.

    ``start [B, K, Sc]`` is the carried lane set (``Sc == 1`` for an exact
    carry); each later chunk maps every carried state through its candidate
    lanes (``lvecs [B, C-1, K, S]``, ``lookahead [B, C-1]``, ``exact
    [C-1]``).  A carried state missing from the candidate row is the
    pattern's absorbing sink; a ``pad_cls`` lookahead (the pad key) means the
    whole chunk is padding (identity).  ``exact_lane0`` picks the rule for
    chunks matched exactly from the entry states: an exact carry reads lane
    0, a candidate-keyed carry composes lane-for-lane.
    """
    st = start.to(torch.int32)
    for i in range(lvecs.shape[1]):
        lv_i = lvecs[:, i].to(torch.int32)                      # [B, K, S]
        nxt = compose_lanes_torch(st, lv_i, lookahead[:, i], cand_index,
                                  sinks, pad_key=pad_cls)       # [B, K, Sc]
        if bool(exact[i]):
            nxt = lv_i[:, :, :1].expand_as(st) if exact_lane0 else lv_i
        st = nxt.to(torch.int32)
    return st


def spec_merge_ref(lvecs: torch.Tensor, lookahead: torch.Tensor,
                   cand_index: torch.Tensor, sinks: torch.Tensor, *,
                   pad_cls: int, exact=None) -> torch.Tensor:
    """Eq. 8 merge of batched per-chunk lane states.

    lvecs [B, C, K, S]; lookahead [B, C] boundary keys (entry 0 unused);
    returns [B, K] final packed states.  ``exact`` [C] optionally marks
    chunks matched exactly from the start states (chunk 0 always is).
    ``pad_cls`` is the fold's passthrough key (the pad key under r=2).
    """
    if exact is None:
        exact = np.zeros(lvecs.shape[1], bool)
    return _merge_fold(lvecs[:, 0, :, :1], lvecs[:, 1:], lookahead[:, 1:],
                       exact[1:], cand_index, sinks, pad_cls=pad_cls,
                       exact_lane0=True)[:, :, 0]


def spec_merge_lanes_ref(lvecs: torch.Tensor, lookahead: torch.Tensor,
                         cand_index: torch.Tensor, sinks: torch.Tensor, *,
                         pad_cls: int, exact=None) -> torch.Tensor:
    """Eq. 8 merge carrying the full candidate lane axis: [B, C, K, S] per-
    chunk lane states fold to [B, K, S] — each document's restricted
    transition map under every candidate entry of its boundary key."""
    if exact is None:
        exact = np.zeros(lvecs.shape[1], bool)
    return _merge_fold(lvecs[:, 0], lvecs[:, 1:], lookahead[:, 1:],
                       exact[1:], cand_index, sinks, pad_cls=pad_cls,
                       exact_lane0=False)


def spec_match_merge_ref(table: torch.Tensor, chunks: torch.Tensor,
                         init_states: torch.Tensor, lookahead: torch.Tensor,
                         cand_index: torch.Tensor, sinks: torch.Tensor, *,
                         pad_cls: int) -> torch.Tensor:
    """Batched chunk scan + Eq. 8 merge over packed patterns.

    table [Q, n_cls_pad] (identity pad column last); chunks [B, C, L];
    init_states [B, C, K * S] (chunk 0's lanes hold the exact entry
    states); lookahead [B, C]; cand_index [n_keys + 1, Q]; sinks [K].
    Returns [B, K] final packed states.
    """
    b, c, l = chunks.shape
    k = sinks.shape[0]
    s = init_states.shape[-1] // k
    lv = scan_lanes(table, chunks.reshape(b * c, l),
                    init_states.reshape(b * c, k * s))
    return spec_merge_ref(lv.reshape(b, c, k, s), lookahead, cand_index,
                          sinks, pad_cls=pad_cls)


def spec_match_merge_lanes_ref(table: torch.Tensor, chunks: torch.Tensor,
                               init_states: torch.Tensor,
                               lookahead: torch.Tensor,
                               cand_index: torch.Tensor, sinks: torch.Tensor,
                               *, pad_cls: int) -> torch.Tensor:
    """Lane-carrying twin of ``spec_match_merge_ref``: chunk 0's lanes are
    candidate entries of a boundary key and the fold keeps the ``[K, S]``
    carry.  Returns [B, K * S]."""
    b, c, l = chunks.shape
    k = sinks.shape[0]
    s = init_states.shape[-1] // k
    lv = scan_lanes(table, chunks.reshape(b * c, l),
                    init_states.reshape(b * c, k * s))
    out = spec_merge_lanes_ref(lv.reshape(b, c, k, s), lookahead, cand_index,
                               sinks, pad_cls=pad_cls)
    return out.reshape(b, k * s)


def cursor_merge_ref(cursor_lanes: np.ndarray, seg_lanes: np.ndarray,
                     entry_cls: np.ndarray, cand_index: np.ndarray,
                     sinks: np.ndarray, *, pad_cls: int) -> np.ndarray:
    """Batched Eq. 8 cursor x segment composition — the numpy host reference
    of the streaming device merge (``Matcher.advance_cursors``).

    ``cursor_lanes [B, K, Sc]`` holds each stream's prefix exit states per
    entry lane (``Sc == 1`` for collapsed exact cursors); ``seg_lanes
    [B, K, S]`` is each stream's next segment matched independently, keyed by
    the candidates of ``entry_cls [B]`` — the boundary key just before the
    segment.  For every carried state ``q``: ``cand_index[entry_cls, q]``
    selects the segment lane that assumed entry ``q``; a missing ``q`` is the
    pattern's absorbing sink; rows whose ``entry_cls == pad_cls`` pass
    through unchanged (zero-byte segments).
    """
    q = np.asarray(cursor_lanes, np.int32)
    ec = np.asarray(entry_cls, np.int32)
    cand_index = np.asarray(cand_index)
    # clamp the row index so an unpadded [n_cls, Q] table also works: the
    # pad_cls passthrough below overrides whatever the clamped gather reads
    safe_ec = np.minimum(ec, np.int32(cand_index.shape[0] - 1))
    lane = cand_index[safe_ec[:, None, None], q]                # [B, K, Sc]
    hit = np.take_along_axis(np.asarray(seg_lanes, np.int32),
                             np.maximum(lane, 0), axis=2)
    sk = np.asarray(sinks, np.int32)[None, :, None]
    out = np.where(lane < 0, np.where(sk >= 0, sk, q), hit)
    out = np.where((ec == pad_cls)[:, None, None], q, out)
    return out.astype(np.int32)


def spec_merge_lanes_scan_ref(lane_maps: np.ndarray, entry_keys: np.ndarray,
                              cand_index: np.ndarray, sinks: np.ndarray,
                              *, pad_cls: int) -> np.ndarray:
    """Sequential-fold oracle of the associative lane-map scan.

    ``lane_maps [B, N, K, S]`` holds, per batch row, a run of candidate-keyed
    segment transition maps (leftmost first); ``entry_keys [B, N]`` the
    boundary key selecting each map's Eq. 11 candidate entry row.  Returns
    all prefixes ``out[:, i] = m_0 ; ... ; m_i`` by repeated
    :func:`cursor_merge_ref` — the semantics ``core.lvector
    .merge_scan_lanes_torch`` must reproduce in log depth (keys equal to
    ``pad_cls`` compose as the identity; element 0's key is never read).
    """
    lanes = np.asarray(lane_maps, np.int32)
    keys = np.asarray(entry_keys, np.int32)
    out = np.empty_like(lanes)
    if lanes.shape[1] == 0:
        return out
    out[:, 0] = lanes[:, 0]
    for i in range(1, lanes.shape[1]):
        out[:, i] = cursor_merge_ref(out[:, i - 1], lanes[:, i], keys[:, i],
                                     cand_index, sinks, pad_cls=pad_cls)
    return out


def spec_compose_lanes_ref(lane_maps: np.ndarray, entry_keys: np.ndarray,
                           cand_index: np.ndarray, sinks: np.ndarray,
                           *, pad_cls: int) -> np.ndarray:
    """Final composition of each keyed lane-map run: the gap-close fold.

    The oracle of the compose kernels (``lvec_compose``, B3 and B4) and of
    ``Matcher.compose_lane_maps`` — the last prefix of
    :func:`spec_merge_lanes_scan_ref`.  Returns [B, K, S].
    """
    return spec_merge_lanes_scan_ref(lane_maps, entry_keys, cand_index,
                                     sinks, pad_cls=pad_cls)[:, -1]


def lvec_compose_ref(maps: torch.Tensor) -> torch.Tensor:
    """Left-to-right composition of full maps: out = m_{C-1} o ... o m_0.

    maps [..., C, Q] int32; out [..., Q] with out[q] = delta*(q, chunk_0 ...
    chunk_{C-1}).  Leading axes are independent batches.
    """
    acc = torch.arange(maps.shape[-1], device=maps.device).expand(
        maps.shape[:-2] + maps.shape[-1:])
    for i in range(maps.shape[-2]):
        acc = torch.gather(maps[..., i, :].long(), -1, acc)
    return acc.to(torch.int32)


def onehot_block_maps_ref(table: torch.Tensor, symbols: torch.Tensor,
                          block_l: int) -> torch.Tensor:
    """Per-block transition maps of the one-hot product formulation.

    symbols [..., L] (L divisible by block_l).  Block b's map is
    delta*(q, symbols[..., b*block_l:(b+1)*block_l]) for every q, returned
    as int32 [..., L // block_l, Q].
    """
    q = table.shape[0]
    blocks = symbols.reshape(-1, block_l)
    acc = torch.arange(q, dtype=torch.int32, device=symbols.device)
    out = scan_lanes(table, blocks, acc.expand(blocks.shape[0], q))
    return out.reshape(*symbols.shape[:-1], -1, q)


def token_mask_ref(states: torch.Tensor, allowed: torch.Tensor,
                   logits: torch.Tensor, neg: float = -1e30) -> torch.Tensor:
    """Constrained-decoding logit masking.

    states [B] int32 DFA states; allowed [Q, V] bool (or 0/1); logits [B, V]
    float.  Returns logits with disallowed tokens set to ``neg`` rounded to
    the logits' dtype.
    """
    mask = allowed[states.long()].bool()  # [B, V]
    return torch.where(mask, logits,
                       torch.tensor(neg, dtype=logits.dtype,
                                    device=logits.device))


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Oracle of the fused flash-attention kernel: q/k/v [BH, T|S, D]."""
    d = q.shape[-1]
    logits = torch.einsum("htd,hsd->hts", q, k).float() * d ** -0.5
    t, s = q.shape[1], k.shape[1]
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    logits = torch.where(ok[None], logits, torch.tensor(-1e30,
                                                        device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("hts,hsd->htd", probs, v)
