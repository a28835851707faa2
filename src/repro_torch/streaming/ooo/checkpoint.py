"""Failover for the out-of-order tier: snapshot/restore mid-reorder.

An ``OooStreamMatcher``'s recoverable state is strictly larger than the
in-order runtime's: besides each stream's exact cursor it holds the parked
future — buffered segments (raw payloads not yet matched, ``[K, S]``
transition maps already matched), the entry-key chain, and the duplicate
verification window.  All of it is plain host data with fixed-shape array
encodings, so a snapshot is one flat tree of numpy leaves riding the same
atomic-publish checkpoint layer as the in-order sessions
(``training/checkpoint.py``: write to ``step_<N>.tmp``, rename into place).

Ragged structure flattens CSR-style: per-stream buffered segments
concatenate into ``bs_*`` arrays with ``bs_off`` [B+1] offsets, raw
payloads into one uint8 blob with ``bs_data_off`` [M+1] offsets, and the
dedup windows into ``dd_*`` with ``dd_off`` [B+1].

The tree and its keys are the JAX package's, so a snapshot moves between
the two packages and between devices: matched maps (``bs_lanes``) come back
from the card as host numpy when they are parked.  Two guards apply on
restore: the packed-table signature must match (cursor/lane state ids are
meaningless against another pattern set), and ``spec_r``/``lane_width`` must
equal the target's — buffered maps are keyed in the boundary-key space of
the resolved lookahead depth, so a snapshot taken at r=2 cannot seed an r=1
matcher.  On a mesh-sharded matcher the tree is placed replicated on the
target mesh and brought back to host numpy (``streaming.checkpoint
.restore_tree``).

After a restore, parked raw payloads are matched and parked maps folded by
the target matcher's own lowerings: the first gap close runs B2
(``advance_cursors``) and B3/B4 (``compose_lane_maps``) on a CUDA matcher.
"""

from __future__ import annotations

import numpy as np

from ..checkpoint import (check_signature, publish_tree, restore_tree,
                          table_signature)
from ..cursor import MatchCursor
from .buffer import BufferedSegment
from .sequencer import Sequencer

__all__ = ["OOO_TREE_KEYS", "ooo_tree", "save_ooo_tree", "load_ooo_tree",
           "restore_streams"]

OOO_TREE_KEYS = (
    "sig", "spec_r", "lane_width", "next_sid",
    # per stream [B]
    "sid", "states", "absorbed", "byte_count", "last_class", "next_seq",
    "segments_fed", "stream_fp",
    # buffered segments, CSR over streams ([B+1] offsets into [M])
    "bs_off", "bs_seq", "bs_n", "bs_fp", "bs_entry", "bs_hint", "bs_tail",
    "bs_tail_len", "bs_matched", "bs_lanes", "bs_has_data", "bs_data",
    "bs_data_off",
    # dedup windows, CSR over streams
    "dd_off", "dd_seq", "dd_fp", "dd_n",
)


def ooo_tree(ooo) -> dict:
    """Pack an ``OooStreamMatcher``'s open streams into the snapshot tree."""
    dev = ooo.matcher.dev
    k = ooo.matcher.packed.n_patterns
    s = dev.i_max
    seqs = [ooo._streams[sid] for sid in sorted(ooo._streams)]
    b = len(seqs)
    states = np.zeros((b, k), np.int32)
    absorbed = np.zeros((b, k), bool)
    byte_count = np.zeros(b, np.int64)
    last_class = np.zeros(b, np.int32)
    next_seq = np.zeros(b, np.int64)
    segments_fed = np.zeros(b, np.int64)
    stream_fp = np.zeros(b, np.int64)  # Rabin fps < 2^61 fit int64 exactly
    sid = np.zeros(b, np.int64)
    segs: list[BufferedSegment] = []
    bs_off = np.zeros(b + 1, np.int64)
    dd: list[tuple[int, int, int]] = []
    dd_off = np.zeros(b + 1, np.int64)
    for i, sq in enumerate(seqs):
        sid[i] = sq.sid
        states[i] = sq.cursor.states
        absorbed[i] = sq.cursor.absorbed
        byte_count[i] = sq.cursor.byte_count
        last_class[i] = sq.cursor.last_class
        next_seq[i] = sq.next_seq
        segments_fed[i] = sq.segments_fed
        stream_fp[i] = sq.stream_fp
        segs.extend(sq.buf.segments[q] for q in sorted(sq.buf.segments))
        bs_off[i + 1] = len(segs)
        dd.extend((q, fp, n) for q, (fp, n) in sorted(sq.folded_fp.items()))
        dd_off[i + 1] = len(dd)
    m = len(segs)
    bs_tail = np.zeros((m, 2), np.uint8)
    bs_lanes = np.zeros((m, k, s), np.int32)
    blobs: list[bytes] = []
    bs_data_off = np.zeros(m + 1, np.int64)
    for j, seg in enumerate(segs):
        bs_tail[j, :len(seg.tail)] = np.frombuffer(seg.tail, np.uint8)
        if seg.lanes is not None:
            bs_lanes[j] = seg.lanes
        blobs.append(seg.data or b"")
        bs_data_off[j + 1] = bs_data_off[j] + len(blobs[-1])
    return {
        "sig": np.frombuffer(
            table_signature(ooo.matcher.packed).encode(), np.uint8).copy(),
        "spec_r": np.int64(dev.spec_r),
        "lane_width": np.int64(s),
        "next_sid": np.int64(ooo._next_sid),
        "sid": sid, "states": states, "absorbed": absorbed,
        "byte_count": byte_count, "last_class": last_class,
        "next_seq": next_seq, "segments_fed": segments_fed,
        "stream_fp": stream_fp,
        "bs_off": bs_off,
        "bs_seq": np.array([g.seq for g in segs], np.int64),
        "bs_n": np.array([g.n_bytes for g in segs], np.int64),
        "bs_fp": np.array([g.fp for g in segs], np.int64),
        "bs_entry": np.array([g.entry_key for g in segs], np.int32),
        "bs_hint": np.array([g.hint_key for g in segs], np.int32),
        "bs_tail": bs_tail,
        "bs_tail_len": np.array([len(g.tail) for g in segs], np.int64),
        "bs_matched": np.array([g.matched for g in segs], bool),
        "bs_lanes": bs_lanes,
        "bs_has_data": np.array([g.data is not None for g in segs], bool),
        "bs_data": np.frombuffer(b"".join(blobs), np.uint8).copy(),
        "bs_data_off": bs_data_off,
        "dd_off": dd_off,
        "dd_seq": np.array([q for q, _, _ in dd], np.int64),
        "dd_fp": np.array([fp for _, fp, _ in dd], np.int64),
        "dd_n": np.array([n for _, _, n in dd], np.int64),
    }


def save_ooo_tree(directory: str, tree: dict, step: int,
                  matcher=None) -> str:
    """Atomic publish through the shared checkpoint layer
    (``streaming.checkpoint.publish_tree``: one writer on a mesh)."""
    return publish_tree(directory, tree, step, matcher)


def load_ooo_tree(directory: str, ooo, *, step=None) -> tuple[dict, int]:
    """Load and verify the latest complete snapshot for ``ooo.matcher``."""
    tree, step = restore_tree(directory, ooo.matcher, OOO_TREE_KEYS,
                              step=step)
    check_signature(tree, table_signature(ooo.matcher.packed),
                    "buffered maps are")
    dev = ooo.matcher.dev
    if int(tree["spec_r"]) != dev.spec_r or \
            int(tree["lane_width"]) != dev.i_max:
        raise ValueError(
            f"snapshot keyed at lookahead r={int(tree['spec_r'])} with lane "
            f"width S={int(tree['lane_width'])}, but the target matcher "
            f"resolved r={dev.spec_r}, S={dev.i_max}; buffered transition "
            "maps cannot be re-keyed across boundary-key spaces")
    return tree, step


def restore_streams(ooo, tree: dict) -> list:
    """Rebuild sequencers from a loaded tree into ``ooo``; returns the
    re-opened ``OooStream`` handles in snapshot (sid) order."""
    from .matcher import OooStream  # cycle: matcher imports this module

    k = ooo.matcher.packed.n_patterns
    handles = []
    for i in range(len(tree["sid"])):
        sid = int(tree["sid"][i])
        if sid in ooo._streams:
            raise ValueError(f"stream id {sid} is already open; restore "
                             "into a fresh OooStreamMatcher")
        cursor = MatchCursor(
            lane_states=np.ascontiguousarray(
                tree["states"][i, :, None], np.int32),
            entry_class=-1,
            absorbed=np.asarray(tree["absorbed"][i], bool).copy(),
            byte_count=int(tree["byte_count"][i]),
            last_class=int(tree["last_class"][i]))
        sq = Sequencer(sid, cursor, ooo.policy)
        sq.next_seq = int(tree["next_seq"][i])
        sq.segments_fed = int(tree["segments_fed"][i])
        sq.stream_fp = int(tree["stream_fp"][i])
        for j in range(int(tree["bs_off"][i]), int(tree["bs_off"][i + 1])):
            lo, hi = int(tree["bs_data_off"][j]), int(tree["bs_data_off"][j + 1])
            seg = BufferedSegment(
                seq=int(tree["bs_seq"][j]),
                n_bytes=int(tree["bs_n"][j]),
                fp=int(tree["bs_fp"][j]),
                tail=bytes(tree["bs_tail"][j, :int(tree["bs_tail_len"][j])]
                           .astype(np.uint8)),
                data=(bytes(tree["bs_data"][lo:hi].astype(np.uint8))
                      if bool(tree["bs_has_data"][j]) else None),
                entry_key=int(tree["bs_entry"][j]),
                hint_key=int(tree["bs_hint"][j]),
                lanes=(np.ascontiguousarray(tree["bs_lanes"][j], np.int32)
                       if bool(tree["bs_matched"][j]) else None))
            sq.buf.admit(seg, stream_id=sid, bypass_caps=True)
        for j in range(int(tree["dd_off"][i]), int(tree["dd_off"][i + 1])):
            sq.folded_fp[int(tree["dd_seq"][j])] = (
                int(tree["dd_fp"][j]), int(tree["dd_n"][j]))
        ooo._streams[sid] = sq
        handles.append(OooStream(sid, ooo))
    ooo._next_sid = max(ooo._next_sid, int(tree["next_sid"]))
    assert tree["states"].shape[1:] == (k,) or len(tree["sid"]) == 0
    return handles
