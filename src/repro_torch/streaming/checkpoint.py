"""Streaming failover: session snapshot/restore on the atomic checkpoint
format.

A cursor's ``[K, S]`` lane state is a *complete, composable* summary of
every byte the stream has seen (Eq. 8), so the entire per-stream state of
the runtime is one small fixed tree: cursor lane states, absorbed flags,
byte counts, boundary classes, plus any unflushed pending bytes sitting in
the admission queue.  This module packs that tree, and snapshots ride
``training/checkpoint.py``'s atomic-publish layout (writes go to
``step_<N>.tmp`` and are renamed into place), so a crashed writer never
publishes a partial snapshot and restore always finds the latest *complete*
step.

The tree is host numpy whatever the matcher's device, and its keys, dtypes
and signature are the JAX package's: a snapshot taken on the card restores
on a ``device="cpu"`` matcher or in ``repro.streaming``, and the reverse.
A snapshot is refused on restore unless its packed-table signature matches
the target matcher's: resuming a cursor against a different pattern set
would silently decode garbage states.  On a mesh-sharded matcher the
loaded tree is placed replicated on the target mesh (``reshard_tree``) and
brought back to host numpy, so a snapshot restores on any mesh shape.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch.distributed as dist

from ..core.automata import PackedDFA, packed_signature
from ..training.checkpoint import restore_checkpoint, save_checkpoint
from .cursor import MatchCursor

__all__ = ["TREE_KEYS", "table_signature", "pattern_set_signature",
           "sessions_tree", "save_sessions_tree", "load_sessions_tree",
           "unpack_cursor", "restore_tree", "publish_tree"]

# One leaf per field; the tree structure is the restore contract (the
# ``like`` argument of restore_checkpoint only needs matching keys).
TREE_KEYS = ("sig", "next_sid", "sid", "lane", "lane_width", "entry_class",
             "absorbed", "byte_count", "last_class", "segments_fed",
             "evicted", "pending", "pending_off")


def table_signature(packed: PackedDFA) -> str:
    """Content hash of the packed table a snapshot was taken against.

    Delegates to ``core.automata.packed_signature`` — which also folds in
    sinks and per-pattern offsets — so checkpoint identity, block-level
    lowering reuse and hot-swap no-op detection all agree on what "the same
    pattern set" means.  Covers only *one* packed table; a blocked pattern
    set snapshots per block with the full-set ``pattern_set_signature``
    stamped over each block's tree.
    """
    return packed_signature(packed)


def pattern_set_signature(pattern_set, prefilter=None) -> str:
    """Content hash of a full K-blocked pattern set (+ prefilter tables).

    ``table_signature`` covers exactly one packed table; a blocked
    streaming runtime snapshots one tree per block, and each block's tree
    must refuse restore when *any* part of the set changed — a hot-swapped
    sibling block, a different blocking layout, or a changed required-
    literal table would all silently re-gate or re-interpret restored
    traffic.  ``prefilter`` is the ``core.prefilter.Prefilter`` in force, or
    None when gating is off.
    """
    h = hashlib.sha1()
    h.update(f"k_blk={pattern_set.k_blk};".encode())
    for sig in pattern_set.block_signatures:
        h.update(sig.encode())
    h.update(b"|pf:")
    if prefilter is not None:
        h.update(prefilter.signature().encode())
    return h.hexdigest()


def sessions_tree(sessions, packed: PackedDFA, next_sid: int, *,
                  signature: str | None = None) -> dict:
    """Pack open sessions into the fixed checkpoint tree (pure host numpy).

    Cursor lane axes may differ (exact cursors carry S=1, candidate-keyed
    ones S=i_max); lanes pad to the widest and ``lane_width`` records each
    cursor's real width.  Pending bytes concatenate with [B+1] offsets.
    ``signature`` overrides the embedded identity (a blocked runtime stamps
    the full-set ``pattern_set_signature`` instead of this one block's).
    """
    b = len(sessions)
    k = packed.n_patterns
    s = max((sess.cursor.lane_states.shape[1] for sess in sessions),
            default=1)
    lane = np.zeros((b, k, s), np.int32)
    lane_width = np.zeros(b, np.int64)
    entry_class = np.zeros(b, np.int32)
    absorbed = np.zeros((b, k), bool)
    byte_count = np.zeros(b, np.int64)
    last_class = np.zeros(b, np.int32)
    segments_fed = np.zeros(b, np.int64)
    evicted = np.zeros(b, bool)
    sid = np.zeros(b, np.int64)
    pend: list[bytes] = []
    for i, sess in enumerate(sessions):
        cur = sess.cursor
        w = cur.lane_states.shape[1]
        lane[i, :, :w] = cur.lane_states
        lane_width[i] = w
        entry_class[i] = cur.entry_class
        absorbed[i] = cur.absorbed
        byte_count[i] = cur.byte_count
        last_class[i] = cur.last_class
        segments_fed[i] = sess.segments_fed
        evicted[i] = sess._evicted
        sid[i] = sess.sid
        pend.append(bytes(sess._pending))
    off = np.zeros(b + 1, np.int64)
    if b:
        off[1:] = np.cumsum([len(p) for p in pend])
    pending = np.frombuffer(b"".join(pend), np.uint8).copy()
    sig = signature if signature is not None else table_signature(packed)
    return {
        "sig": np.frombuffer(sig.encode(), np.uint8).copy(),
        "next_sid": np.int64(next_sid),
        "sid": sid, "lane": lane, "lane_width": lane_width,
        "entry_class": entry_class, "absorbed": absorbed,
        "byte_count": byte_count, "last_class": last_class,
        "segments_fed": segments_fed, "evicted": evicted,
        "pending": pending, "pending_off": off,
    }


def publish_tree(directory: str, tree: dict, step: int,
                 matcher=None) -> str:
    """Atomic publish through the shared checkpoint layer.  On a sharded
    matcher (every rank calls it, SPMD) the mesh's first rank writes the
    step and every rank waits for it, so a restore on any rank finds it;
    returns the published path on every rank."""
    if matcher is None or matcher.backend != "sharded":
        return save_checkpoint(directory, tree, step)
    import torch

    from ..launch.mesh import all_gather_rows, mesh_group
    mesh = matcher.executor.mesh
    path = os.path.join(directory, f"step_{step:08d}")
    if dist.get_rank(mesh_group(mesh)) == 0:
        path = save_checkpoint(directory, tree, step)
    # the barrier: no rank returns before the step is published
    all_gather_rows(mesh, torch.zeros(1, device=matcher.device))
    return path


def save_sessions_tree(directory: str, tree: dict, step: int,
                       matcher=None) -> str:
    """Atomic publish through the shared checkpoint layer
    (``publish_tree``)."""
    return publish_tree(directory, tree, step, matcher)


def check_signature(tree: dict, want: str, what: str) -> None:
    """Refuse a tree whose stamped signature is not ``want``; ``what`` names
    the state that would be misread."""
    got = bytes(tree["sig"].astype(np.uint8)).decode()
    if got != want:
        raise ValueError(
            "snapshot was taken against a different packed pattern set "
            f"(signature {got[:12]}.. != {want[:12]}..); {what} "
            "only meaningful relative to the table they were matched with")


def restore_tree(directory: str, matcher, keys, *, step=None
                 ) -> tuple[dict, int]:
    """Load a snapshot tree of ``keys`` as host numpy.  On a sharded
    matcher every leaf is placed replicated on its mesh first (the JAX
    package's ``PartitionSpec()``: snapshot trees are small host state, and
    replication is valid on every mesh shape); call it on every rank."""
    like = {key: np.zeros(0) for key in keys}
    shardings = None
    if matcher.backend == "sharded":
        from torch.distributed.tensor import Replicate
        mesh = matcher.executor.mesh
        repl = (mesh, [Replicate()] * mesh.ndim)
        shardings = {key: repl for key in keys}
    tree, step = restore_checkpoint(directory, like, step=step,
                                    shardings=shardings)
    return {key: (val.to_local().cpu().numpy() if shardings else
                  np.asarray(val)) for key, val in tree.items()}, step


def load_sessions_tree(directory: str, matcher, *, step=None,
                       expect_signature: str | None = None
                       ) -> tuple[dict, int]:
    """Load (and verify) the latest complete snapshot for ``matcher``."""
    tree, step = restore_tree(directory, matcher, TREE_KEYS, step=step)
    check_signature(tree, expect_signature if expect_signature is not None
                    else table_signature(matcher.packed),
                    "cursor states are")
    return tree, step


def unpack_cursor(tree: dict, i: int) -> MatchCursor:
    """Rebuild row ``i``'s ``MatchCursor`` from a loaded snapshot tree."""
    w = int(tree["lane_width"][i])
    return MatchCursor(
        lane_states=np.ascontiguousarray(tree["lane"][i, :, :w], np.int32),
        entry_class=int(tree["entry_class"][i]),
        absorbed=np.asarray(tree["absorbed"][i], bool).copy(),
        byte_count=int(tree["byte_count"][i]),
        last_class=int(tree["last_class"][i]))
