"""The port's checkpoints against the JAX package, on the CPU.

``repro_torch.training.checkpoint`` (the atomic-publish format, its pytree
keys, the msgpack manifest, bfloat16 leaves, the async saver and keep-last-K)
and the session snapshots that ride it: ``StreamMatcher``,
``BlockedStreamMatcher`` and ``OooStreamMatcher`` ``snapshot``/``restore``.
The same seeded traffic goes through both packages — JAX on
``backend="local"`` (and ``"pallas"``, interpret mode, in one case), the port
on ``device="cpu"`` for ``local`` and ``cuda`` (the kernels' plain versions) —
and snapshots cross between the packages in both directions.  Mirrors the
snapshot rows of tests/test_fault_tolerance.py and tests/test_ooo.py (not
the sharded ones).  Every leaf is an integer, a bool or a raw float bit
pattern, so every comparison is exact; refusals must give the JAX package's
messages.
"""

import collections
import os
import random

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Matcher as JMatcher
from repro.core import PatternSet as JPatternSet
from repro.core import compile_regex as j_compile_regex
from repro.core import make_search_dfa as j_make_search_dfa
from repro.streaming import BlockedStreamMatcher as JBlockedStreamMatcher
from repro.streaming import OooPolicy as JOooPolicy
from repro.streaming import OooStreamMatcher as JOooStreamMatcher
from repro.streaming import StreamMatcher as JStreamMatcher
from repro.streaming import TickPolicy as JTickPolicy
from repro.streaming import sessions_tree as j_sessions_tree
from repro.streaming.ooo.checkpoint import ooo_tree as j_ooo_tree
from repro.training import checkpoint as jckpt
from repro_torch.core import (Matcher, PatternSet, compile_regex,
                              make_search_dfa)
from repro_torch.streaming import (BlockedStreamMatcher, OooPolicy,
                                   OooStreamMatcher, StreamMatcher,
                                   TickPolicy, sessions_tree)
from repro_torch.streaming.checkpoint import TREE_KEYS
from repro_torch.streaming.ooo.checkpoint import OOO_TREE_KEYS, ooo_tree
from repro_torch.training import checkpoint as ckpt

PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = np.frombuffer(b"abxy0189", np.uint8)
LAZY = TickPolicy(max_batch=1 << 30, max_delay=1 << 30)  # explicit flush
JLAZY = JTickPolicy(max_batch=1 << 30, max_delay=1 << 30)
BACKENDS = ["local", "cuda"]
NT = collections.namedtuple("NT", "mu nu")


def _tdfas(patterns=PATTERNS):
    return [make_search_dfa(compile_regex(p)) for p in patterns]


def _jdfas(patterns=PATTERNS):
    return [j_make_search_dfa(j_compile_regex(p)) for p in patterns]


def _tmatcher(backend="local", **kw):
    kw = {"num_chunks": 4, "batch_tile": 8, **kw}
    return Matcher(_tdfas(), backend=backend, device="cpu", **kw)


def _jmatcher(backend="local", **kw):
    kw = {"num_chunks": 4, "batch_tile": 8, **kw}
    return JMatcher(_jdfas(), backend=backend, **kw)


def _docs(seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.choice(ALPHABET, size=size).tobytes() for _ in range(n)]


def _trees_equal(got, want, keys):
    assert set(got) == set(want) == set(keys)
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# --------------------------------------------------------------------------
# training/checkpoint: keys, leaves, bf16, the manifest, async, keep-last-K
# --------------------------------------------------------------------------

def _tree(seed, device="cpu"):
    """A nested tree of torch and numpy leaves (int32, bool, f32, bf16)."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal(7).astype(np.float32)
    return {
        "w": torch.from_numpy(f32).to(device),
        "b": [torch.from_numpy(bf).to(device).bfloat16(),
              (np.arange(6, dtype=np.int32).reshape(2, 3), None)],
        "opt": NT(mu=torch.from_numpy(rng.random(4) < 0.5).to(device),
                  nu=rng.integers(-9, 9, size=(2, 2)).astype(np.int32)),
        "c": {"z": torch.tensor(7, dtype=torch.int32), "y": np.float32(1.5),
              "x": torch.tensor(2.5, device=device).bfloat16(),
              "t": torch.from_numpy(f32).to(device).bfloat16().t()},
        "skip": None,
    }


def _bits(x):
    """The raw bit pattern of a leaf of either package, as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V" or x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x


def _leaf_bits(tree):
    return {k: _bits(v) for k, v in ckpt._leaves(tree)}


def test_checkpoint_roundtrip_nested_tree(tmp_path):
    tree = _tree(1)
    path = ckpt.save_checkpoint(str(tmp_path), tree, 4)
    assert path == os.path.join(str(tmp_path), "step_00000004")
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.msgpack"]
    out, step = ckpt.restore_checkpoint(str(tmp_path), _tree(2))
    assert step == 4 and out["skip"] is None
    assert isinstance(out["opt"], NT) and isinstance(out["b"][1], tuple)
    for (k, got), (_, like) in zip(ckpt._leaves(out), ckpt._leaves(tree)):
        if isinstance(like, torch.Tensor):
            assert isinstance(got, torch.Tensor), k
            assert (got.dtype, got.device) == (like.dtype, like.device), k
        else:
            assert isinstance(got, np.ndarray), k
        np.testing.assert_array_equal(_bits(got), _bits(like), err_msg=k)


def test_checkpoint_keys_equal_the_reference():
    tree = _tree(3)
    ref = {k: v for k, v in tree.items()}
    ref["w"] = ref["w"].numpy()
    ref["b"] = [np.asarray(tree["b"][0].float()), tree["b"][1]]
    ref["opt"] = NT(mu=tree["opt"].mu.numpy(), nu=tree["opt"].nu)
    ref["c"] = {"z": 7, "y": np.float32(1.5), "x": 2.5,
                "t": np.zeros((5, 3))}
    ref["od"] = collections.OrderedDict([("q", 1), ("a", 2)])
    tree["od"] = collections.OrderedDict([("q", 1), ("a", 2)])
    want = list(jckpt._flatten(ref))
    assert [k for k, _ in ckpt._leaves(tree)] == want
    assert want == ["b/0", "b/1/0", "c/t", "c/x", "c/y", "c/z", "od/q",
                    "od/a", "opt/.mu", "opt/.nu", "w"]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(5)
    ckpt.save_checkpoint(str(tmp_path), tree, 2)
    out, step = jckpt.restore_checkpoint(
        str(tmp_path), {"w": 0, "b": [0, (0, None)], "opt": NT(0, 0),
                        "c": {"z": 0, "y": 0, "x": 0, "t": 0}, "skip": None})
    assert step == 2
    assert out["b"][0].dtype == np.dtype("V2")   # what np.savez made of bf16
    got = {k: _bits(v) for k, v in
           zip((k for k, _ in ckpt._leaves(tree)),
               (v for _, v in ckpt._leaves(out)))}
    for k, want in _leaf_bits(tree).items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    # bfloat16 bit for bit, read back as ml_dtypes' bfloat16
    np.testing.assert_array_equal(
        out["b"][0].view(ml_dtypes.bfloat16).astype(np.float32),
        tree["b"][0].float().numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(6)
    f32 = rng.standard_normal((4, 3)).astype(np.float32)
    bf = jnp.asarray(rng.standard_normal(9), jnp.bfloat16)
    jtree = {"w": jnp.asarray(f32), "b": [bf, (np.arange(5, dtype=np.int32),
                                              None)],
             "m": NT(mu=np.array([True, False]), nu=np.int32(3))}
    jckpt.save_checkpoint(str(tmp_path), jtree, 9)
    like = {"w": torch.zeros(0), "b": [torch.zeros(0, dtype=torch.bfloat16),
                                       (torch.zeros(0, dtype=torch.int32),
                                        None)],
            "m": NT(mu=torch.zeros(0, dtype=torch.bool), nu=np.zeros(0))}
    out, step = ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 9
    assert out["b"][0].dtype == torch.bfloat16 and out["b"][0].shape == (9,)
    np.testing.assert_array_equal(_bits(out["b"][0]),
                                  np.asarray(bf).view(np.uint16))
    np.testing.assert_array_equal(out["w"].numpy(), f32)
    np.testing.assert_array_equal(out["b"][1][0].numpy(), np.arange(5))
    assert out["m"].mu.tolist() == [True, False] and int(out["m"].nu) == 3


def test_checkpoint_ignores_tmp_and_stray_entries(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, {"x": np.zeros(0)})
    ckpt.save_checkpoint(d, {"x": np.zeros(2)}, 3)
    os.makedirs(tmp_path / "step_00000009.tmp")   # crashed writer
    (tmp_path / "step_00000009.tmp" / "arrays.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_notanumber")     # stray dir
    assert ckpt.latest_step(d) == 3
    (tmp_path / "step_8").mkdir()                 # unpadded but numeric
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 8
    assert [ckpt._step_of(n) for n in ("step_00000009.tmp", "step_x",
                                       "other", "step_12")] == \
        [None, None, None, 12]


def test_checkpoint_manager_keep_last_k_and_async(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2, use_async=True)
    t = torch.arange(6, dtype=torch.float32)
    b = t.bfloat16()
    for step in range(1, 5):
        mgr.save({"t": t, "b": b}, step)
        before = (t.clone(), b.clone())
        t.add_(1)          # in place, right after submit: must not reach
        b.add_(1)          # the file being written
    mgr.wait()
    mgr._gc()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    out, step = mgr.restore({"t": torch.zeros(0),
                             "b": torch.zeros(0, dtype=torch.bfloat16)})
    assert step == 4
    assert torch.equal(out["t"], before[0]) and torch.equal(out["b"],
                                                            before[1])
    with pytest.raises(NotImplementedError, match="A14"):
        mgr.restore({"t": torch.zeros(0)}, shardings={"t": None})


MSGPACK_OBJECTS = [
    0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
    (1 << 64) - 1, 1.5, -0.0, "", "a" * 31, "a" * 32, "b" * 255, "c" * 256,
    "d" * 70000, list(range(15)), list(range(16)), ["k"] * 70000,
    {"step": 3, "time": 1.25, "keys": ["a", "b/0", "c/.mu"]},
    {str(i): i for i in range(15)},
]


@pytest.mark.parametrize("obj", MSGPACK_OBJECTS,
                         ids=[f"obj{i}" for i in range(len(MSGPACK_OBJECTS))])
def test_manifest_encoder_equals_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    got = ckpt._packb(obj)
    assert got == msgpack.packb(obj)
    assert ckpt._unpackb(got) == msgpack.unpackb(got)


@pytest.mark.parametrize("obj", [-1, True, None, {str(i): i
                                                  for i in range(16)}],
                         ids=["negative", "bool", "none", "map16"])
def test_manifest_encoder_refuses_outside_its_subset(obj):
    with pytest.raises(TypeError, match="subset"):
        ckpt._packb(obj)


def test_manifest_reads_in_both_packages(tmp_path):
    msgpack = pytest.importorskip("msgpack")
    keys = [k for k, _ in ckpt._leaves(_tree(7))]
    path = ckpt.save_checkpoint(str(tmp_path / "port"), _tree(7), 12)
    raw = open(os.path.join(path, "manifest.msgpack"), "rb").read()
    got = ckpt._unpackb(raw)
    assert got == msgpack.unpackb(raw)
    assert set(got) == {"step", "time", "keys"}
    assert got["step"] == 12 and got["keys"] == sorted(keys)
    assert isinstance(got["time"], float)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"),
                                  {"a": np.zeros(2), "b": [np.ones(1)] * 20},
                                  70000)
    jraw = open(os.path.join(jpath, "manifest.msgpack"), "rb").read()
    jgot = ckpt._unpackb(jraw)
    assert jgot == msgpack.unpackb(jraw)
    assert jgot["step"] == 70000 and len(jgot["keys"]) == 21
    assert ckpt._packb(jgot) == jraw


# --------------------------------------------------------------------------
# session trees: the same traffic gives the same tree in both packages
# --------------------------------------------------------------------------

def _in_order_half(sm, docs, keyed):
    """Exact sessions over ``docs`` (a tick, then a pending segment) and
    candidate-keyed ones over ``keyed`` = [(key, body)]."""
    exact = [sm.open() for _ in docs]
    for s, d in zip(exact, docs):
        s.feed(d[:16])
    lanes = [sm.open_at(key) for key, _ in keyed]
    for s, (_, body) in zip(lanes, keyed):
        s.feed(body[:12])
    sm.flush()
    for s, d in zip(exact, docs):
        s.feed(d[16:32])          # pending at snapshot time
    for s, (_, body) in zip(lanes, keyed):
        s.feed(body[12:20])
    return exact, lanes


def _in_order_rest(sm, exact, lanes, docs, keyed):
    for s, d in zip(exact, docs):
        s.feed(d[32:])
    for s, (_, body) in zip(lanes, keyed):
        s.feed(body[20:])
    sm.flush()
    res = [s.close() for s in exact]
    maps = [sm.close_map(s) for s in lanes]
    return (np.stack([r.final_states for r in res]),
            [r.byte_count for r in res], [r.segments_fed for r in res],
            np.stack([m.lane_states for m in maps]))


def _keyed(m, docs):
    return [(m.dev.advance_key(-1, d[:20]), d[20:]) for d in docs]


@pytest.mark.parametrize("backend", BACKENDS)
def test_sessions_tree_equals_the_reference(backend):
    docs, kdocs = _docs(11, 4, 48), _docs(12, 3, 60)
    jsm = JStreamMatcher(_jmatcher(), policy=JLAZY, lane_ticks=True)
    sm = StreamMatcher(_tmatcher(backend), policy=LAZY, lane_ticks=True)
    assert _keyed(sm.matcher, kdocs) == _keyed(jsm.matcher, kdocs)
    je, jl = _in_order_half(jsm, docs, _keyed(jsm.matcher, kdocs))
    te, tl = _in_order_half(sm, docs, _keyed(sm.matcher, kdocs))
    jt = j_sessions_tree(je + jl, jsm.matcher.packed, jsm._next_sid)
    tt = sessions_tree(te + tl, sm.matcher.packed, sm._next_sid)
    _trees_equal(tt, jt, TREE_KEYS)
    assert int(tt["pending_off"][-1]) == 4 * 16 + 3 * 8
    assert tt["lane"].shape[2] == sm.matcher.dev.i_max


def _ooo_plan(seed, n_segs=12, seg=6):
    rng = random.Random(seed)
    doc = bytes(rng.choice(list(ALPHABET)) for _ in range(n_segs * seg))
    segs = [doc[i * seg:(i + 1) * seg] for i in range(n_segs)]
    return doc, segs


def _ooo_half(ooo, docs_segs):
    """Segment 0, then every odd segment; a quarter carry ``prev_tail``
    hints, so the parks mix matched maps and raw payloads; duplicate
    deliveries fill the dedup window."""
    streams = [ooo.open() for _ in docs_segs]
    for s, (doc, segs) in zip(streams, docs_segs):
        s.feed(0, segs[0])
        for i in range(1, len(segs), 2):
            hint = doc[i * 6 - 2:i * 6] if i % 4 == 1 else None
            s.feed(i, segs[i], prev_tail=hint)
        s.feed(3, segs[3])          # duplicate deliveries
        s.feed(0, segs[0])
    ooo.flush()
    return streams


def _ooo_rest(streams, docs_segs):
    for s, (_, segs) in zip(streams, docs_segs):
        for i in range(2, len(segs), 2):
            s.feed(i, segs[i])
    return [s.close() for s in streams]


@pytest.mark.parametrize("backend", BACKENDS)
def test_ooo_tree_equals_the_reference(backend):
    plan = [_ooo_plan(s) for s in (21, 22, 23)]
    jooo = JOooStreamMatcher(_jmatcher(), policy=JOooPolicy(match_batch=64))
    ooo = OooStreamMatcher(_tmatcher(backend),
                           policy=OooPolicy(match_batch=64))
    _ooo_half(jooo, plan)
    _ooo_half(ooo, plan)
    jt, tt = j_ooo_tree(jooo), ooo_tree(ooo)
    _trees_equal(tt, jt, OOO_TREE_KEYS)
    assert tt["bs_matched"].any() and not tt["bs_matched"].all()
    assert len(tt["dd_seq"]) > 0


# --------------------------------------------------------------------------
# StreamMatcher snapshot/restore (mirrors tests/test_fault_tolerance.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [("local", "local"), ("local", "cuda"),
                                     ("cuda", "local")])
def test_snapshot_restore_roundtrip(tmp_path, src, dst):
    docs, kdocs = _docs(3, 5, 48), _docs(4, 2, 60)
    sm = StreamMatcher(_tmatcher(src), policy=LAZY, lane_ticks=True)
    keyed = _keyed(sm.matcher, kdocs)
    exact, lanes = _in_order_half(sm, docs, keyed)
    want = _in_order_rest(sm, exact, lanes, docs, keyed)
    sm = StreamMatcher(_tmatcher(src), policy=LAZY, lane_ticks=True)
    exact, lanes = _in_order_half(sm, docs, keyed)
    assert sm.snapshot(str(tmp_path)) == os.path.join(str(tmp_path),
                                                      "step_00000000")
    sm2 = StreamMatcher(_tmatcher(dst), policy=LAZY, lane_ticks=True)
    restored = {s.sid: s for s in sm2.restore(str(tmp_path))}
    exact2 = [restored[s.sid] for s in exact]
    lanes2 = [restored[s.sid] for s in lanes]
    assert all(s.pending_bytes == 16 for s in exact2)
    assert sm2.stats.feeds == 0          # re-admission is no feed event
    got = _in_order_rest(sm2, exact2, lanes2, docs, keyed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        got[0], _tmatcher().membership_batch(docs).final_states)
    assert got[1] == [len(d) for d in docs] == want[1]
    assert got[2] == [3] * len(docs)     # 2 before the snapshot + 1 after
    np.testing.assert_array_equal(got[3], want[3])
    assert sm2.snapshot(str(tmp_path)).endswith("step_00000001")


def test_restore_ignores_crashed_writer_tmp(tmp_path):
    sm = StreamMatcher(_tdfas(), policy=LAZY, device="cpu")
    s = sm.open()
    s.feed(b"ba")
    sm.snapshot(str(tmp_path))
    # a writer that died mid-publish leaves step_<N>.tmp; restore skips it
    os.makedirs(tmp_path / "step_00000099.tmp")
    (tmp_path / "step_00000099.tmp" / "arrays.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_junk")  # stray non-numeric dir tolerated
    sm2 = StreamMatcher(_tdfas(), policy=LAZY, device="cpu")
    restored = sm2.restore(str(tmp_path))
    assert len(restored) == 1 and restored[0].pending_bytes == 2
    assert restored[0].close().byte_count == 2


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_refusals_give_the_reference_messages(tmp_path):
    """A foreign pattern set, a sid collision and (OOO) a lookahead depth
    mismatch: the same refusal text in both packages."""
    d = str(tmp_path)
    sm = StreamMatcher(_tdfas(), policy=LAZY, device="cpu")
    sm.open().feed(b"ab")
    sm.snapshot(d)
    zz = ".*zz"
    got = _message(lambda: StreamMatcher(_tdfas([zz]), policy=LAZY,
                                         device="cpu").restore(d))
    want = _message(lambda: JStreamMatcher(_jdfas([zz]),
                                           policy=JLAZY).restore(d))
    assert got == want and "different packed pattern set" in got
    sm2 = StreamMatcher(_tdfas(), policy=LAZY, device="cpu")
    sm2.open()
    jsm2 = JStreamMatcher(_jdfas(), policy=JLAZY)
    jsm2.open()
    got, want = _message(lambda: sm2.restore(d)), _message(
        lambda: jsm2.restore(d))
    assert got == want and "already open" in got
    od = str(tmp_path / "ooo")
    ooo = OooStreamMatcher(_tmatcher(lookahead_r=2))
    ooo.open().feed(1, b"ab")
    ooo.snapshot(od)
    got = _message(lambda: OooStreamMatcher(
        _tmatcher(lookahead_r=1)).restore(od))
    want = _message(lambda: JOooStreamMatcher(
        _jmatcher(lookahead_r=1)).restore(od))
    assert got == want and "re-keyed" in got
    got = _message(lambda: OooStreamMatcher(Matcher(
        _tdfas([zz]), device="cpu")).restore(od))
    want = _message(lambda: JOooStreamMatcher(JMatcher(
        _jdfas([zz]))).restore(od))
    assert got == want and "buffered maps are" in got


def test_restore_continues_sid_allocation(tmp_path):
    sm = StreamMatcher(_tdfas(), policy=LAZY, device="cpu")
    for _ in range(3):
        sm.open()
    sm.snapshot(str(tmp_path))
    sm2 = StreamMatcher(_tdfas(), policy=LAZY, device="cpu")
    sm2.restore(str(tmp_path))
    assert sm2.open().sid == 3  # never re-issues a restored sid


def test_restore_refused_after_hot_swap(tmp_path):
    sm = StreamMatcher(_tdfas(), policy=LAZY, device="cpu")
    s = sm.open()
    s.feed(b"abba")
    sm.flush()
    sm.snapshot(str(tmp_path))
    assert sm.swap_patterns(_tdfas([".*zz[0-9]+"])) is True
    with pytest.raises(ValueError, match="different packed pattern set"):
        sm.restore(str(tmp_path))


# --------------------------------------------------------------------------
# BlockedStreamMatcher
# --------------------------------------------------------------------------

BLOCKED = {"a": "ab+", "b": "[0-9]x", "c": "yy", "d": "x+y"}


def test_blocked_restore_refused_after_sibling_block_swap(tmp_path):
    ps = PatternSet(BLOCKED, k_blk=2, search=True)
    sm = BlockedStreamMatcher(ps, policy=LAZY, num_chunks=4, device="cpu")
    s = sm.open()
    s.feed(b"abb 3x")
    sm.flush()
    sm.snapshot(str(tmp_path))
    info = sm.swap_patterns(ps.with_patterns({"d": "qq+"}))
    assert info["reused"] == [0] and info["rebuilt"] == [1]
    fresh = BlockedStreamMatcher(sm.blocked, policy=LAZY)
    with pytest.raises(ValueError, match="different packed pattern set"):
        fresh.restore(str(tmp_path))
    back = BlockedStreamMatcher(ps, policy=LAZY, num_chunks=4, device="cpu")
    (sess,) = back.restore(str(tmp_path))
    sess.feed(b"y")
    res = sess.close()
    assert res.byte_count == 7
    assert res.accepted.tolist() == [True, True, False, True]


def test_blocked_snapshot_covers_prefilter_tables(tmp_path):
    ps = PatternSet({"a": "abc", "b": "def"}, k_blk=1, search=True)
    sm_on = BlockedStreamMatcher(ps, policy=LAZY, prefilter=True,
                                 device="cpu")
    sm_off = BlockedStreamMatcher(ps, policy=LAZY, prefilter=False,
                                  device="cpu")
    s = sm_on.open()
    s.feed(b"ab")
    sm_on.flush()
    sm_on.snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="different packed pattern set"):
        sm_off.restore(str(tmp_path))


def test_blocked_restore_refuses_a_stream_missing_from_a_block(tmp_path):
    ps = PatternSet(BLOCKED, k_blk=2, search=True)
    sm = BlockedStreamMatcher(ps, policy=LAZY, device="cpu")
    sm.open().feed(b"ab")
    sm.snapshot(str(tmp_path))
    # a later step of block 1 alone, holding no stream: the latest steps of
    # the two blocks disagree on the stream set
    other = StreamMatcher(sm._sms[1].matcher, policy=LAZY)
    other.snapshot_signature = sm._sms[1].snapshot_signature
    other.snapshot(str(tmp_path / "block_001"), step=5)
    with pytest.raises(ValueError, match=r"stream 0 is missing from "
                                         r"block\(s\) \[1\]"):
        BlockedStreamMatcher(ps, policy=LAZY, device="cpu").restore(
            str(tmp_path))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_blocked_snapshot_crosses_packages(tmp_path, direction):
    docs = _docs(31, 4, 40)
    tps = PatternSet(BLOCKED, k_blk=2, search=True)
    jps = JPatternSet(BLOCKED, k_blk=2, search=True)
    make_t = lambda: BlockedStreamMatcher(tps, policy=LAZY,  # noqa: E731
                                          num_chunks=4, device="cpu")
    make_j = lambda: JBlockedStreamMatcher(jps, policy=JLAZY,  # noqa: E731
                                           num_chunks=4)
    src, dst = ((make_j, make_t) if direction == "jax_to_port"
                else (make_t, make_j))
    sm = src()
    sessions = [sm.open() for _ in docs]
    for s, d in zip(sessions, docs):
        s.feed(d[:20])
    sm.flush()
    for s, d in zip(sessions, docs):
        s.feed(d[20:30])
    sm.snapshot(str(tmp_path))
    sm2 = dst()
    restored = {s.sid: s for s in sm2.restore(str(tmp_path))}
    got = []
    for s, d in zip(sessions, docs):
        r = restored[s.sid]
        r.feed(d[30:])
        got.append(r.close())
    want = []
    for s, d in zip(sessions, docs):
        s.feed(d[30:])
        want.append(s.close())
    for g, w, d in zip(got, want, docs):
        np.testing.assert_array_equal(g.final_states, w.final_states)
        np.testing.assert_array_equal(g.accepted, w.accepted)
        assert g.byte_count == w.byte_count == len(d)


# --------------------------------------------------------------------------
# OooStreamMatcher (mirrors tests/test_ooo.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [("local", "local"), ("local", "cuda"),
                                     ("cuda", "local"), ("cuda", "tree")])
def test_ooo_snapshot_restore_mid_reorder(tmp_path, src, dst):
    plan = [_ooo_plan(s) for s in (41, 42)]
    m1 = _tmatcher(src)
    ooo = OooStreamMatcher(m1, policy=OooPolicy(match_batch=64))
    streams = _ooo_half(ooo, plan)
    assert all(s.buffered_segments > 0 for s in streams)
    ooo.snapshot(str(tmp_path))
    m2 = _tmatcher("cuda" if dst == "tree" else dst)
    if dst == "tree":
        m2.executor.compose_mode = "tree"
    ooo2 = OooStreamMatcher(m2, policy=ooo.policy)
    restored = ooo2.restore(str(tmp_path))
    assert [(s.sid, s.next_seq, s.buffered_segments) for s in restored] == \
        [(s.sid, s.next_seq, s.buffered_segments) for s in streams]
    r2 = _ooo_rest(restored, plan)
    r1 = _ooo_rest(streams, plan)
    want = m1.membership_batch([d for d, _ in plan]).final_states
    for a, b, w, (doc, _) in zip(r1, r2, want, plan):
        np.testing.assert_array_equal(a.final_states, w)
        np.testing.assert_array_equal(b.final_states, w)
        assert a.byte_count == b.byte_count == len(doc)
    assert ooo2.open().sid == len(plan)


def test_ooo_restore_refuses_foreign_tables(tmp_path):
    ooo = OooStreamMatcher(_tmatcher())
    ooo.open().feed(1, b"ab")
    ooo.snapshot(str(tmp_path))
    other = Matcher(_tdfas([".*zz"]), backend="local", batch_tile=8,
                    device="cpu")
    with pytest.raises(ValueError, match="different packed pattern set"):
        OooStreamMatcher(other).restore(str(tmp_path))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ooo_snapshot_crosses_packages(tmp_path, direction):
    plan = [_ooo_plan(s) for s in (51, 52, 53)]
    pol, jpol = OooPolicy(match_batch=64), JOooPolicy(match_batch=64)
    if direction == "jax_to_port":
        src = JOooStreamMatcher(_jmatcher(), policy=jpol)
        dst = OooStreamMatcher(_tmatcher("cuda"), policy=pol)
    else:
        src = OooStreamMatcher(_tmatcher("cuda"), policy=pol)
        dst = JOooStreamMatcher(_jmatcher(), policy=jpol)
    streams = _ooo_half(src, plan)
    src.snapshot(str(tmp_path))
    got = _ooo_rest(dst.restore(str(tmp_path)), plan)
    want = _ooo_rest(streams, plan)
    for g, w, (doc, _) in zip(got, want, plan):
        np.testing.assert_array_equal(g.final_states, w.final_states)
        assert g.byte_count == w.byte_count == len(doc)


# --------------------------------------------------------------------------
# StreamMatcher across packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jax_backend,port_backend",
                         [("local", "local"), ("local", "cuda"),
                          ("pallas", "cuda")])
def test_jax_snapshot_restores_in_the_port(tmp_path, jax_backend,
                                           port_backend):
    docs, kdocs = _docs(61, 3, 40), _docs(62, 2, 44)
    jsm = JStreamMatcher(_jmatcher(jax_backend), policy=JLAZY,
                         lane_ticks=True)
    keyed = _keyed(jsm.matcher, kdocs)
    je, jl = _in_order_half(jsm, docs, keyed)
    jsm.snapshot(str(tmp_path))
    sm = StreamMatcher(_tmatcher(port_backend), policy=LAZY, lane_ticks=True)
    restored = {s.sid: s for s in sm.restore(str(tmp_path))}
    got = _in_order_rest(sm, [restored[s.sid] for s in je],
                         [restored[s.sid] for s in jl], docs, keyed)
    want = _in_order_rest(jsm, je, jl, docs, keyed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_port_snapshot_restores_in_jax(tmp_path):
    docs, kdocs = _docs(71, 3, 40), _docs(72, 2, 44)
    sm = StreamMatcher(_tmatcher("cuda"), policy=LAZY, lane_ticks=True)
    keyed = _keyed(sm.matcher, kdocs)
    te, tl = _in_order_half(sm, docs, keyed)
    sm.snapshot(str(tmp_path))
    jsm = JStreamMatcher(_jmatcher(), policy=JLAZY, lane_ticks=True)
    restored = {s.sid: s for s in jsm.restore(str(tmp_path))}
    got = _in_order_rest(jsm, [restored[s.sid] for s in te],
                         [restored[s.sid] for s in tl], docs, keyed)
    want = _in_order_rest(sm, te, tl, docs, keyed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
