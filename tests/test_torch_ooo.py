"""The port's out-of-order ingestion tier (``repro_torch.streaming.ooo``).

Counterparts of the non-sharded tests of ``tests/test_ooo.py`` on the port's ``Matcher`` (``device="cpu"``: the
``"cuda"`` backend then runs the kernels' plain versions), plus one test
that feeds the same arrival plan to the JAX and the port
``OooStreamMatcher`` and requires equal decisions, byte counts and
``OooStats``.  Every decision is int32 state ids: the tolerance is zero.
The port's own host-merge counter (``repro_torch.streaming.merge_calls``)
must stay flat on the data path.
"""

import dataclasses
import random

import numpy as np
import pytest

import repro.core as jcore
from repro.streaming import OooPolicy as JOooPolicy
from repro.streaming import OooStreamMatcher as JOooStreamMatcher

import repro_torch.core as tcore
from repro_torch.core.lvector import merge_scan_lanes_torch
from repro_torch.kernels import ref as kref
from repro_torch.streaming import (OooPolicy, OooStreamMatcher,
                                   SequenceGapError, merge_calls,
                                   segment_result)
from repro_torch.streaming.ooo import (FP_MOD, OooIntegrityError,
                                       ReorderBufferFull,
                                       compose_fingerprints,
                                       segment_fingerprint)
from repro_torch.streaming.ooo.fingerprint import FingerprintWindow

PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = list(b"abxy0189")
BACKENDS = ["local", "cuda"]


def _matcher(backend="local", **kw):
    dfas = [tcore.make_search_dfa(tcore.compile_regex(p)) for p in PATTERNS]
    return tcore.Matcher(dfas, backend=backend, batch_tile=8, device="cpu",
                         **kw)


def _doc(rng, n):
    return bytes(rng.choice(ALPHABET) for _ in range(n))


def _segments(rng, doc, *, max_seg=7, with_empty=True):
    segs, i = [], 0
    while i < len(doc):
        n = rng.randint(1, max_seg)
        segs.append(doc[i:i + n])
        i += n
    if with_empty and rng.random() < 0.5:
        segs.insert(rng.randint(0, len(segs)), b"")
    assert b"".join(segs) == doc
    return segs


def _offsets(segs):
    return np.concatenate([[0], np.cumsum([len(s) for s in segs])]).astype(int)


def _oracle(m, doc):
    starts = m.packed.starts.astype(np.int32)[None]
    return m.advance_segments([doc], starts).final_states[0]


def _feed_permuted(ooo, segs, doc, order, rng, *, hints, dup_rate=0.0):
    s = ooo.open()
    offs = _offsets(segs)
    for i in order:
        tail = doc[max(0, offs[i] - 2):offs[i]] if hints else None
        s.feed(i, segs[i], prev_tail=tail)
        if dup_rate and rng.random() < dup_rate:
            s.feed(i, segs[i], prev_tail=tail)
    return s


# --------------------------------------------------------------------------
# the scan-compose primitive
# --------------------------------------------------------------------------

def test_scan_compose_matches_sequential_ref():
    m = _matcher("local")
    dev, t = m.dev, m.dev.tables
    rng = random.Random(7)
    for _ in range(10):
        doc = _doc(rng, rng.randint(8, 40))
        offs = list(range(4, len(doc), 4))
        segs = [doc[a:b] for a, b in zip([0] + offs, offs + [len(doc)])]
        maps, keys = [], []
        for i in range(1, len(segs)):
            cls = dev.advance_key(-1, doc[offs[i - 1] - 2:offs[i - 1]])
            assert cls >= 0
            r = segment_result(dev, segs[i], cls)
            maps.append(np.broadcast_to(
                r.lane_states, (m.packed.n_patterns, t.i_max)))
            keys.append(cls)
        if not maps:
            continue
        lanes = np.stack(maps)[None].astype(np.int32)
        ks = np.array(keys, np.int32)[None]
        ref = kref.spec_merge_lanes_scan_ref(
            lanes, ks, np.asarray(t.cand_index), np.asarray(m.packed.sinks),
            pad_cls=dev.pad_key)
        out = merge_scan_lanes_torch(lanes, ks, dev.cidx_pad_t, dev.sinks_t,
                                     pad_key=dev.pad_key, axis=1).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compose_lane_maps_one_dispatch_equals_whole_doc(backend):
    m = _matcher(backend)
    dev = m.dev
    rng = random.Random(3)
    for _ in range(5):
        doc = _doc(rng, rng.randint(12, 50))
        segs = [doc[i:i + 4] for i in range(0, len(doc), 4)]
        n, k, s = len(segs), m.packed.n_patterns, dev.i_max
        lanes = np.zeros((1, n, k, s), np.int32)
        keys = np.full((1, n), dev.pad_key, np.int32)
        seed = m.advance_segments(
            [segs[0]], m.packed.starts.astype(np.int32)[None])
        lanes[0, 0] = seed.final_states[0][:, None]
        for i in range(1, n):
            cls = dev.advance_key(-1, doc[4 * i - 2:4 * i])
            r = segment_result(dev, segs[i], cls)
            lanes[0, i] = np.broadcast_to(r.lane_states, (k, s))
            keys[0, i] = cls
        before = m.compose_calls
        out = m.compose_lane_maps(lanes, keys)
        assert m.compose_calls == before + 1
        np.testing.assert_array_equal(out[0, :, 0], _oracle(m, doc))
    assert m.perf_report()["compose_lowering"] == (
        "compose-scan" if backend == "local" else "compose-kernel-carry")


# --------------------------------------------------------------------------
# permutation bit-identity, both backends
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_permutation_bit_identity(backend):
    m = _matcher(backend)
    ooo = OooStreamMatcher(m, policy=OooPolicy(match_batch=4))
    rng = random.Random(11)
    base = merge_calls()
    for trial in range(6):
        doc = _doc(rng, rng.randint(0, 48))
        segs = _segments(rng, doc)
        order = list(range(len(segs)))
        rng.shuffle(order)
        s = _feed_permuted(ooo, segs, doc, order, rng,
                           hints=(trial % 2 == 0), dup_rate=0.3)
        res = s.close()
        np.testing.assert_array_equal(res.final_states, _oracle(m, doc))
        np.testing.assert_array_equal(
            res.accepted, m.packed.accepting[_oracle(m, doc)])
        assert res.byte_count == len(doc)
    assert merge_calls() == base, "host-side merge on the ooo data path"
    assert ooo.stats.scan_folds <= ooo.stats.gap_closes
    assert ooo.stats.scan_folds > 0 and m.compose_calls > 0


def test_property_permutations_and_duplicates():
    """Hypothesis property when installed; the seeded sweep always runs."""
    m = _matcher("local")

    def run_case(doc, cuts, order_seed, dup_every):
        segs = [doc[a:b] for a, b in zip([0] + cuts, cuts + [len(doc)])]
        order = list(range(len(segs)))
        random.Random(order_seed).shuffle(order)
        ooo = OooStreamMatcher(m)
        s = ooo.open()
        offs = _offsets(segs)
        for j, i in enumerate(order):
            tail = doc[max(0, offs[i] - 2):offs[i]] if i % 2 else None
            s.feed(i, segs[i], prev_tail=tail)
            if dup_every and j % dup_every == 0:
                s.feed(i, segs[i])
        ooo.flush()
        fp = ooo._streams[s.sid].stream_fp
        res = s.close()
        np.testing.assert_array_equal(res.final_states, _oracle(m, doc))
        assert compose_fingerprints(
            fp, segment_fingerprint(b""), 0) == fp
        return res

    rng = random.Random(23)
    for _ in range(8):
        doc = _doc(rng, rng.randint(0, 40))
        cuts = sorted(rng.sample(range(len(doc) + 1),
                                 min(len(doc), rng.randint(0, 6))))
        run_case(doc, cuts, rng.randint(0, 999), rng.choice([0, 2, 3]))

    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=30, deadline=None)
    @given(doc=st.binary(max_size=32).map(
               lambda b: bytes(ALPHABET[x % len(ALPHABET)] for x in b)),
           data=st.data())
    def prop(doc, data):
        cuts = sorted(data.draw(st.lists(
            st.integers(0, len(doc)), max_size=5)))
        run_case(doc, cuts, data.draw(st.integers(0, 10_000)),
                 data.draw(st.sampled_from([0, 2])))

    prop()


def test_stream_fingerprint_matches_whole_doc():
    m = _matcher("local")
    ooo = OooStreamMatcher(m)
    rng = random.Random(5)
    doc = _doc(rng, 33)
    segs = _segments(rng, doc)
    s = _feed_permuted(ooo, segs, doc, list(reversed(range(len(segs)))),
                       rng, hints=False)
    ooo.flush()
    assert ooo._streams[s.sid].stream_fp == segment_fingerprint(doc)
    s.close()
    assert segment_fingerprint(b"\x00" + doc) == segment_fingerprint(doc)
    assert compose_fingerprints(
        segment_fingerprint(doc[:7]), segment_fingerprint(doc[7:]),
        len(doc) - 7) == segment_fingerprint(doc)
    assert 0 <= segment_fingerprint(doc) < FP_MOD


# --------------------------------------------------------------------------
# dispatch discipline: one compose per gap close, batched spec matching
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_gap_close_is_one_scan_dispatch(backend):
    m = _matcher(backend)
    ooo = OooStreamMatcher(m, policy=OooPolicy(match_batch=1))
    doc = b"ab0189ba" * 4
    segs = [doc[i:i + 4] for i in range(0, len(doc), 4)]
    offs = _offsets(segs)
    s = ooo.open()
    for i in range(1, len(segs)):
        s.feed(i, segs[i], prev_tail=doc[offs[i] - 2:offs[i]], flush=True)
    assert ooo.stats.spec_matched == len(segs) - 1
    assert s.buffered_bytes == 0, "matched payloads must be released"
    folds, calls = ooo.stats.scan_folds, m.compose_calls
    s.feed(0, segs[0], flush=True)
    assert ooo.stats.scan_folds == folds + 1, \
        "closing the gap must fold the whole run in ONE compose dispatch"
    assert m.compose_calls == calls + 1
    assert ooo.stats.scan_fold_segments >= len(segs) - 1
    assert ooo.stats.scan_batch > 1
    res = s.close()
    np.testing.assert_array_equal(res.final_states, _oracle(m, doc))


def test_in_order_streams_never_park():
    m = _matcher("local")
    ooo = OooStreamMatcher(m, policy=OooPolicy(match_batch=1))
    s = ooo.open()
    for i, seg in enumerate([b"ab01", b"89ba", b"xy"]):
        s.feed(i, seg, flush=True)
        assert s.buffered_segments == 0
    assert ooo.stats.spec_matched == 0, "in-order rides the exact path"
    assert ooo.stats.scan_folds == 0 and m.compose_calls == 0
    assert ooo.stats.exact_segments == 3
    s.close()


# --------------------------------------------------------------------------
# duplicates, integrity, backpressure, gaps
# --------------------------------------------------------------------------

def test_duplicate_deliveries_dedup_and_conflict():
    m = _matcher("local")
    ooo = OooStreamMatcher(m, policy=OooPolicy(match_batch=1))
    s = ooo.open()
    s.feed(0, b"ab01", flush=True)
    s.feed(0, b"ab01")
    s.feed(2, b"xy")
    s.feed(2, b"xy")
    assert ooo.stats.duplicates == 2
    assert s.buffered_segments == 1
    with pytest.raises(OooIntegrityError):
        s.feed(0, b"abXX")
    with pytest.raises(OooIntegrityError):
        s.feed(2, b"xY")
    with pytest.raises(OooIntegrityError):
        s.feed(1, b"89", prev_tail=b"xy")
        ooo.flush()
        s.feed(1, b"89")
    ooo2 = OooStreamMatcher(m)
    s2 = ooo2.open()
    with pytest.raises(ValueError):
        s2.feed(0, b"ab", prev_tail=b"x")
    with pytest.raises(ValueError):
        s2.feed(-1, b"ab")


def test_backpressure_bounded_buffer():
    m = _matcher("local")
    ooo = OooStreamMatcher(
        m, policy=OooPolicy(max_buffered_segments=4, match_batch=1000))
    s = ooo.open()
    for i in range(1, 5):
        s.feed(i, b"ab")
    with pytest.raises(ReorderBufferFull) as exc:
        s.feed(5, b"ba")
    assert exc.value.seq_no == 5 and exc.value.stream_id == s.sid
    assert s.buffered_segments == 4, "refused admission must not mutate"
    s.feed(0, b"xy")
    ooo.flush()
    assert s.buffered_segments == 0
    s.feed(5, b"ba")
    s.close()
    bytes_pol = OooPolicy(max_buffered_bytes=8, match_batch=1000,
                          dedup_window=0)
    ooo2 = OooStreamMatcher(m, policy=bytes_pol)
    s2 = ooo2.open()
    s2.feed(3, b"abababab")
    with pytest.raises(ReorderBufferFull):
        s2.feed(4, b"x")
    with pytest.raises(ValueError):
        OooPolicy(max_buffered_segments=0)
    with pytest.raises(ValueError):
        OooPolicy(dedup_window=-1)


def test_close_with_gap_raises():
    m = _matcher("local")
    ooo = OooStreamMatcher(m)
    s = ooo.open()
    s.feed(0, b"ab")
    s.feed(2, b"ba")
    with pytest.raises(SequenceGapError, match="seq 1 never arrived"):
        s.close()
    s.feed(1, b"01")
    res = s.close()
    np.testing.assert_array_equal(res.final_states, _oracle(m, b"ab01ba"))
    with pytest.raises(ValueError):
        s.feed(3, b"x")


def test_zero_byte_segments_and_absorbed_skip():
    m = _matcher("local")
    ooo = OooStreamMatcher(m, policy=OooPolicy(match_batch=1))
    s = ooo.open()
    s.feed(0, b"", flush=True)
    s.feed(2, b"")
    s.feed(1, b"abba", flush=True)
    res = s.close()
    np.testing.assert_array_equal(res.final_states, _oracle(m, b"abba"))
    doc = b"abba" + b"012" + b"xxy"
    s2 = ooo.open()
    s2.feed(0, doc, flush=True)
    skips = ooo.stats.absorbed_skips
    s2.feed(2, b"9999ab")
    s2.feed(1, b"xyxy01", flush=True)
    assert ooo.stats.absorbed_skips >= skips + 2
    res2 = s2.close()
    assert res2.accepted.all()
    assert res2.byte_count == len(doc) + 12
    np.testing.assert_array_equal(
        res2.final_states, _oracle(m, doc + b"xyxy019999ab"))


def test_early_accepts_before_sequencing():
    m = _matcher("local")
    ooo = OooStreamMatcher(m, policy=OooPolicy(match_batch=1))
    s = ooo.open()
    s.feed(2, b"z0189zz", prev_tail=b"qq", flush=True)
    dec = s.early_accepts()
    assert dec[PATTERNS.index(".*[0-9]{3}")]
    assert not dec.all()
    s.feed(0, b"zz", flush=True)
    s.feed(1, b"qq", flush=True)
    res = s.close()
    assert res.accepted[PATTERNS.index(".*[0-9]{3}")]


def test_snapshot_and_restore_not_ported(tmp_path):
    """Ported since: a snapshot taken mid-reorder on ``backend="local"``
    restores on the "cuda" backend (its plain versions on the CPU), and the
    stream closes to the whole-document finals."""
    m = _matcher("local")
    ooo = OooStreamMatcher(m)
    s = ooo.open()
    s.feed(1, b"ab1")
    s.feed(2, b"89y", prev_tail=b"b1")
    ooo.snapshot(str(tmp_path))
    ooo2 = OooStreamMatcher(_matcher("cuda"))
    (s2,) = ooo2.restore(str(tmp_path))
    assert (s2.sid, s2.next_seq, s2.buffered_segments) == (0, 0, 2)
    s2.feed(0, b"xxa")
    res = s2.close()
    np.testing.assert_array_equal(res.final_states, _oracle(m, b"xxaab189y"))
    assert res.byte_count == 9 and res.segments_fed == 3
    assert ooo2.open().sid == 1


# --------------------------------------------------------------------------
# cross-stream dedup: compute dedup, never drop dedup
# --------------------------------------------------------------------------

def test_cross_stream_dedup_bit_identical_and_hits():
    rng = random.Random(11)
    m = _matcher("local")
    doc = _doc(rng, 40)
    segs = _segments(rng, doc, with_empty=False)
    offs = _offsets(segs)
    order = list(range(len(segs)))[::-1]
    n_streams = 4
    results = {}
    for window in (0, 64):
        pol = OooPolicy(match_batch=4, cross_stream_dedup_window=window)
        ooo = OooStreamMatcher(_matcher("local"), policy=pol)
        streams = [ooo.open() for _ in range(n_streams)]
        for i in order:
            tail = doc[max(0, offs[i] - 2):offs[i]]
            for s in streams:
                s.feed(i, segs[i], prev_tail=tail)
            ooo.flush()
        results[window] = [s.close() for s in streams]
        if window:
            assert ooo.stats.cross_stream_hits > 0
            assert ooo.stats.spec_matched < n_streams * len(order)
        else:
            assert ooo.stats.cross_stream_hits == 0
    want = _oracle(m, doc)
    for window, res in results.items():
        for r in res:
            np.testing.assert_array_equal(r.final_states, want,
                                          err_msg=f"window={window}")


def test_cross_stream_dedup_keys_on_boundary_key():
    w = FingerprintWindow(8)
    w.put(123, 4, 2, "map-at-key-2")
    assert w.get(123, 4, 2) == "map-at-key-2"
    assert w.get(123, 4, 3) is None
    assert w.get(123, 5, 2) is None
    assert w.hits == 1 and w.misses == 2


def test_fingerprint_window_lru_bound():
    w = FingerprintWindow(2)
    w.put(1, 1, 0, "a")
    w.put(2, 1, 0, "b")
    assert w.get(1, 1, 0) == "a"
    w.put(3, 1, 0, "c")
    assert len(w) == 2
    assert w.get(2, 1, 0) is None
    assert w.get(1, 1, 0) == "a" and w.get(3, 1, 0) == "c"
    with pytest.raises(ValueError):
        FingerprintWindow(0)


# --------------------------------------------------------------------------
# the same arrival plan through the JAX and the port OooStreamMatcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_same_arrival_plan_as_jax(backend):
    """Several interleaved streams, shuffled deliveries with hints on some,
    duplicates and empties: equal decisions, byte counts and counters."""
    jm = jcore.Matcher([jcore.make_search_dfa(jcore.compile_regex(p))
                        for p in PATTERNS], backend="local", batch_tile=8)
    tm = _matcher(backend)
    pol = dict(match_batch=6, cross_stream_dedup_window=16)
    jo = JOooStreamMatcher(jm, policy=JOooPolicy(**pol))
    to = OooStreamMatcher(tm, policy=OooPolicy(**pol))
    rng = random.Random(31)
    docs = [_doc(rng, rng.randint(0, 60)) for _ in range(5)] + [b"ab01" * 8]
    plan = []  # (stream, seq, payload, prev_tail or None), in arrival order
    for sid, doc in enumerate(docs):
        segs = _segments(rng, doc, max_seg=9)
        offs = _offsets(segs)
        for i, seg in enumerate(segs):
            tail = (doc[max(0, offs[i] - 2):offs[i]]
                    if rng.random() < 0.6 else None)
            plan.append((sid, i, seg, tail))
            if rng.random() < 0.2:
                plan.append((sid, i, seg, None))
    rng.shuffle(plan)
    base = merge_calls()
    results = []
    for ooo in (jo, to):
        streams = [ooo.open() for _ in docs]
        for sid, i, seg, tail in plan:
            streams[sid].feed(i, seg, prev_tail=tail)
        results.append([s.close() for s in streams])
    assert merge_calls() == base
    for doc, jr, tr in zip(docs, *results):
        np.testing.assert_array_equal(tr.final_states, jr.final_states)
        np.testing.assert_array_equal(tr.accepted, jr.accepted)
        assert tr.byte_count == jr.byte_count == len(doc)
        assert tr.segments_fed == jr.segments_fed
        np.testing.assert_array_equal(tr.final_states, _oracle(tm, doc))
    assert dataclasses.asdict(to.stats) == dataclasses.asdict(jo.stats)
    assert to.stats.scan_folds > 0 and to.stats.spec_matched > 0
    assert tm.compose_calls == jm.compose_calls
