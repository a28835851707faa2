"""The port's hot pattern swap against the JAX package, on the CPU.

``Matcher.swap_patterns`` (with ``LocalExecutor.retable``),
``StreamMatcher.swap_patterns``, ``BlockedStreamMatcher.swap_patterns`` and
``GrammarConstraint.swap_grammar``: the same seeded inputs go through both
packages — JAX on ``backend="local"`` (and ``"pallas"``, interpret mode, on
the small matcher), the port on ``device="cpu"`` for ``local`` and ``cuda``
(the kernels' plain versions).  Mirrors the swap rows of
tests/test_pattern_scale.py and tests/test_conformance.py and the
``StreamMatcher`` swap of tests/test_fault_tolerance.py.  Return values,
epochs, states, cursors, masks and messages are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Matcher as JMatcher
from repro.core import PatternSet as JPatternSet
from repro.core import compile_regex as j_compile_regex
from repro.core import make_search_dfa as j_make_search_dfa
from repro.serving import GrammarConstraint as JGC
from repro.streaming import BlockedStreamMatcher as JBlockedStreamMatcher
from repro.streaming import StreamMatcher as JStreamMatcher
from repro.streaming import TickPolicy as JTickPolicy
from repro.streaming import pattern_set_signature as j_pattern_set_signature
from repro_torch.core import (Matcher, PatternSet, compile_regex,
                              make_search_dfa)
from repro_torch.serving import GrammarConstraint
from repro_torch.streaming import (BlockedStreamMatcher, StreamMatcher,
                                   TickPolicy, pattern_set_signature)

KW = dict(num_chunks=4, lookahead_r=1, batch_tile=16)
LAZY = TickPolicy(max_batch=1 << 30, max_delay=1 << 30)
JLAZY = JTickPolicy(max_batch=1 << 30, max_delay=1 << 30)
BACKENDS = ["local", "cuda"]
ALPHABET = np.frombuffer(b"abcdqxz019 ", np.uint8)

SET_A = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
SET_B = [".*(ab|ba){2}", ".*zz[0-9]+zz", ".*(qu)+x", ".*c+d"]


def _tdfas(patterns):
    return [make_search_dfa(compile_regex(p)) for p in patterns]


def _jdfas(patterns):
    return [j_make_search_dfa(j_compile_regex(p)) for p in patterns]


def _docs(seed, n=24, hi=96):
    rng = np.random.default_rng(seed)
    docs = [rng.choice(ALPHABET, size=int(rng.integers(0, hi))).tobytes()
            for _ in range(n)]
    return docs + [b"abab 123 xy", b"zz42zz ququx ccd", b"x" * 70 + b"y"]


def _same(got, want):
    np.testing.assert_array_equal(got.accepted, want.accepted)
    np.testing.assert_array_equal(got.final_states, want.final_states)


def _membership_keys(m) -> set:
    return set(m.perf_report()["lowerings"])


# --------------------------------------------------------------------------
# Matcher.swap_patterns


@pytest.mark.parametrize("backend,jax_backend",
                         [("local", "local"), ("cuda", "local"),
                          ("cuda", "pallas")])
def test_matcher_swap_unit(backend, jax_backend):
    m = Matcher(compile_regex("ab+"), backend=backend, device="cpu", **KW)
    jm = JMatcher(j_compile_regex("ab+"), backend=jax_backend, **KW)
    assert m.accepts_batch([b"abb"])[0, 0]
    jm.accepts_batch([b"abb"])
    lowered = dict(m.perf_report()["lowerings"])
    traces = m.trace_count
    # signature-equal: False, nothing touched
    assert m.swap_patterns(compile_regex("ab+")) is False
    assert jm.swap_patterns(j_compile_regex("ab+")) is False
    assert m.planner.table_epoch == jm.planner.table_epoch == 0
    assert m.perf_report()["lowerings"] == lowered
    assert m.trace_count == traces
    assert m.swap_patterns(compile_regex("cd?")) is True
    assert jm.swap_patterns(j_compile_regex("cd?")) is True
    assert m.planner.table_epoch == jm.planner.table_epoch == 1
    assert m.perf_report()["table_epoch"] == 1
    assert m.perf_report()["prefilter_skipped_blocks"] is None
    assert m.perf_report()["lowerings"] == {}   # retable dropped them
    docs = [b"abb", b"cd", b"c", b"xxxxxxxxxxxxxxxxxxxxcdd", b"abcd" * 9]
    got, want = m.membership_batch(docs), jm.membership_batch(docs)
    _same(got, want)
    assert got.accepted[:3, 0].tolist() == [False, True, True]
    assert m.trace_count > traces              # the first call re-lowered
    # post-swap plans carry the bumped epoch, as JAX's
    assert _membership_keys(m) == _membership_keys(jm)
    assert all(k.endswith("|1") for k in _membership_keys(m))


@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_a_b_a_equals_fresh_matchers(backend):
    """A -> B -> A: every step equals a freshly built matcher on that set
    and JAX's swapped matcher — membership, the streaming ticks (B1 exact
    entry, B2 cursor lanes) and the bulk compose (B3) — and the table's
    size and lane width change with it."""
    docs = _docs(11)
    m = Matcher(_tdfas(SET_A), backend=backend, device="cpu", **KW)
    jm = JMatcher(_jdfas(SET_A), **KW)
    for step, pats in enumerate((SET_A, SET_B, SET_A)):
        if step:
            assert m.swap_patterns(_tdfas(pats)) is True
            assert jm.swap_patterns(_jdfas(pats)) is True
        fresh = Matcher(_tdfas(pats), backend=backend, device="cpu", **KW)
        assert m.planner.table_epoch == jm.planner.table_epoch == step
        assert m.executor.t is m.dev and m.dev.n_patterns == len(pats)
        res = m.membership_batch(docs)
        _same(res, fresh.membership_batch(docs))
        _same(res, jm.membership_batch(docs))
        np.testing.assert_array_equal(m.classes(docs[-2]),
                                      jm.classes(docs[-2]))
        heads, tails = [d[:len(d) // 2] for d in docs], [d[len(d) // 2:]
                                                          for d in docs]
        entry = np.tile(m.packed.starts, (len(docs), 1))
        h = m.advance_segments(heads, entry)
        t = m.advance_segments(tails, h.final_states)
        np.testing.assert_array_equal(t.final_states, res.final_states)
        jh = jm.advance_segments(heads, entry)
        np.testing.assert_array_equal(h.final_states, jh.final_states)
        # candidate-keyed cursors over the tails (B2)
        keys = np.array([m.dev.advance_key(-1, hd) for hd in heads],
                        np.int32)
        keep = keys >= 0
        s = m.dev.i_max
        lanes = np.repeat(h.final_states[keep][:, :, None], s, axis=2)
        segs = [tl for tl, k in zip(tails, keep) if k]
        cur = m.advance_cursors(segs, lanes, keys[keep])
        jcur = jm.advance_cursors(segs, lanes, keys[keep])
        np.testing.assert_array_equal(cur.lane_states, jcur.lane_states)
        np.testing.assert_array_equal(
            cur.lane_states,
            np.repeat(res.final_states[keep][:, :, None], s, axis=2))
        # the bulk compose (B3 in the kernel lowering) after the swap, on
        # real runs of two segment maps: every lane against the fresh
        # matcher, the real candidate lanes against JAX
        maps, ekeys = _lane_runs(m, tails, keys, keep)
        got = m.compose_lane_maps(maps, ekeys)
        np.testing.assert_array_equal(got,
                                      fresh.compose_lane_maps(maps, ekeys))
        np.testing.assert_array_equal(
            _real_lanes(m, got, ekeys[:, 0]),
            _real_lanes(m, np.asarray(jm.compose_lane_maps(maps, ekeys)),
                        ekeys[:, 0]))


def _lane_runs(m, tails, keys, keep):
    """Each kept document's tail as a run of two candidate-keyed segment
    maps ([B, 2, K, S]) keyed on their true boundary keys."""
    cands = np.asarray(m.dev.tables.candidates, np.int32)
    firsts = [tl[:len(tl) // 2] for tl, k in zip(tails, keep) if k]
    seconds = [tl[len(tl) // 2:] for tl, k in zip(tails, keep) if k]
    k0 = keys[keep]
    k1 = np.array([m.dev.advance_key(int(k), f) for k, f in zip(k0, firsts)],
                  np.int32)
    a = m.advance_cursors(firsts, cands[k0], k0).lane_states
    b = m.advance_cursors(seconds, cands[k1], k1).lane_states
    return np.stack([a, b], axis=1), np.stack([k0, k1], axis=1)


def _real_lanes(m, out, keys0, fill=-7):
    """The lanes a consumer can address through ``cand_index`` (pad lanes
    hold evaluation-order-dependent values, ``kernels.ops``)."""
    cidx = np.asarray(m.dev.tables.cand_index)
    cands = np.asarray(m.dev.tables.candidates)
    b, (k, s) = len(keys0), cands.shape[1:]
    mask = (np.take_along_axis(cidx[keys0], cands[keys0].reshape(b, -1),
                               axis=1).reshape(b, k, s) == np.arange(s))
    return np.where(mask, out, fill)


def test_matcher_refuses_multiblock_pattern_set_as_reference():
    ps = PatternSet(["aa", "bb", "cc"], k_blk=2, search=True)
    jps = JPatternSet(["aa", "bb", "cc"], k_blk=2, search=True)
    with pytest.raises(ValueError) as got:
        Matcher(ps, device="cpu", **KW)
    with pytest.raises(ValueError) as want:
        JMatcher(jps, **KW)
    assert str(got.value) == str(want.value)
    assert "BlockedMatcher" in str(got.value)
    m = Matcher(PatternSet(["aa"], k_blk=2, search=True), device="cpu", **KW)
    assert m.accepts_batch([b"aa"])[0, 0]
    with pytest.raises(ValueError, match="BlockedMatcher"):
        m.swap_patterns(ps)            # a swap refuses it the same way
    assert m.planner.table_epoch == 0


def test_matcher_classes_match_jax():
    m = Matcher(_tdfas(SET_B), device="cpu", **KW)
    jm = JMatcher(_jdfas(SET_B), **KW)
    for doc in _docs(5, n=6):
        got = m.classes(doc)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jm.classes(doc))
        np.testing.assert_array_equal(
            m.classes(np.frombuffer(doc, np.uint8)), got)


# --------------------------------------------------------------------------
# StreamMatcher.swap_patterns


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_swap_refuses_candidate_sessions(backend):
    """A [K, S] restricted map cannot be re-keyed onto new tables: refused
    with JAX's message while an ``open_at`` session lives (its tick rides
    B2), accepted once ``close_map`` closed it."""
    m = Matcher(compile_regex(".*(ab)"), backend=backend, device="cpu", **KW)
    jm = JMatcher(j_compile_regex(".*(ab)"), **KW)
    sm = StreamMatcher(m, policy=LAZY, lane_ticks=True)
    jsm = JStreamMatcher(jm, policy=JLAZY, lane_ticks=True)
    sess, jsess = sm.open_at(entry_class=0), jsm.open_at(entry_class=0)
    sess.feed(b"xxabyyyyyyyyyyyyyyyyyyy")
    jsess.feed(b"xxabyyyyyyyyyyyyyyyyyyy")
    sm.flush()
    jsm.flush()
    with pytest.raises(ValueError, match="candidate-keyed") as got:
        sm.swap_patterns(compile_regex(".*(cd)"))
    with pytest.raises(ValueError) as want:
        jsm.swap_patterns(j_compile_regex(".*(cd)"))
    assert str(got.value) == str(want.value)
    assert m.planner.table_epoch == 0
    seg, jseg = sm.close_map(sess), jsm.close_map(jsess)
    np.testing.assert_array_equal(seg.lane_states, jseg.lane_states)
    assert sm.swap_patterns(compile_regex(".*(cd)")) is True
    assert jsm.swap_patterns(j_compile_regex(".*(cd)")) is True
    s = sm.open()
    s.feed(b"abcd")
    assert s.close().accepted.tolist() == [True]


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_swap_flushes_pending_and_reopens(backend):
    """Pending bytes flush through the old tables; open cursors re-open at
    the new starts with ``byte_count`` carried; an absorbed (evicted)
    stream is live again.  Every step equals JAX's."""
    def run(sm, dfas_a, dfas_b):
        s1, s2, s3 = sm.open(), sm.open(), sm.open()
        s1.feed(b"abab 1")           # s1 absorbs at once ("abab")
        s2.feed(b"xx 12")
        sm.flush()
        s1.feed(b" more")            # evicted: no queue slot
        s2.feed(b"3 cc")             # pending through the old tables
        s3.feed(b"zz9")
        ticks0 = sm.stats.ticks
        same = sm.swap_patterns(dfas_a)
        out = [same, sm.stats.ticks - ticks0, s2.byte_count]
        out.append(sm.swap_patterns(dfas_b))
        out += [s.cursor.byte_count for s in (s1, s2, s3)]
        out += [s.cursor.states.copy() for s in (s1, s2, s3)]
        for s in (s1, s2, s3):
            s.feed(b"zz7zz ququx cd")
        res = [s.close() for s in (s1, s2, s3)]
        out += [(r.accepted.tolist(), r.final_states.tolist(), r.byte_count,
                 r.segments_fed) for r in res]
        out.append((sm.stats.ticks, sm.stats.evicted))
        return out

    got = run(StreamMatcher(_tdfas(SET_A), policy=LAZY, backend=backend,
                            device="cpu", num_chunks=4),
              _tdfas(SET_A), _tdfas(SET_B))
    want = run(JStreamMatcher(_jdfas(SET_A), policy=JLAZY, num_chunks=4),
               _jdfas(SET_A), _jdfas(SET_B))
    assert got[0] is False and got[1] == 1   # the no-op swap still flushed
    assert got[3] is True
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert got[4:7] == [11, 9, 3]            # byte counts carried


# --------------------------------------------------------------------------
# BlockedStreamMatcher: open, feed, flush, close and swap


BLK_PATS = {"a": "hello", "b": "wor", "c": "abc", "d": "wld", "e": "q[0-9]+"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_swap_carries_unchanged_blocks(backend):
    """Mid-stream hot swap: untouched blocks keep their cursors (and their
    full byte history) bit for bit; swapped ones see post-swap bytes."""
    ps = PatternSet({"a": "hello", "b": "wor", "c": "abc", "d": "wld"},
                    k_blk=2, search=True)
    jps = JPatternSet({"a": "hello", "b": "wor", "c": "abc", "d": "wld"},
                      k_blk=2, search=True)
    sm = BlockedStreamMatcher(ps, policy=LAZY, backend=backend,
                              device="cpu", **KW)
    jsm = JBlockedStreamMatcher(jps, policy=JLAZY, **KW)
    assert sm._sms[0].snapshot_signature == j_pattern_set_signature(
        jsm.pattern_set, jsm.blocked.prefilter)
    sess, jsess = sm.open(), jsm.open()
    sess.feed(b"hello wor")
    jsess.feed(b"hello wor")
    sm.flush()
    jsm.flush()
    keep = sess.parts[0].cursor.lane_states.copy()
    np.testing.assert_array_equal(keep, jsess.parts[0].cursor.lane_states)
    info = sm.swap_patterns(ps.with_patterns({"d": "world"}))
    assert info == jsm.swap_patterns(jps.with_patterns({"d": "world"}))
    assert info["reused"] == [0] and info["rebuilt"] == [1]
    np.testing.assert_array_equal(sess.parts[0].cursor.lane_states, keep)
    for p, jp in zip(sess.parts, jsess.parts):
        np.testing.assert_array_equal(p.cursor.lane_states,
                                      jp.cursor.lane_states)
        assert p.cursor.byte_count == jp.cursor.byte_count
    assert sm._sms[1].snapshot_signature == j_pattern_set_signature(
        jsm.pattern_set, jsm.blocked.prefilter)
    sess.feed(b"ld!")
    jsess.feed(b"ld!")
    res, jres = sess.close(), jsess.close()
    assert res.accepted.tolist() == [True, True, False, False]
    assert res.byte_count == jres.byte_count == 12
    np.testing.assert_array_equal(res.final_states, jres.final_states)
    assert res.segments_fed == jres.segments_fed == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_blocked_stream_swap_adopts_and_drops_blocks(backend):
    """A swap that adds a block adopts every open stream at the new block's
    starts (byte count carried); one that drops the last block cuts its
    cursors.  Close results, stats and reports equal JAX's."""
    def run(bsm_cls, ps_cls, policy, **kw):
        base = {k: BLK_PATS[k] for k in "abcd"}
        sm = bsm_cls(ps_cls(base, k_blk=2, search=True), policy=policy,
                     **kw)
        sessions = [sm.open() for _ in range(3)]
        docs = [b"hello wo", b"q12 abc", b"wl"]
        for s, d in zip(sessions, docs):
            s.feed(d)
        sm.flush()
        infos = [sm.swap_patterns(ps_cls(BLK_PATS, k_blk=2, search=True))]
        for s in sessions:
            s.feed(b"rld q7 abc")
        sm.flush()
        infos.append(sm.swap_patterns(ps_cls(
            {k: BLK_PATS[k] for k in "ab"}, k_blk=2, search=True)))
        late = sm.open()
        late.feed(b"hello")
        for s in sessions:
            s.feed(b" hello")
        out = [(r.accepted.tolist(), r.final_states.tolist(), r.byte_count,
                r.segments_fed)
               for r in (s.close() for s in sessions + [late])]
        rep = sm.perf_report()
        return (infos, out, [len(s.parts) for s in sessions],
                sm.stats, [st.ticks for st in sm.block_stats],
                (rep["n_blocks"], rep["table_epochs"],
                 rep["prefilter_gated_docs"]), sm.n_patterns, sm.n_blocks)

    got = run(BlockedStreamMatcher, PatternSet, LAZY, backend=backend,
              device="cpu", **KW)
    want = run(JBlockedStreamMatcher, JPatternSet, JLAZY, **KW)
    assert got[0] == want[0]
    assert got[0][0]["rebuilt"] == [2] and got[0][1]["dropped"] == 2
    assert got[1] == want[1]
    assert got[1][0][2] == 8 + 10 + 6       # byte count carried
    assert got[2] == [1, 1, 1]
    for f in ("ticks", "feeds", "segments", "bytes_fed", "bytes_matched",
              "bucket_calls", "rows_dispatched", "evicted"):
        assert getattr(got[3], f) == getattr(want[3], f), f
    assert got[4:] == want[4:]


def test_blocked_stream_matcher_contract(tmp_path):
    ps = PatternSet({"a": "ab", "b": "cd", "c": "ef"}, k_blk=2, search=True)
    bm_kw = dict(device="cpu", **KW)
    sm = BlockedStreamMatcher(ps, policy=LAZY, **bm_kw)
    assert sm.blocked.backend == "cuda"
    assert all(c.matcher.device.type == "cpu" for c in sm._sms)
    with pytest.raises(ValueError, match="conflict"):
        BlockedStreamMatcher(sm.blocked, num_chunks=2)
    shared = BlockedStreamMatcher(sm.blocked, policy=LAZY)
    assert shared.blocked is sm.blocked
    s = sm.open()
    with pytest.raises(ValueError, match="different matcher"):
        shared.feed(s, b"x")
    s.feed(b"abxef")
    assert s.pending_bytes == 5 and s.byte_count == 0
    r = s.close()
    assert r.accepted.tolist() == [True, False, True] and bool(r)
    with pytest.raises(ValueError):
        s.feed(b"x")
    with pytest.raises(ValueError):
        s.close()
    # snapshot/restore is ported: one tree per block, pending bytes kept
    s = sm.open()
    s.feed(b"xa")
    assert sm.snapshot(str(tmp_path)) == str(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["block_000",
                                                          "block_001"]
    (s2,) = BlockedStreamMatcher(ps, policy=LAZY, **bm_kw).restore(
        str(tmp_path))
    assert (s2.sid, s2.pending_bytes) == (1, 2)
    s2.feed(b"bcd")
    r = s2.close()
    assert r.accepted.tolist() == [True, True, False] and r.byte_count == 5


def test_pattern_set_signature_matches_jax():
    from repro.core import Prefilter as JPrefilter
    from repro_torch.core import Prefilter

    pats = {"a": "needle", "b": "[ab]+", "c": "zz[0-9]"}
    for k_blk in (1, 2):
        ps = PatternSet(pats, k_blk=k_blk, search=True)
        jps = JPatternSet(pats, k_blk=k_blk, search=True)
        assert pattern_set_signature(ps) == j_pattern_set_signature(jps)
        assert (pattern_set_signature(ps, Prefilter.from_pattern_set(ps))
                == j_pattern_set_signature(
                    jps, JPrefilter.from_pattern_set(jps)))
    a = pattern_set_signature(PatternSet(pats, k_blk=1, search=True))
    b = pattern_set_signature(PatternSet({**pats, "c": "zz[0-8]"}, k_blk=1,
                                         search=True))
    assert a != b


# --------------------------------------------------------------------------
# GrammarConstraint.swap_grammar

GRAMMAR = r"([0-9]{1,6}[.,] )*[0-9]{0,6}"
GRAMMAR2 = r"[a-z]{1,8}(, [a-z]{1,8})*"


@pytest.mark.parametrize("use_kernel", [True, False])
def test_swap_grammar_matches_jax(use_kernel):
    """After the swap the mask table, the token classes, the padded
    transition table, ``mask_logits``, ``advance`` and ``advance_tokens``
    equal JAX's swapped constraint; a signature-equal grammar is a no-op."""
    vocab = 300
    jgc = JGC(j_compile_regex(GRAMMAR), vocab, use_kernel=use_kernel)
    tgc = GrammarConstraint(compile_regex(GRAMMAR), vocab,
                            use_kernel=use_kernel, device="cpu")
    allowed0 = tgc.allowed.clone()
    assert tgc.swap_grammar(compile_regex(GRAMMAR)) is False
    assert jgc.swap_grammar(j_compile_regex(GRAMMAR)) is False
    assert torch.equal(tgc.allowed, allowed0)
    assert tgc.matcher.planner.table_epoch == 0
    assert tgc.swap_grammar(compile_regex(GRAMMAR2)) is True
    assert jgc.swap_grammar(j_compile_regex(GRAMMAR2)) is True
    assert tgc.matcher.planner.table_epoch == jgc.matcher.planner.table_epoch
    assert tgc.dfa.n_states == jgc.dfa.n_states
    np.testing.assert_array_equal(tgc.allowed.numpy(), np.asarray(jgc.allowed))
    np.testing.assert_array_equal(tgc.tok_cls.numpy(), np.asarray(jgc.tok_cls))
    np.testing.assert_array_equal(tgc.table.numpy(), np.asarray(jgc.table_j))
    assert tgc.table is tgc.matcher.dev.table_pad_t
    rng = np.random.default_rng(19)
    states = rng.integers(0, tgc.dfa.n_states, size=6).astype(np.int32)
    logits = rng.normal(size=(6, 320)).astype(np.float32)
    got = tgc.mask_logits(torch.from_numpy(states), torch.from_numpy(logits))
    want = jgc.mask_logits(jnp.asarray(states), jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    toks = rng.choice(np.frombuffer(b"abz, 9", np.uint8),
                      size=(6, 10)).astype(np.int32)
    toks[:, 4] = 299                                      # a special token
    ts, js = tgc.init_states(6), jgc.init_states(6)
    for t in range(toks.shape[1]):
        ts = tgc.advance(ts, torch.from_numpy(toks[:, t]))
        js = jgc.advance(js, jnp.asarray(toks[:, t]))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tgc.advance_tokens(tgc.init_states(6), toks).numpy(), ts.numpy())
    # a decode stream opened after the swap runs the new grammar
    ds = tgc.open_decode(6)
    np.testing.assert_array_equal(ds.feed_tokens(toks).numpy(), ts.numpy())
