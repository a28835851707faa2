"""The port's pattern-set scale tier (``BlockedMatcher``, the required-literal
prefilter, block-granular hot swap) against the JAX package, on the CPU.

Mirrors tests/test_pattern_scale.py (batch side) and the blocked rows of
tests/test_conformance.py.  The same seeded inputs go through both packages:
JAX on ``backend="local"`` (and on ``backend="pallas"``, interpret mode, at
small K), the port on ``device="cpu"`` for ``local`` and for ``cuda`` (the
kernels' plain versions).  Every output is a bool, a state id, a count, a
fingerprint or a dict of block ids, so every comparison is exact.
"""

import functools
import re

import numpy as np
import pytest

from repro.core import BlockedMatcher as JBlockedMatcher
from repro.core import PatternSet as JPatternSet
from repro.core import Prefilter as JPrefilter
from repro.core import required_literal as j_required_literal
from repro.core import window_fingerprints as j_window_fingerprints
from repro.data import load_pattern_fixtures
from repro_torch.core import (BlockedMatcher, Matcher, PatternSet, Prefilter,
                              required_literal, window_fingerprints)
from repro_torch.streaming.ooo.fingerprint import segment_fingerprint

KW = dict(num_chunks=4, lookahead_r=1, batch_tile=16)
BACKENDS = ["local", "cuda"]

FIXTURES = load_pattern_fixtures()
ALL_PATTERNS = {e["name"]: e["pattern"] for e in FIXTURES}
ALL_DOCS = sorted({s.encode() for e in FIXTURES
                   for s in e["positive"] + e["negative"]})
ENGINE_KW = dict(num_chunks=4, batch_tile=16, max_buckets=2,
                 lookahead_r="auto")


@pytest.fixture(scope="module", autouse=True)
def _compile_each_regex_once():
    """Both packages' ``PatternSet`` compile every regex anew (and
    ``with_patterns`` recompiles the whole set); the fixture corpus holds
    PROSITE motifs that take seconds each.  Within this module each
    (search, regex) compiles once per package and later sets reuse the
    DFA objects, which nothing mutates."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JPatternSet, PatternSet):
            cache, orig = {}, cls._compile

            def _compile(self, regex, cache=cache, orig=orig):
                key = (self.search, regex)
                if key not in cache:
                    cache[key] = orig(self, regex)
                return cache[key]

            mp.setattr(cls, "_compile", _compile)
        yield


def _port(source, backend, **kw):
    return BlockedMatcher(source, backend=backend, device="cpu", **kw)


def _same_result(got, want):
    np.testing.assert_array_equal(got.accepted, want.accepted)
    np.testing.assert_array_equal(got.final_states, want.final_states)
    np.testing.assert_array_equal(got.time_steps, want.time_steps)
    np.testing.assert_array_equal(got.work_parallel, want.work_parallel)
    np.testing.assert_array_equal(got.work_sequential, want.work_sequential)


def _gate_counters(bm) -> tuple:
    rep = bm.perf_report()
    return (rep["prefilter_skipped_blocks"], rep["prefilter_gated_docs"],
            rep["n_patterns"], rep["n_blocks"], rep["k_blk"],
            rep["table_epochs"], rep["prefilter"])


def _search_oracle(patterns, docs) -> np.ndarray:
    comp = [re.compile(p.encode("latin-1"), re.DOTALL) for p in patterns]
    return np.array([[c.search(d) is not None for c in comp] for d in docs])


# --------------------------------------------------------------------------
# K = 2,048 blocked == JAX blocked == unblocked K = 32 on the shared prefix

K2048 = [f"K{i:03x}" for i in range(2048)]
K2048_DOCS = [b"xx K000 yy", b"K7ff at end", b"nothing here", b"K020 K021"]


@functools.lru_cache(maxsize=None)
def _jax_k2048():
    bm = JBlockedMatcher(K2048, k_blk=32, **KW)
    return bm.membership_batch(K2048_DOCS), _gate_counters(bm)


@pytest.mark.parametrize("backend", BACKENDS)
def test_k2048_blocked_prefix_identity(backend):
    bm = _port(K2048, backend, k_blk=32, **KW)
    assert (bm.n_blocks, bm.n_patterns) == (64, 2048)
    res = bm.membership_batch(K2048_DOCS)
    jres, jcount = _jax_k2048()
    _same_result(res, jres)
    assert res.bucket_calls == jres.bucket_calls
    assert _gate_counters(bm)[:6] == jcount[:6]
    assert bm.prefilter_skipped_blocks == 61
    hits = np.flatnonzero(res.accepted.any(axis=0))
    assert hits.tolist() == [0, 0x20, 0x21, 0x7FF]
    ref = Matcher(PatternSet(K2048[:32], k_blk=1 << 30, search=True),
                  backend=backend, device="cpu", **KW)
    rres = ref.membership_batch(K2048_DOCS)
    np.testing.assert_array_equal(res.accepted[:, :32], rres.accepted)
    np.testing.assert_array_equal(res.final_states[:, :32],
                                  rres.final_states)


# --------------------------------------------------------------------------
# K = 64, k_blk = 16, gate off: the whole [B, K] result is one unblocked pack

FULL_PATS = [f"p{i:02d}x" for i in range(60)] + \
            ["(ab|ba)+", "[0-9]{2}", "zz.?q", "w+"]


def _full_docs():
    rng = np.random.default_rng(3)
    return [bytes(rng.choice(np.frombuffer(b"abp019 zqwx", np.uint8),
                             size=int(rng.integers(1, 48))).astype(np.uint8))
            for _ in range(24)] + [b"p07x", b"abab 42 zzq www"]


@functools.lru_cache(maxsize=None)
def _jax_full():
    return JBlockedMatcher(FULL_PATS, k_blk=16, prefilter=False,
                           **KW).membership_batch(_full_docs())


@pytest.mark.parametrize("backend", BACKENDS)
def test_blocked_full_bit_identity_no_prefilter(backend):
    docs = _full_docs()
    bm = _port(FULL_PATS, backend, k_blk=16, prefilter=False, **KW)
    ref = Matcher(PatternSet(FULL_PATS, k_blk=1 << 30, search=True),
                  backend=backend, device="cpu", **KW)
    res, rres = bm.membership_batch(docs), ref.membership_batch(docs)
    _same_result(res, _jax_full())
    np.testing.assert_array_equal(res.accepted, rres.accepted)
    np.testing.assert_array_equal(res.final_states, rres.final_states)
    assert rres.accepted.any()
    assert bm.perf_report()["prefilter_skipped_blocks"] == 0


# --------------------------------------------------------------------------
# the gate never changes a verdict


def _soundness_case():
    pats = {f"n{i}": f"lit{i:02d}" for i in range(12)}
    pats["free"] = "[xy]+z"  # no literal -> its block stays ungated
    rng = np.random.default_rng(5)
    frags = [f"lit{i:02d}".encode() for i in range(12)] + [b"xyz", b"qq "]
    docs = [b"".join(frags[j] for j in rng.integers(0, len(frags), size=4))
            for _ in range(32)]
    return pats, docs


@functools.lru_cache(maxsize=None)
def _jax_soundness():
    pats, docs = _soundness_case()
    out = {}
    for gate in (True, False):
        bm = JBlockedMatcher(pats, k_blk=4, prefilter=gate, **KW)
        out[gate] = (bm.membership_batch(docs), bm.can_match(docs),
                     _gate_counters(bm))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefilter_soundness(backend):
    pats, docs = _soundness_case()
    jout = _jax_soundness()
    got = {}
    for gate in (True, False):
        bm = _port(pats, backend, k_blk=4, prefilter=gate, **KW)
        res = bm.membership_batch(docs)
        jres, jcan, jcount = jout[gate]
        _same_result(res, jres)
        np.testing.assert_array_equal(bm.can_match(docs), jcan)
        assert _gate_counters(bm) == jcount
        got[gate] = res.accepted
    np.testing.assert_array_equal(got[True], got[False])
    assert jout[False][2][0] == 0  # gate off: nothing skipped
    assert jout[True][2][1] > 0    # gate on: some (doc, block) pairs gated


# --------------------------------------------------------------------------
# prefilter building blocks


LITERAL_CASES = ["foobar", ".*(foobar)", "a[0-9]+barbaz[xy]?", "(ab){3}",
                 "x(ab)+y", "[ab]+", "abc|abd", "(abc)end", "a(b", "",
                 "zz[0-9]+zz", "(qu)+x"] + list(ALL_PATTERNS.values())


def test_required_literal_units():
    assert required_literal("foobar") == b"foobar"
    assert required_literal(".*(foobar)") == b"foobar"
    assert required_literal("a[0-9]+barbaz[xy]?") == b"barbaz"
    assert required_literal("(ab){3}") == b"ababab"
    assert required_literal("x(ab)+y") == b"ab"
    assert required_literal("[ab]+") is None
    assert required_literal("abc|abd") is None
    assert required_literal("(abc)end") == b"abcend"
    for pat in LITERAL_CASES:
        assert required_literal(pat) == j_required_literal(pat), pat


def test_window_fingerprints_match_segment_fingerprint():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=64).astype(np.uint8)
    for length in (0, 1, 3, 8, 64, 65):
        got = window_fingerprints(data, length)
        want = np.array([segment_fingerprint(bytes(data[i:i + length]))
                         for i in range(len(data) - length + 1)]
                        if 0 < length <= len(data) else [], np.uint64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, j_window_fingerprints(data,
                                                                 length))
        assert got.dtype == np.uint64


def test_prefilter_gating_matrix():
    ps = PatternSet({"a": "needle", "b": "[ab]+"}, k_blk=1, search=True)
    jps = JPatternSet({"a": "needle", "b": "[ab]+"}, k_blk=1, search=True)
    pf, jpf = Prefilter.from_pattern_set(ps), JPrefilter.from_pattern_set(jps)
    assert pf.gated.tolist() == [True, False]  # block 1 has no literal
    arrs = [np.frombuffer(b"hay needle hay", np.uint8),
            np.frombuffer(b"no match", np.uint8)]
    can = pf.can_match(arrs)
    assert can.tolist() == [[True, True], [False, True]]
    np.testing.assert_array_equal(can, jpf.can_match(arrs))
    assert (pf.signature(), repr(pf)) == (jpf.signature(), repr(jpf))


def test_prefilter_tables_match_jax_on_fixture_corpus():
    ps = PatternSet(ALL_PATTERNS, k_blk=4, search=True)
    jps = JPatternSet(ALL_PATTERNS, k_blk=4, search=True)
    pf, jpf = Prefilter.from_pattern_set(ps), JPrefilter.from_pattern_set(jps)
    assert pf.block_literals == jpf.block_literals
    assert pf.literals == jpf.literals and pf.min_len == jpf.min_len
    np.testing.assert_array_equal(pf.gated, jpf.gated)
    assert pf.signature() == jpf.signature()
    arrs = [np.frombuffer(d, np.uint8) for d in ALL_DOCS]
    np.testing.assert_array_equal(pf.can_match(arrs), jpf.can_match(arrs))


# --------------------------------------------------------------------------
# hot swap: partial rebuild, lowering-cache survival, epochs

SWAP_PATS = {f"q{i:02d}": f"pat{i:02d}" for i in range(8)}
SWAP_DOCS = [b"xx pat03 pat06", b"pat00", b"none"]


def _swap_run(bm):
    """Run, swap q06, run again; returns what both packages must agree
    on, and the traces before and after."""
    before = bm.membership_batch(SWAP_DOCS)
    traces0 = [m.executor.traces for m in bm.matchers]
    info = bm.swap_patterns(bm.pattern_set.with_patterns({"q06": "NEW[0-9]"}))
    after = bm.membership_batch(SWAP_DOCS + [b"NEW7!"])
    traces1 = [m.executor.traces for m in bm.matchers]
    return (before, info, after, bm.perf_report()["table_epochs"],
            traces0, traces1)


@functools.lru_cache(maxsize=None)
def _jax_swap(backend):
    return _swap_run(JBlockedMatcher(SWAP_PATS, k_blk=2, backend=backend,
                                     **KW))


@pytest.mark.parametrize("backend,jax_backend",
                         [("local", "local"), ("cuda", "local"),
                          ("cuda", "pallas")])
def test_swap_preserves_lowering_cache(backend, jax_backend):
    before, info, after, epochs, traces0, traces1 = _swap_run(
        _port(SWAP_PATS, backend, k_blk=2, **KW))
    jbefore, jinfo, jafter, jepochs, _, _ = _jax_swap(jax_backend)
    _same_result(before, jbefore)
    _same_result(after, jafter)
    assert info == jinfo == {"reused": [0, 1, 2], "rebuilt": [3],
                             "dropped": 0}
    assert epochs == jepochs == [0, 0, 0, 1]
    # unchanged blocks' lowerings survive the swap: re-running the same
    # shapes through blocks 0..2 lowers nothing new
    assert traces1[:3] == traces0[:3]
    assert traces1[3] > traces0[3]  # the rebuilt block really re-lowered
    want = before.accepted.copy()
    want[:, 6] = False  # q06 no longer matches "pat06"
    np.testing.assert_array_equal(after.accepted[:3], want)
    assert after.accepted[3, 6] and after.accepted[3].sum() == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_appends_and_drops_blocks(backend):
    """A swap that adds a block builds it fresh; one that drops the last
    block cuts it; both reports and results equal the JAX package's."""
    pats = [f"pat{i:02d}" for i in range(6)]
    grown = pats + ["NEW[0-9]", "zz+"]
    docs = SWAP_DOCS + [b"NEW7 pat05 zzz", b"pat01"]
    bm = _port(pats, backend, k_blk=2, **KW)
    jbm = JBlockedMatcher(pats, k_blk=2, **KW)
    for new in (grown, pats[:4], pats):
        info = bm.swap_patterns(new)
        assert info == jbm.swap_patterns(new)
        res = bm.membership_batch(docs)
        _same_result(res, jbm.membership_batch(docs))
        assert _gate_counters(bm) == _gate_counters(jbm)
        fresh = _port(new, backend, k_blk=2, **KW)
        _same_result(res, fresh.membership_batch(docs))
    assert [m.planner.table_epoch for m in bm.matchers] == [0, 0, 0]


# --------------------------------------------------------------------------
# conformance: blocked +- prefilter and after a hot swap, against ``re``


HOT_SWAP = {0: "zz[0-9]+zz", 9: "(qu)+x"}
HOT_DOCS = ALL_DOCS + [b"zz123zz", b"ququx yes", b"zz zz"]


@functools.lru_cache(maxsize=None)
def _jax_fixture_runs():
    """JAX's blocked runs on the fixture corpus, on one matcher (its
    lowerings reused): gate on, gate off, then the hot swap (the swap
    run's gate counters as the increments over that run)."""
    bm = JBlockedMatcher(ALL_PATTERNS, k_blk=4, **ENGINE_KW)
    out = {True: bm.membership_batch(ALL_DOCS)}
    gate, bm.prefilter = bm.prefilter, None
    out[False] = bm.membership_batch(ALL_DOCS)
    bm.prefilter = gate
    names = list(ALL_PATTERNS)
    info = bm.swap_patterns(bm.pattern_set.with_patterns(
        {names[i]: p for i, p in HOT_SWAP.items()}))
    c0 = _gate_counters(bm)
    res = bm.membership_batch(HOT_DOCS)
    c1 = _gate_counters(bm)
    out["swap"] = (info, res, (c1[0] - c0[0], c1[1] - c0[1]) + c1[2:])
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("prefilter", [True, False],
                         ids=["prefilter", "noprefilter"])
def test_blocked_conformance(prefilter, backend):
    bm = _port(ALL_PATTERNS, backend, k_blk=4, prefilter=prefilter,
               **ENGINE_KW)
    assert bm.n_blocks > 1
    res = bm.membership_batch(ALL_DOCS)
    want = _search_oracle(list(ALL_PATTERNS.values()), ALL_DOCS)
    np.testing.assert_array_equal(res.accepted, want)
    _same_result(res, _jax_fixture_runs()[prefilter])


@pytest.mark.parametrize("backend", BACKENDS)
def test_conformance_after_hot_swap(backend):
    names = list(ALL_PATTERNS)
    bm = _port(ALL_PATTERNS, backend, k_blk=4, **ENGINE_KW)
    swapped = {names[i]: p for i, p in HOT_SWAP.items()}
    info = bm.swap_patterns(bm.pattern_set.with_patterns(swapped))
    assert info["reused"] and info["rebuilt"]  # partial rebuild, not full
    res = bm.membership_batch(HOT_DOCS)
    want = _search_oracle(list({**ALL_PATTERNS, **swapped}.values()),
                          HOT_DOCS)
    np.testing.assert_array_equal(res.accepted, want)
    assert want[len(ALL_DOCS):, [0, 9]].any()  # swapped patterns exercised
    jinfo, jres, jcount = _jax_fixture_runs()["swap"]
    assert info == jinfo
    _same_result(res, jres)
    assert _gate_counters(bm) == jcount


def test_blocked_pallas_parity_small_k():
    """JAX's fused Pallas kernel (interpret mode) against the port's kernel
    lowering (plain versions on the CPU), gate on, at K = 13."""
    pats, docs = _soundness_case()
    jbm = JBlockedMatcher(pats, k_blk=4, backend="pallas", **KW)
    bm = _port(pats, "cuda", k_blk=4, **KW)
    _same_result(bm.membership_batch(docs), jbm.membership_batch(docs))
    assert _gate_counters(bm) == _gate_counters(jbm)
    kinds = {k for blk in bm.perf_report()["blocks"]
             for k in blk["lowerings"].values()}
    assert "spec-kernel" in kinds


def test_blocked_matcher_validates_and_reports():
    ps = PatternSet(["aa", "bb", "cc"], k_blk=2, search=True)
    with pytest.raises(ValueError, match="conflicts"):
        BlockedMatcher(ps, k_blk=3, device="cpu")
    bm = BlockedMatcher(ps, device="cpu", **KW)
    jbm = JBlockedMatcher(JPatternSet(["aa", "bb", "cc"], k_blk=2,
                                      search=True), **KW)
    assert repr(bm) == repr(jbm).replace("'local'", "'cuda'")
    assert bm.backend == "cuda" and bm.batch_tile == jbm.batch_tile
    empty = bm.membership_batch([])
    jempty = jbm.membership_batch([])
    assert empty.accepted.shape == jempty.accepted.shape == (0, 3)
    assert empty.bucket_calls == jempty.bucket_calls == 0
    assert all(m.device.type == "cpu" for m in bm.matchers)
