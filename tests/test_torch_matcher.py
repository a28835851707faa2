"""The port's ``Matcher`` main path against the JAX package's, on the CPU.

``backend="cuda"`` with ``device="cpu"`` is the port's kernel lowering run
through the kernels' plain versions; it is held against JAX
``backend="pallas"`` (Pallas in interpret mode), and the port's torch-eager
``backend="local"`` against JAX ``"local"``.  Finals, accept matrices,
segment and cursor ticks must agree exactly; ``early_exits`` only between
the matching lowerings (their granularities differ by design).  The re-based
conformance sweep of the JAX package runs on the port's CPU path too.
"""

import json
import pathlib
import re

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore

FIXTURES = json.loads((pathlib.Path(__file__).parent / "fixtures"
                       / "pattern_corpus.json").read_text())["entries"]
ALL_PATTERNS = {e["name"]: e["pattern"] for e in FIXTURES}
ALL_DOCS = sorted({s.encode() for e in FIXTURES
                   for s in e["positive"] + e["negative"]})

PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = np.frombuffer(b"abxy0189 ", np.uint8)
KW = dict(num_chunks=4, batch_tile=8, max_buckets=2)
PAIRS = [("pallas", "cuda"), ("local", "local")]


def _pair(backend_pair, patterns=PATTERNS, **kw):
    jb, tb = backend_pair
    jm = jcore.Matcher([jcore.make_search_dfa(jcore.compile_regex(p))
                        for p in patterns], backend=jb, **{**KW, **kw})
    tm = tcore.Matcher([tcore.make_search_dfa(tcore.compile_regex(p))
                        for p in patterns], backend=tb, device="cpu",
                       **{**KW, **kw})
    return jm, tm


def _docs(rng, lengths):
    return [bytes(rng.choice(ALPHABET, size=int(n))) for n in lengths]


# zero-length docs, docs shorter than 4C (seq path), and lengths whose chunk
# lengths span two sticky buckets (and a third that snaps up into them)
LENGTHS = [0, 3, 15, 16, 40, 64, 100, 130, 0, 7, 250, 33]


@pytest.mark.parametrize("backends", PAIRS, ids=["cuda-vs-pallas", "local"])
def test_membership_batch_agrees(backends):
    jm, tm = _pair(backends)
    rng = np.random.default_rng(1)
    for lengths in (LENGTHS, [20, 300, 5, 70]):
        docs = _docs(rng, lengths)
        jr, tr = jm.membership_batch(docs), tm.membership_batch(docs)
        np.testing.assert_array_equal(tr.final_states, jr.final_states)
        np.testing.assert_array_equal(tr.accepted, jr.accepted)
        np.testing.assert_array_equal(tr.time_steps, jr.time_steps)
        np.testing.assert_array_equal(tr.work_parallel, jr.work_parallel)
        assert tr.final_states.dtype == np.int32
        assert tr.early_exits == jr.early_exits
        assert tr.bucket_calls == jr.bucket_calls
    oracle = np.stack([tm.packed.run_all(d) for d in docs])
    np.testing.assert_array_equal(tr.final_states, oracle)
    rep, jrep = tm.perf_report(), jm.perf_report()
    assert rep.keys() == jrep.keys()
    assert (rep["spec_r"], rep["lane_width"]) == (jrep["spec_r"],
                                                  jrep["lane_width"])
    assert rep["kernel_skipped_steps"] == jrep["kernel_skipped_steps"]
    want_kinds = {"spec-kernel", "seq-torch"} if backends[1] == "cuda" else {
        "spec-torch", "seq-torch"}
    assert set(rep["lowerings"].values()) == want_kinds
    assert list(rep["lowerings"]) == list(jrep["lowerings"])


@pytest.mark.parametrize("backends", PAIRS, ids=["cuda-vs-pallas", "local"])
def test_advance_segments_agrees(backends):
    jm, tm = _pair(backends)
    rng = np.random.default_rng(2)
    docs = _docs(rng, [0, 9, 60, 130, 200, 31])
    cuts = [int(rng.integers(0, len(d) + 1)) for d in docs]
    heads = [d[:c] for d, c in zip(docs, cuts)]
    tails = [d[c:] for d, c in zip(docs, cuts)]
    entry = np.tile(tm.packed.starts, (len(docs), 1))
    jh, th = jm.advance_segments(heads, entry), tm.advance_segments(heads, entry)
    np.testing.assert_array_equal(th.final_states, jh.final_states)
    jt = jm.advance_segments(tails, jh.final_states)
    tt = tm.advance_segments(tails, th.final_states)
    for f in ("final_states", "absorbed", "lengths"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    assert (tt.bucket_calls, tt.padded_rows, tt.early_exits) == (
        jt.bucket_calls, jt.padded_rows, jt.early_exits)
    whole = tm.membership_batch(docs).final_states
    np.testing.assert_array_equal(tt.final_states, whole)


@pytest.mark.parametrize("backends", PAIRS, ids=["cuda-vs-pallas", "local"])
def test_advance_cursors_agrees(backends):
    jm, tm = _pair(backends)
    rng = np.random.default_rng(3)
    prefixes = _docs(rng, [2, 8, 5, 30, 3])
    segs = _docs(rng, [0, 120, 7, 64, 250])
    keys = np.array([tm.dev.advance_key(-1, p) for p in prefixes], np.int32)
    assert (keys >= 0).all()
    lanes = tm.dev.tables.candidates[keys].astype(np.int32)
    jr = jm.advance_cursors(segs, lanes, keys)
    tr = tm.advance_cursors(segs, lanes, keys)
    for f in ("lane_states", "absorbed", "lengths"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    assert (tr.bucket_calls, tr.padded_rows, tr.early_exits) == (
        jr.bucket_calls, jr.padded_rows, jr.early_exits)
    # exact cursors broadcast across the lanes collapse onto whole-doc finals
    entry = np.tile(tm.packed.starts, (len(prefixes), 1))
    head = tm.advance_segments(prefixes, entry).final_states
    exact = np.repeat(head[:, :, None], tm.dev.i_max, axis=2)
    got = tm.advance_cursors(segs, exact, keys).lane_states
    whole = tm.membership_batch([p + s for p, s in zip(prefixes, segs)])
    np.testing.assert_array_equal(
        got, np.repeat(whole.final_states[:, :, None], tm.dev.i_max, axis=2))
    kinds = set(tm.perf_report()["lowerings"].values())
    if backends[1] == "cuda":
        assert "spec-kernel-lanes" in kinds and "spec-torch" not in kinds


@pytest.mark.parametrize("r", [1, 2])
def test_hit_heavy_early_exit_agrees(r):
    """K = 1 on documents full of hits with a small kernel block: skipped
    blocks, early exits and finals equal the Pallas backend's."""
    jm, tm = _pair(PAIRS[0], patterns=[".*(ab|ba){2,6}"], lookahead_r=r)
    jm.executor.spec_l_blk[0] = 16
    tm.executor.spec_l_blk[0] = 16
    docs = [b"abab " * 40, b"xyz " * 50, b"q" * 90 + b"baba" * 20, b""]
    jr, tr = jm.membership_batch(docs), tm.membership_batch(docs)
    np.testing.assert_array_equal(tr.final_states, jr.final_states)
    assert tr.early_exits == jr.early_exits
    skipped = tm.executor.kernel_skipped_steps()
    assert skipped == jm.executor.kernel_skipped_steps() and skipped > 0
    # a tile whose rows are all absorbed returns without launching
    done = tm.advance_segments(docs[:1], tr.final_states[:1])
    np.testing.assert_array_equal(done.final_states, tr.final_states[:1])
    assert done.early_exits == jm.advance_segments(
        docs[:1], jr.final_states[:1]).early_exits


# --------------------------------------------------------------------------
# conformance against Python's re, on the port's CPU path


def _search_oracle(patterns, docs):
    rxs = [re.compile(p, re.DOTALL) for p in patterns]
    return np.array([[rx.search(d.decode("latin-1")) is not None
                      for rx in rxs] for d in docs])


def test_fixture_corpus_search_conformance():
    """All fixture patterns x all fixture docs on the kernel lowering, one
    pattern per matcher (one pack of all 34 has lane width S = 22,857, which
    the multi-pattern slice below covers at a smaller size)."""
    got = np.concatenate(
        [tcore.Matcher(tcore.PatternSet([p], search=True), device="cpu",
                       num_chunks=4, batch_tile=32).accepts_batch(ALL_DOCS)
         for p in ALL_PATTERNS.values()], axis=1)
    want = _search_oracle(list(ALL_PATTERNS.values()), ALL_DOCS)
    np.testing.assert_array_equal(got, want)
    assert want.any(axis=0).all()


@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_fixture_slice_search_conformance(backend):
    """Half pcre / half prosite fixture slice on both lowerings."""
    patterns = {e["name"]: e["pattern"] for e in FIXTURES[:4] + FIXTURES[-4:]}
    docs = [d for d in ALL_DOCS if len(d) <= 24][:48]
    ps = tcore.PatternSet(patterns, k_blk=1 << 30, search=True)
    got = tcore.Matcher(ps, backend=backend, device="cpu", num_chunks=4,
                        batch_tile=16).accepts_batch(docs)
    np.testing.assert_array_equal(
        got, _search_oracle(list(patterns.values()), docs))


@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_seeded_random_fullmatch_conformance(backend):
    patterns = ["(ab|ba){2,6}", "[0-9]+", "a[ab]*b", "x+y", "([a-y]0)*",
                "b.y"]
    m = tcore.Matcher([tcore.compile_regex(p) for p in patterns],
                      backend=backend, device="cpu", num_chunks=4,
                      batch_tile=16)
    rng = np.random.default_rng(7)
    docs = [bytes(rng.choice(np.frombuffer(b"ab01xy", np.uint8),
                             size=int(rng.integers(0, 65))))
            for _ in range(48)]
    rxs = [re.compile(p, re.DOTALL) for p in patterns]
    want = np.array([[rx.fullmatch(d.decode("latin-1")) is not None
                      for rx in rxs] for d in docs])
    np.testing.assert_array_equal(m.accepts_batch(docs), want)
    assert want.any()
