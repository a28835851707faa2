"""The paper's per-document engine of the port (``SpecDFAEngine`` /
``PaperSpecEngine``, its matchers, ``merge_scan_torch``, the
``BatchMatcher`` shim and the Eq. 1 capacity profiling) against the JAX
package's, on the CPU.

Every ``MatchResult`` field must equal the JAX engine's (zero tolerance:
states, decisions and the work model are integers) in all three modes, both
partitions, r = 1 and 2, with and without capacity weights, over P in
{1, 4, 8, 16} (the ``n < 4P`` sequential fall-back and a uniform tail
included), with the default torch matcher and with ``ops.spec_match`` on
both of its routes.  The port's DFAs are built from the JAX DFAs' arrays.

One difference is expected and asserted: the JAX engine's r = 2 balanced
fall-back re-classifies the class stream as if it were bytes
(``membership_sequential(cls_np)``), so its final state there can be wrong;
the port matches the class stream, equal to ``dfa.run``, with the same
work-model fields.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SpecDFAEngine as JEngine
from repro.core import compile_pattern_suite as j_suite
from repro.core import compile_regex as j_compile_regex
from repro.core import make_search_dfa as j_make_search_dfa
from repro.core import random_dfa as j_random_dfa
from repro.core import profiling as jprof

from repro_torch.core import DFA, BatchMatcher, Matcher, SpecDFAEngine
from repro_torch.core import match_chunks_lanes, merge_scan_torch
from repro_torch.core import sequential_state
from repro_torch.core import profiling as tprof
from repro_torch.core.engine import PaperSpecEngine
from repro_torch.kernels import ops

REGEXES = [r".*(ab|ba){2,4}", r".*[0-9]{3}[a-z]", r"a*b+c{2,5}"]
ALPHA = np.frombuffer(b"ab0123cxyz", np.uint8)
RESIDUES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
LENGTHS = (0, 3, 37, 777)
MODES = [("lookahead", 1), ("lookahead", 2), ("basic", 1), ("holub", 1)]


def _jdfa(name):
    if name.startswith("regex"):
        return j_make_search_dfa(j_compile_regex(REGEXES[int(name[-1])]))
    if name == "random":
        return j_random_dfa(20, 4, rng=np.random.default_rng(9))
    return j_suite("prosite", search=False)[name]


def _port(jd) -> DFA:
    return DFA(table=jd.table, accepting=jd.accepting, start=jd.start,
               sink=jd.sink, byte_to_class=jd.byte_to_class)


def _alphabet(name):
    return RESIDUES if name.startswith("PS") else ALPHA


def _fields(res):
    return dataclasses.astuple(res)


def _assert_same(j, t, oracle, why):
    """Equal fields, or the JAX r = 2 balanced fall-back's wrong final state
    beside the port's right one."""
    assert t.final_state == oracle, why
    if j.final_state == oracle:
        assert _fields(t) == _fields(j), why
    else:
        assert why[1:4] == ("lookahead", 2, "balanced"), why
        assert _fields(t)[2:] == _fields(j)[2:], why


DFAS = ["regex0", "regex1", "regex2", "PS00018_EF_HAND_1",
        "PS00028_ZINC_FINGER_C2H2", "random"]


@pytest.mark.parametrize("partition", ["balanced", "uniform"])
@pytest.mark.parametrize("mode,r", MODES, ids=[f"{m}-r{r}" for m, r in MODES])
@pytest.mark.parametrize("name", DFAS)
def test_engine_equals_jax(name, mode, r, partition):
    jd = _jdfa(name)
    td = _port(jd)
    rng = np.random.default_rng(len(name) + r)
    docs = [rng.choice(_alphabet(name), size=n) for n in LENGTHS]
    for p in (1, 4, 8, 16):
        for weighted in (False, True):
            if weighted and partition == "uniform":
                continue   # the uniform partition reads no weights
            w_j = jprof.profile_workers(jprof.synthetic_capacities(p))
            w_t = tprof.profile_workers(tprof.synthetic_capacities(p))
            np.testing.assert_array_equal(w_t, w_j)
            kw = dict(num_chunks=p, mode=mode, partition=partition,
                      lookahead_r=r, weights=w_j if weighted else None)
            jeng = JEngine(jd, **kw)
            kw["weights"] = w_t if weighted else None
            engines = {"default": SpecDFAEngine(td, device="cpu", **kw),
                       "spec_match": SpecDFAEngine(td, device="cpu",
                                                   matcher=ops.spec_match,
                                                   **kw)}
            for doc in docs:
                j = jeng.membership(doc)
                oracle = td.run(doc)
                for tag, eng in engines.items():
                    why = (name, mode, r, partition, p, weighted, len(doc),
                           tag)
                    _assert_same(j, eng.membership(doc), oracle, why)
                assert _fields(engines["default"].membership_sequential(doc)) \
                    == _fields(jeng.membership_sequential(doc))


@pytest.mark.parametrize("use_mxu", [None, True, False])
@pytest.mark.parametrize("mode", ["lookahead", "basic", "holub"])
def test_engine_with_spec_match_routes(mode, use_mxu):
    """``matcher=ops.spec_match`` with either route forced (the JAX
    package's kernel-backed engine test, in all three modes)."""
    jd = j_make_search_dfa(j_compile_regex(r".*(ab|ba){2,3}[0-9]"))
    td = _port(jd)
    data = np.random.default_rng(5).choice(
        np.frombuffer(b"ab019xyz", np.uint8), size=4096)

    def matcher(table, chunks, init):
        return ops.spec_match(table, chunks, init, use_mxu=use_mxu)

    for partition in ("balanced", "uniform"):
        eng = SpecDFAEngine(td, num_chunks=8, mode=mode, partition=partition,
                            matcher=matcher, device="cpu")
        want = JEngine(jd, num_chunks=8, mode=mode,
                       partition=partition).membership(data)
        assert _fields(eng.membership(data)) == _fields(want)
        assert eng.membership(data).final_state == td.run(data)


def test_r2_balanced_fallback_matches_the_class_stream():
    """EF-hand at n = 32 and P = 8 under r = 2: L_spec < 2 sends the
    balanced partition to its sequential fall-back.  The JAX engine
    re-classifies class ids there and ends in state 0; the port ends where
    ``dfa.run`` does, with the JAX work-model fields."""
    from repro.core import PROSITE_PATTERNS, prosite_to_regex

    jd = j_make_search_dfa(j_compile_regex(
        ".*(" + prosite_to_regex(PROSITE_PATTERNS["PS00018_EF_HAND_1"]) + ")"))
    td = _port(jd)
    data = np.random.default_rng(1).choice(RESIDUES, size=32)
    kw = dict(num_chunks=8, mode="lookahead", lookahead_r=2,
              partition="balanced")
    j = JEngine(jd, **kw).membership(data)
    t = SpecDFAEngine(td, device="cpu", **kw).membership(data)
    assert t.final_state == td.run(data) == 103
    assert j.final_state == 0
    assert _fields(t)[2:] == _fields(j)[2:] == (32, 32, 32, "lookahead")


# -- tests/test_core_edge_cases.py, on the port -------------------------------

def test_empty_input():
    jd = j_compile_regex("a*")
    for mode in ("lookahead", "basic", "holub"):
        res = SpecDFAEngine(_port(jd), num_chunks=4, mode=mode,
                            device="cpu").membership(b"")
        assert res.accepted and res.final_state == jd.start
        assert _fields(res) == _fields(
            JEngine(jd, num_chunks=4, mode=mode).membership(b""))


def test_input_shorter_than_chunks():
    jd = j_compile_regex("ab*")
    res = SpecDFAEngine(_port(jd), num_chunks=16, mode="lookahead",
                        device="cpu").membership(b"abb")
    assert res.accepted and res.mode == "sequential"
    assert _fields(res) == _fields(JEngine(jd, num_chunks=16).membership(b"abb"))


def test_single_chunk_degenerates_to_sequential():
    jd = j_compile_regex("[ab]+")
    res = SpecDFAEngine(_port(jd), num_chunks=1,
                        device="cpu").membership(b"abab" * 100)
    assert res.accepted and res.work_parallel == res.work_sequential
    assert _fields(res) == _fields(
        JEngine(jd, num_chunks=1).membership(b"abab" * 100))


def test_weights_must_match_chunks():
    with pytest.raises(ValueError):
        SpecDFAEngine(_port(j_compile_regex("a")), num_chunks=4,
                      weights=np.ones(3), device="cpu")
    with pytest.raises(ValueError):
        PaperSpecEngine(_port(j_compile_regex("a")), mode="other",
                        device="cpu")


def test_weighted_engine_balanced_correctness():
    jd = j_make_search_dfa(j_compile_regex(r".*ab{2,4}c"))
    data = np.random.default_rng(0).choice(np.frombuffer(b"abcx", np.uint8),
                                           size=9999)
    w = np.array([2.0, 1.0, 1.0, 0.5])
    w = w / w.mean()
    for matcher in (None, ops.spec_match):
        eng = SpecDFAEngine(_port(jd), num_chunks=4, weights=w,
                            partition="balanced", matcher=matcher,
                            device="cpu")
        res = eng.membership(data)
        assert res.final_state == eng.membership_sequential(data).final_state
        assert _fields(res) == _fields(JEngine(jd, num_chunks=4, weights=w,
                                               partition="balanced")
                                       .membership(data))


def test_engine_properties_equal_jax():
    jd = _jdfa("PS00018_EF_HAND_1")
    for mode in ("lookahead", "basic", "holub"):
        j = JEngine(jd, mode=mode)
        t = SpecDFAEngine(_port(jd), mode=mode, device="cpu")
        assert (t.gamma, t.i_max, t.lanes_per_chunk, t.partition) == (
            j.gamma, j.i_max, j.lanes_per_chunk, j.partition)
        assert t.accepts(b"DKDGDGTITTKE") == j.accepts(b"DKDGDGTITTKE")


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecDFAEngine(_port(j_compile_regex("ab")))
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.profile_capacity(n_symbols=100)


# -- the matchers and the full-map scan ---------------------------------------

def test_sequential_state_and_match_chunks_lanes_equal_jax():
    import jax.numpy as jnp
    from repro.core.engine import match_chunks_lanes as j_mcl
    from repro.core.engine import sequential_state as j_seq

    jd = j_random_dfa(33, 5, rng=np.random.default_rng(2))
    rng = np.random.default_rng(3)
    cls = rng.integers(0, 5, size=(6, 301)).astype(np.int32)
    init = rng.integers(0, 33, size=(6, 7)).astype(np.int32)
    table = torch.from_numpy(jd.table)
    got = match_chunks_lanes(table, torch.from_numpy(cls),
                             torch.from_numpy(init))
    want = j_mcl(jnp.asarray(jd.table), jnp.asarray(cls), jnp.asarray(init))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for start in (0, 5, 32):
        s = sequential_state(table, torch.from_numpy(cls[0]), start)
        assert s.dtype == torch.int32 and s.dim() == 0
        assert int(s) == int(j_seq(jnp.asarray(jd.table),
                                   jnp.asarray(cls[0]), start))


@pytest.mark.parametrize("c", [1, 2, 5, 16, 33])
def test_merge_scan_torch_equals_jax(c):
    import jax.numpy as jnp
    from repro.core.lvector import merge_scan_jnp

    maps = np.random.default_rng(c).integers(0, 23, size=(c, 23)).astype(
        np.int32)
    want = np.asarray(merge_scan_jnp(jnp.asarray(maps)))
    got = merge_scan_torch(torch.from_numpy(maps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- tests/test_compat_shims.py, on the port ----------------------------------

def _shim_dfas(compile_regex, make_search_dfa):
    return [make_search_dfa(compile_regex(p))
            for p in (".*(ab|ba){2}", ".*[0-9]{3}")]


def test_batch_matcher_shim_warns_and_matches_facade():
    from repro_torch.core import compile_regex, make_search_dfa

    dfas = _shim_dfas(compile_regex, make_search_dfa)
    rng = np.random.default_rng(50)
    docs = [rng.choice(np.frombuffer(b"abxy0189", np.uint8),
                       size=int(n)).tobytes() for n in [0, 5, 40, 300]]
    want = Matcher(dfas, num_chunks=8, device="cpu").membership_batch(docs)
    with pytest.deprecated_call():
        bm = BatchMatcher(dfas, num_chunks=8, device="cpu")
    assert bm.backend == "local" and bm.use_kernel is False
    np.testing.assert_array_equal(bm.membership_batch(docs).final_states,
                                  want.final_states)
    with pytest.deprecated_call():
        bmk = BatchMatcher(dfas, num_chunks=8, use_kernel=True, device="cpu")
    assert bmk.backend == "cuda" and bmk.use_kernel is True
    np.testing.assert_array_equal(bmk.membership_batch(docs).final_states,
                                  want.final_states)
    jdfas = _shim_dfas(j_compile_regex, j_make_search_dfa)
    from repro.core import Matcher as JMatcher
    np.testing.assert_array_equal(
        want.final_states,
        JMatcher(jdfas, num_chunks=8).membership_batch(docs).final_states)


def test_spec_dfa_engine_membership_batch_agrees():
    jd = _shim_dfas(j_compile_regex, j_make_search_dfa)[0]
    eng = SpecDFAEngine(_port(jd), num_chunks=8, device="cpu")
    jeng = JEngine(jd, num_chunks=8)
    rng = np.random.default_rng(51)
    docs = [rng.choice(np.frombuffer(b"abxy0189", np.uint8), size=n)
            for n in (0, 3, 64, 500)]
    batch = eng.membership_batch(docs)
    assert eng._batch.device.type == "cpu"
    np.testing.assert_array_equal(batch.final_states,
                                  jeng.membership_batch(docs).final_states)
    for i, doc in enumerate(docs):
        res = eng.membership(doc)
        assert res.accepted == bool(batch.accepted[i, 0])
        assert res.final_state == int(batch.final_states[i, 0])
        assert res.final_state == eng.membership_sequential(doc).final_state


# -- Eq. 1 capacity profiling ---------------------------------------------------

@pytest.mark.parametrize("n,n_fast,ratio", [(1, None, 1.41), (40, None, 1.41),
                                            (7, 3, 2.0), (5, 0, 1.41)])
def test_synthetic_capacities_and_weights_equal_jax(n, n_fast, ratio):
    caps = tprof.synthetic_capacities(n, ratio=ratio, n_fast=n_fast)
    np.testing.assert_array_equal(
        caps, jprof.synthetic_capacities(n, ratio=ratio, n_fast=n_fast))
    np.testing.assert_array_equal(tprof.profile_workers(caps),
                                  jprof.profile_workers(caps))
    with pytest.raises(ValueError):
        tprof.synthetic_capacities(0)
    with pytest.raises(ValueError):
        tprof.synthetic_capacities(3, n_fast=4)


def test_profile_capacity_on_cpu():
    cap = tprof.profile_capacity(n_symbols=5000, repeats=3, device="cpu")
    assert isinstance(cap, float) and cap > 0
    caps = tprof.profile_capacity(n_symbols=2000, repeats=2,
                                  devices=["cpu", torch.device("cpu")])
    assert caps.shape == (2,) and (caps > 0).all()


def test_calibrated_capacities_cache():
    tprof.clear_calibration_cache()
    dfa = _port(j_random_dfa(16, 4, rng=np.random.default_rng(1)))
    kw = dict(n_symbols=2000, repeats=2)
    first = tprof.calibrated_capacities(["cpu"], dfa, **kw)
    first[0] = -1.0                              # a copy: the cache keeps its own
    again = tprof.calibrated_capacities(["cpu"], dfa, **kw)
    assert again.shape == (1,) and again[0] > 0
    assert tprof.calibrated_capacities(["cpu"], dfa, **kw)[0] == again[0]
    fresh = tprof.calibrated_capacities(["cpu"], dfa, refresh=True, **kw)
    assert fresh[0] > 0
    assert tprof.calibrated_capacities(["cpu"], dfa, **kw)[0] == fresh[0]
    jd = j_random_dfa(16, 4, rng=np.random.default_rng(1))
    assert tprof._calibration_key(["cpu"], dfa, 2000, 2, 0) == \
        jprof._calibration_key(["cpu"], jd, 2000, 2, 0)
    assert tprof._calibration_key(["cpu"], None, 2000, 2, 0) == \
        jprof._calibration_key(["cpu"], None, 2000, 2, 0)
    tprof.clear_calibration_cache()
    assert not tprof._CALIBRATION_CACHE
