"""The port's shape autotuner and observed-traffic retune loop against the
JAX package, on the CPU.

Mirrors the autotuner rows of tests/test_lanes_kernel.py and the
observed-traffic rows of tests/test_compose_kernel.py (without the sharded
mesh rows: the port's sharded backend is not there yet, only the mesh
arithmetic).  The JAX package's ``pallas`` backend searches ``l_blk`` where
the port's ``cuda`` backend does; under one shared ``time_fn`` both
packages must pick the same ``TunedShape``.  Port matchers run on
``device="cpu"`` (the ``cuda`` backend then runs the kernels' plain
versions); JAX matchers on ``backend="local"``.  Every compared value is a
count, a shape or a state id, so every comparison is exact.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.core.profiling as jprof
import repro_torch.core.profiling as prof
from repro.core import Matcher as JMatcher
from repro.core import compile_regex as j_compile_regex
from repro.core import make_search_dfa as j_make_search_dfa
from repro.core import pack_dfas as j_pack_dfas
from repro_torch.core import Matcher, compile_regex, make_search_dfa, pack_dfas
from repro_torch.core.profiling import (CUDA_L_BLK_CANDIDATES, ObservedTraffic,
                                        TrafficProfile, TunedShape,
                                        autotune_spec_shapes,
                                        clear_autotune_cache,
                                        synthetic_traffic)

PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = list(b"abxy0189")
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    """Both packages' in-process autotune caches empty, no disk cache."""
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    clear_autotune_cache()
    jprof.clear_autotune_cache()
    yield
    clear_autotune_cache()
    jprof.clear_autotune_cache()


def _toy_packed():
    return pack_dfas([make_search_dfa(compile_regex(".*ab+c"))])


def _j_toy_packed():
    return j_pack_dfas([j_make_search_dfa(j_compile_regex(".*ab+c"))])


def _matcher(backend="local", **kw):
    dfas = [make_search_dfa(compile_regex(p)) for p in PATTERNS]
    kw.setdefault("num_chunks", 2)
    kw.setdefault("batch_tile", 8)
    return Matcher(dfas, backend=backend, device="cpu", **kw)


def _j_matcher(**kw):
    dfas = [j_make_search_dfa(j_compile_regex(p)) for p in PATTERNS]
    kw.setdefault("num_chunks", 2)
    kw.setdefault("batch_tile", 8)
    return JMatcher(dfas, backend="local", **kw)


def _docs(seed, lengths):
    rng = np.random.default_rng(seed)
    return [bytes(rng.choice(ALPHABET, size=int(n)).astype(np.uint8))
            for n in lengths]


# --------------------------------------------------------------------------
# the autotuner
# --------------------------------------------------------------------------

def test_autotune_picks_measured_winner_and_caches():
    packed = _toy_packed()
    seen = []

    def fake(cfg):
        seen.append(cfg)
        return {4: 300.0, 8: 100.0, 16: 200.0}[cfg["num_chunks"]]

    t = autotune_spec_shapes(packed, backend="local",
                             num_chunks_candidates=[4, 8, 16], time_fn=fake,
                             **CPU)
    assert isinstance(t, TunedShape)
    assert t.num_chunks == 8 and t.us_per_call == 100.0
    assert t.l_blk == 0 and t.source == "measured"  # local: no l_blk search
    assert {c["num_chunks"] for c in seen} == {4, 8, 16}
    # second call is a pure in-process cache hit
    n_calls = len(seen)
    t2 = autotune_spec_shapes(packed, backend="local",
                              num_chunks_candidates=[4, 8, 16], time_fn=fake,
                              **CPU)
    assert len(seen) == n_calls and t2.source == "cache"
    assert dataclasses.asdict(t2)["num_chunks"] == 8


def test_autotune_searches_l_blk_on_cuda_and_mesh_arithmetic():
    packed = _toy_packed()
    t = autotune_spec_shapes(packed, backend="cuda",
                             num_chunks_candidates=[4],
                             l_blk_candidates=[128, 256, 512],
                             time_fn=lambda c: float(c["l_blk"]), **CPU)
    assert t.l_blk == 128
    # the default candidates: powers of two, the block B1's ring tile divides
    seen = []
    t = autotune_spec_shapes(packed, backend="cuda",
                             num_chunks_candidates=[4],
                             time_fn=lambda c: seen.append(c["l_blk"]) or 1.0,
                             **CPU)
    assert set(seen) == set(CUDA_L_BLK_CANDIDATES)
    assert all(b & (b - 1) == 0 for b in CUDA_L_BLK_CANDIDATES)
    # the JAX package's pallas candidates are not the port's cuda ones
    assert t.l_blk == CUDA_L_BLK_CANDIDATES[0]
    ts = autotune_spec_shapes(
        packed, backend="sharded", num_chunks_candidates=[4],
        mesh_shape="auto", devices=8,
        # prefer wide chunk axes: (1, 8) must win over near-square (2, 4)
        time_fn=lambda c: float(c["mesh_shape"][0]), **CPU)
    assert ts.mesh_shape == (1, 8) and ts.l_blk == 0


def test_measured_sharded_tune_needs_the_sharded_backend():
    with pytest.raises(NotImplementedError, match="A14"):
        autotune_spec_shapes(_toy_packed(), backend="sharded",
                             num_chunks_candidates=[4], mesh_shape="auto",
                             devices=2, repeats=1, **CPU)


@pytest.mark.parametrize("jax_backend,backend",
                         [("local", "local"), ("pallas", "cuda")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_time_fn_picks_equal_shapes_in_both_packages(jax_backend,
                                                            backend, seed):
    rng = np.random.default_rng(seed)
    table = {(nc, lb): float(rng.integers(1, 1000))
             for nc in (2, 4, 8, 16) for lb in (0, 128, 256, 512, 1024)}
    time_fn = lambda c: table[(c["num_chunks"], c["l_blk"])]  # noqa: E731
    kw = dict(num_chunks_candidates=[2, 4, 8, 16],
              l_blk_candidates=[128, 256, 512, 1024], time_fn=time_fn)
    want = jprof.autotune_spec_shapes(_j_toy_packed(), backend=jax_backend,
                                      **kw)
    got = autotune_spec_shapes(_toy_packed(), backend=backend, **kw, **CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mesh_arithmetic_equals_jax():
    kw = dict(backend="sharded", num_chunks_candidates=[4, 8],
              mesh_shape="auto", devices=12,
              time_fn=lambda c: float(abs(c["mesh_shape"][0] - 3)
                                      + c["num_chunks"]))
    want = jprof.autotune_spec_shapes(_j_toy_packed(), **kw)
    got = autotune_spec_shapes(_toy_packed(), **kw, **CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mesh_shape == (3, 4)


def test_autotune_disk_cache_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    packed = _toy_packed()
    calls = []

    def fake(cfg):
        calls.append(cfg)
        return 50.0

    t = autotune_spec_shapes(packed, backend="cuda",
                             num_chunks_candidates=[4], time_fn=fake, **CPU)
    assert t.source == "measured" and path.is_file()
    clear_autotune_cache()  # drop in-process memory: force the disk path
    n_calls = len(calls)
    t2 = autotune_spec_shapes(packed, backend="cuda",
                              num_chunks_candidates=[4], time_fn=fake, **CPU)
    assert t2.source == "disk" and len(calls) == n_calls
    assert (t2.num_chunks, t2.l_blk) == (t.num_chunks, t.l_blk)
    # refresh re-measures and overwrites
    t3 = autotune_spec_shapes(packed, backend="cuda",
                              num_chunks_candidates=[4], time_fn=fake,
                              refresh=True, **CPU)
    assert t3.source == "measured" and len(calls) > n_calls
    # the disk rows keep the JAX package's schema
    jpath = tmp_path / "jax.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jpath))
    jprof.autotune_spec_shapes(_j_toy_packed(), backend="pallas",
                               num_chunks_candidates=[4], time_fn=fake)
    rows, jrows = (list(json.loads(p.read_text()).values())
                   for p in (path, jpath))
    assert len(rows) == len(jrows) == 1
    assert rows[0].keys() == jrows[0].keys()
    assert {k: v for k, v in rows[0].items() if k != "l_blk"} == \
        {k: v for k, v in jrows[0].items() if k != "l_blk"}


def test_cache_key_holds_the_device():
    packed = _toy_packed()
    key = prof._autotune_key(packed, "cuda", [4], [256], None, None, "auto",
                             device=prof.resolve_device("cpu"))
    assert key == prof._autotune_key(packed, "cuda", [4], [256], None, None,
                                     "auto",
                                     device=prof.resolve_device("cpu"))
    assert prof._device_sig(prof.resolve_device("cpu")) == ("cpu", None)
    assert key != prof._autotune_key(packed, "local", [4], [], None, None,
                                     "auto",
                                     device=prof.resolve_device("cpu"))


def test_matcher_autotune_applies_tuned_shape(monkeypatch):
    def fake_tune(packed, **kw):
        assert kw["backend"] == "cuda" and kw["device"].type == "cpu"
        return prof.TunedShape(num_chunks=4, mesh_shape=None, l_blk=256,
                               us_per_call=1.0, source="measured")

    monkeypatch.setattr(prof, "autotune_spec_shapes", fake_tune)
    m = Matcher(_toy_packed(), backend="cuda", num_chunks=8, autotune=True,
                **CPU)
    assert m.num_chunks == 4
    assert m.executor.spec_l_blk[0] == 256
    assert m.perf_report()["autotune"]["l_blk"] == 256


def test_matcher_autotune_measures_on_its_device():
    """A real (timed) tune on the CPU: the winner is one of the candidates,
    a second matcher reads it from the cache, results equal an untuned
    matcher's."""
    m = _matcher("cuda", autotune=True)
    rep = m.perf_report()["autotune"]
    assert rep["source"] == "measured" and rep["us_per_call"] > 0
    assert rep["num_chunks"] in (2, 4, 8)
    assert rep["l_blk"] in CUDA_L_BLK_CANDIDATES
    assert _matcher("cuda", autotune=True).perf_report()["autotune"][
        "source"] == "cache"
    docs = _docs(3, [0, 5, 300, 900])
    np.testing.assert_array_equal(
        m.membership_batch(docs).final_states,
        _matcher("local").membership_batch(docs).final_states)


# --------------------------------------------------------------------------
# observed traffic
# --------------------------------------------------------------------------

def test_traffic_profile_snapshot_and_drift():
    p = TrafficProfile(max_samples=64)
    assert p.snapshot() is None
    for _ in range(10):
        p.record(4, np.full(4, 256))
    obs = p.snapshot()
    assert obs.batch == 4 and int(np.median(obs.lengths)) == 256
    assert p.n_tiles == 10 and p.n_docs == 40
    # drift is a symmetric log2 distance: 256 -> 2048 is 3 octaves
    far = ObservedTraffic(batch=4, lengths=(2048,) * 4)
    assert obs.drift(far) == pytest.approx(3.0, abs=0.1)
    assert obs.drift(obs) == pytest.approx(0.0, abs=1e-9)
    syn = synthetic_traffic()
    assert syn.batch == 8 and len(syn.lengths) == 8
    with pytest.raises(ValueError, match="max_samples"):
        TrafficProfile(max_samples=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_traffic_profile_equals_jax(seed):
    rng = np.random.default_rng(seed)
    p, jp = TrafficProfile(max_samples=37), jprof.TrafficProfile(max_samples=37)
    for _ in range(25):
        b = int(rng.integers(1, 9))
        lens = rng.integers(0, 5000, size=b)
        p.record(b, lens)
        jp.record(b, lens)
    for probe in (4, 8, 13):
        got, want = p.snapshot(probe), jp.snapshot(probe)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (p.n_tiles, p.n_docs, p.n_samples) == \
        (jp.n_tiles, jp.n_docs, jp.n_samples)
    other = ObservedTraffic(batch=3, lengths=(100, 7000, 9))
    jother = jprof.ObservedTraffic(batch=3, lengths=(100, 7000, 9))
    assert p.snapshot().drift(other) == jp.snapshot().drift(jother)
    for args in ((), (3, 100), (16, 4096)):
        assert dataclasses.asdict(synthetic_traffic(*args)) == \
            dataclasses.asdict(jprof.synthetic_traffic(*args))
    assert prof._observed_corpus(p.snapshot()).__len__() == 8
    for a, b in zip(prof._observed_corpus(p.snapshot()),
                    jprof._observed_corpus(jp.snapshot())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_perf_report_traffic_equals_jax(backend):
    m, jm = _matcher(backend), _j_matcher()
    assert m.perf_report()["traffic"] is None
    rng = np.random.default_rng(7)
    for _ in range(3):
        docs = _docs(int(rng.integers(1 << 20)),
                     rng.integers(0, 1500, size=int(rng.integers(1, 20))))
        m.membership_batch(docs)
        jm.membership_batch(docs)
    rep, jrep = m.perf_report(), jm.perf_report()
    assert rep["traffic"] == jrep["traffic"]
    assert rep["retunes"] == jrep["retunes"] == 0
    assert rep["autotune"] is jrep["autotune"] is None
    assert dataclasses.asdict(m.traffic_profile()) == \
        dataclasses.asdict(jm.traffic_profile())


def test_maybe_retune_requires_autotune():
    m = _matcher()
    with pytest.raises(ValueError, match="autotune"):
        m.maybe_retune()


@pytest.fixture
def fast_autotune(monkeypatch):
    """Real autotuner, deterministic clock: construction-time tunes (which
    would otherwise measure real probe workloads) take the injected
    ``time_fn`` path unless the caller supplies their own."""
    real = prof.autotune_spec_shapes

    def wrapped(packed, **kw):
        if kw.get("time_fn") is None:
            kw["time_fn"] = lambda cfg: 1.0
        return real(packed, **kw)

    monkeypatch.setattr(prof, "autotune_spec_shapes", wrapped)
    yield


def test_maybe_retune_applies_observed_shape(fast_autotune):
    m = _matcher("cuda", autotune=True)
    assert m.retunes == 0
    # no traffic yet: nothing to retune on
    assert not m.maybe_retune(time_fn=lambda c: 1.0)
    docs = _docs(85, [4096] * 8)
    for _ in range(16):
        m.membership_batch(docs)
    assert m.traffic.n_docs >= 64
    obs = m.traffic_profile()
    assert obs is not None and int(np.median(obs.lengths)) == 4096
    # observed 4096-byte docs vs the 2048-byte synthetic probe: 1 octave,
    # below this threshold -> gated
    assert not m.maybe_retune(drift_threshold=1.5, time_fn=lambda c: 1.0)

    def prefer_big_blocks(cfg):
        return {0: 10.0, 256: 5.0, 512: 3.0, 1024: 2.0, 2048: 1.5,
                4096: 1.0}.get(cfg.get("l_blk", 0), 10.0)

    assert m.maybe_retune(drift_threshold=0.5, time_fn=prefer_big_blocks)
    assert m.retunes == 1 and m.executor.spec_l_blk[0] == 4096
    # spec-kernel lowerings were dropped so the tuned shape takes effect
    kinds = set(m.executor.lowering_kinds.values())
    assert not any(k.startswith("spec-kernel") for k in kinds)
    m.membership_batch(docs)  # re-lowers at the tuned shape, bit-identical
    kinds = set(m.executor.lowering_kinds.values())
    assert any(k.startswith("spec-kernel") for k in kinds)
    # freshly re-tuned: the same traffic no longer drifts
    assert not m.maybe_retune(drift_threshold=0.5, time_fn=lambda c: 1.0)
    # force skips the drift gate, not the traffic requirement
    assert m.maybe_retune(force=True, time_fn=prefer_big_blocks)
    assert not m.maybe_retune(force=True, min_docs=10 ** 6,
                              time_fn=prefer_big_blocks)
    assert m.perf_report()["retunes"] == 2


def test_invalidate_block_sizes_keeps_other_lowerings():
    m = _matcher("cuda")
    docs = _docs(4, [3, 700, 1500])   # a seq bucket and a spec bucket
    m.membership_batch(docs)
    kinds = set(m.executor.lowering_kinds.values())
    assert kinds == {"seq-torch", "spec-kernel"}
    m.executor.invalidate_block_sizes()
    assert list(m.executor.lowering_kinds.values()) == ["seq-torch"]
    assert len(m.executor._lowered) == 1


@pytest.mark.parametrize("seed", [86, 87])
def test_retune_keeps_results_bit_identical(fast_autotune, seed):
    rng = np.random.default_rng(seed)
    docs = _docs(seed, rng.integers(100, 2000, size=12))
    m = _matcher("cuda", autotune=True)
    want = m.membership_batch(docs)
    for _ in range(8):
        m.membership_batch(docs)
    assert m.maybe_retune(force=True,
                          time_fn=lambda c: float(c.get("l_blk") or 64))
    assert m.executor.spec_l_blk[0] == CUDA_L_BLK_CANDIDATES[0]
    got = m.membership_batch(docs)
    np.testing.assert_array_equal(got.final_states, want.final_states)
    np.testing.assert_array_equal(got.accepted, want.accepted)
    jwant = _j_matcher(num_chunks=m.num_chunks).membership_batch(docs)
    np.testing.assert_array_equal(got.final_states, jwant.final_states)
    assert m.perf_report()["retunes"] == 1
    assert m.perf_report()["traffic"]["n_docs"] >= 96
