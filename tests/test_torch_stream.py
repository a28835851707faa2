"""The port's in-order streaming tier (``StreamMatcher``, the micro-batch
scheduler, fault injection) against whole-document matching and against the
JAX package, on the CPU.

Mirrors tests/test_streaming.py and the scheduler half of
tests/test_fault_tolerance.py: any segmentation of a document — empty
segments, 1-byte dribbles, random splits — closes to the
``membership_batch`` decision bit for bit, the tick policies coalesce as
specified, and injected dispatch faults lose no byte and compose none twice.
Every output is a state id or a count, so every comparison is exact.
"""

import numpy as np
import pytest

from repro.core import compile_regex as j_compile_regex
from repro.core import make_search_dfa as j_make_search_dfa
from repro.streaming import StreamMatcher as JStreamMatcher
from repro.streaming import TickPolicy as JTickPolicy
from repro_torch.core import (Matcher, compile_regex, make_search_dfa,
                              pack_dfas, random_dfa)
from repro_torch.distributed import RestartManager, StragglerPolicy
from repro_torch.streaming import (FaultPlan, InjectedFault, RetryPolicy,
                                   StreamMatcher, TickPolicy, merge_calls,
                                   reset_merge_calls)

PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = np.frombuffer(b"abxy0189", np.uint8)
LAZY = TickPolicy(max_batch=1 << 30, max_delay=1 << 30)  # explicit flush


def _dfas(patterns=PATTERNS):
    return [make_search_dfa(compile_regex(p)) for p in patterns]


def _matcher(patterns=PATTERNS, **kw):
    return Matcher(_dfas(patterns), device="cpu", **kw)


def _docs(rng, sizes):
    return [rng.choice(ALPHABET, size=int(n)).tobytes() for n in sizes]


def _random_splits(rng, doc, n_cuts):
    cuts = sorted(rng.integers(0, len(doc) + 1, size=n_cuts).tolist())
    bounds = [0] + cuts + [len(doc)]
    return [doc[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _feed_stream(sm, segments):
    s = sm.open()
    for seg in segments:
        s.feed(seg)
    return s.close()


@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_segment_split_invariance(backend):
    """Both backends (on CPU tensors "cuda" runs the kernels' plain
    versions); the finals equal the JAX package's whole-document finals."""
    from repro.core import Matcher as JMatcher

    rng = np.random.default_rng(40)
    m = _matcher(num_chunks=8, batch_tile=8, backend=backend)
    docs = _docs(rng, [0, 1, 2, 31, 32, 100, 400, 999])
    want = m.membership_batch(docs)
    jwant = JMatcher([j_make_search_dfa(j_compile_regex(p))
                      for p in PATTERNS]).membership_batch(docs)
    np.testing.assert_array_equal(want.final_states, jwant.final_states)
    sm = StreamMatcher(m, policy=TickPolicy(max_batch=4, max_delay=3))
    for i, doc in enumerate(docs):
        segments = _random_splits(rng, doc, int(rng.integers(0, 8)))
        res = _feed_stream(sm, segments)
        np.testing.assert_array_equal(res.final_states, want.final_states[i],
                                      err_msg=f"doc {i} split {len(segments)}")
        np.testing.assert_array_equal(res.accepted, want.accepted[i])
        assert res.byte_count == len(doc)


def test_default_matcher_is_the_seq_lowering():
    sm = StreamMatcher(_dfas(), device="cpu")
    assert sm.matcher.num_chunks == 1 and sm.matcher.device.type == "cpu"
    doc = b"xx abab 123 xy"
    res = _feed_stream(sm, [doc[:5], doc[5:]])
    np.testing.assert_array_equal(res.final_states,
                                  sm.matcher.packed.run_all(doc))


def test_empty_and_single_byte_segments():
    rng = np.random.default_rng(41)
    m = _matcher(num_chunks=4)
    doc = rng.choice(ALPHABET, size=73).tobytes()
    want = m.membership_batch([doc])
    sm = StreamMatcher(m)  # eager flush: every feed is its own tick
    s = sm.open()
    for i in range(len(doc)):
        s.feed(b"")
        s.feed(doc[i:i + 1])
    res = s.close()
    np.testing.assert_array_equal(res.final_states, want.final_states[0])
    empty = sm.open().close()
    np.testing.assert_array_equal(
        empty.accepted, m.packed.accepting[m.packed.starts])
    assert empty.byte_count == 0


def test_streaming_random_dfa_property():
    rng = np.random.default_rng(42)
    for trial in range(3):
        packed = pack_dfas([random_dfa(int(rng.integers(3, 16)),
                                       int(rng.integers(2, 6)), rng=rng)
                            for _ in range(int(rng.integers(1, 4)))])
        m = Matcher(packed, num_chunks=4, batch_tile=4, device="cpu")
        sm = StreamMatcher(m, policy=TickPolicy(max_batch=3, max_delay=2))
        for n in (0, 1, 17, 300):
            doc = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            segments = _random_splits(rng, doc, int(rng.integers(0, 5)))
            res = _feed_stream(sm, segments)
            np.testing.assert_array_equal(res.final_states,
                                          packed.run_all(doc),
                                          err_msg=str((trial, n)))


def test_tick_stats_match_jax():
    """The same feed schedule gives the same ticks, segments, evictions and
    decisions in both packages."""
    rng = np.random.default_rng(43)
    docs = _docs(rng, [40, 64, 7, 120, 90])
    policy = dict(max_batch=3, max_delay=4)
    sm = StreamMatcher(_dfas(), policy=TickPolicy(**policy), device="cpu")
    jsm = JStreamMatcher([j_make_search_dfa(j_compile_regex(p))
                          for p in PATTERNS], policy=JTickPolicy(**policy))
    ts, js = [sm.open() for _ in docs], [jsm.open() for _ in docs]
    for lo in range(0, 120, 16):
        for t, j, d in zip(ts, js, docs):
            t.feed(d[lo:lo + 16])
            j.feed(d[lo:lo + 16])
    for t, j in zip(ts, js):
        np.testing.assert_array_equal(t.close().final_states,
                                      j.close().final_states)
    for field in ("ticks", "feeds", "empty_feeds", "segments",
                  "absorbed_skips", "evicted", "bytes_fed", "bytes_matched"):
        assert getattr(sm.stats, field) == getattr(jsm.stats, field), field


def test_eager_policy_ticks_every_feed():
    sm = StreamMatcher(_matcher([PATTERNS[1]]))
    s = sm.open()
    for _ in range(5):
        s.feed(b"abba")
    assert sm.stats.ticks == 5 and sm.stats.segments == 5
    s.close()


def test_max_batch_policy_coalesces():
    m = _matcher([PATTERNS[1]])
    sm = StreamMatcher(m, policy=TickPolicy(max_batch=4, max_delay=100))
    streams = [sm.open() for _ in range(4)]
    for s in streams[:3]:
        s.feed(b"ab" * 10)
    assert sm.stats.ticks == 0
    streams[3].feed(b"ba" * 10)
    assert sm.stats.ticks == 1 and sm.stats.segments == 4
    streams[0].feed(b"ab")
    streams[0].feed(b"b8")
    streams[0].feed(b"ab")
    sm.flush()
    assert sm.stats.segments == 5 and sm.stats.coalescing > 1.0
    doc = b"ab" * 10 + b"ab" + b"b8" + b"ab"
    np.testing.assert_array_equal(
        streams[0].close().final_states,
        m.membership_batch([doc]).final_states[0])


def test_max_delay_policies_bound_latency():
    m = _matcher([PATTERNS[1]])
    sm = StreamMatcher(m, policy=TickPolicy(max_batch=100, max_delay=2))
    s0, s1 = sm.open(), sm.open()
    s0.feed(b"ab")
    s1.feed(b"ba")
    assert sm.stats.ticks == 0
    s1.feed(b"ab")
    assert sm.stats.ticks == 1
    s0.close(), s1.close()
    now = [0.0]
    sm = StreamMatcher(m, policy=TickPolicy(max_batch=100, max_delay=0,
                                            max_delay_s=10.0),
                       clock=lambda: now[0])
    s0, s1 = sm.open(), sm.open()
    s0.feed(b"ab")
    now[0] = 9.0
    s1.feed(b"ba")
    assert sm.stats.ticks == 0
    now[0] = 10.5
    s1.feed(b"ab")
    assert sm.stats.ticks == 1
    np.testing.assert_array_equal(
        s1.close().final_states,
        m.membership_batch([b"baab"]).final_states[0])
    s0.close()
    with pytest.raises(ValueError):
        TickPolicy(max_delay_s=-1.0)


def test_full_tiles_reach_full_occupancy():
    m = _matcher([PATTERNS[1]], num_chunks=8, batch_tile=16)
    sm = StreamMatcher(m, policy=TickPolicy(max_batch=32, max_delay=1000))
    streams = [sm.open() for _ in range(32)]
    for _ in range(3):
        for s in streams:
            s.feed(b"abxy0a1b" * 16)
    sm.flush()
    assert sm.stats.occupancy == 1.0 and sm.stats.segments == 96
    for s in streams:
        s.close()


def test_absorbed_streams_are_evicted():
    m = Matcher(make_search_dfa(compile_regex(".*(hit)")), device="cpu")
    sm = StreamMatcher(m, policy=TickPolicy(max_batch=100, max_delay=2))
    dead, live = sm.open(), sm.open()
    dead.feed(b"xx hit xx")
    sm.flush()
    assert bool(dead.cursor.absorbed.all())
    live.feed(b"pending...")
    dead.feed(b"x")                     # evicted, but a feed event
    dead.feed(b"y")                     # 2nd event: live's deadline trips
    assert sm.stats.ticks == 2 and sm.stats.evicted == 1
    assert sm.stats.absorbed_skips == 2
    res = dead.close()
    assert bool(res.accepted[0]) and res.byte_count == 11
    live.close()


def test_ticks_do_no_host_merges():
    reset_merge_calls()
    rng = np.random.default_rng(45)
    sm = StreamMatcher(_matcher(num_chunks=4, batch_tile=4), policy=LAZY)
    docs = _docs(rng, [50, 80, 33])
    sessions = [sm.open() for _ in docs]
    for lo in range(0, 80, 20):
        for s, d in zip(sessions, docs):
            s.feed(d[lo:lo + 20])
        sm.flush()
    assert merge_calls() == 0
    for s in sessions:
        s.close()


def test_session_lifecycle_and_unported_options(tmp_path):
    m = _matcher([".*(ab)"])
    sm, sm2 = StreamMatcher(m), StreamMatcher(_matcher([".*(ab)"]))
    s = sm.open()
    with pytest.raises(ValueError):
        sm2.feed(s, b"x")
    s.close()
    with pytest.raises(ValueError):
        s.feed(b"x")
    with pytest.raises(ValueError):
        s.close()
    with pytest.raises(ValueError):
        StreamMatcher(m, backend="local")
    with pytest.raises(ValueError):
        sm.open_at(0)                    # needs lane_ticks=True
    # snapshot/restore is ported: the cursor crosses the failover
    s = sm.open()
    s.feed(b"xa")                    # eager policy: matched at once
    sm.snapshot(str(tmp_path))
    (s2,) = StreamMatcher(_matcher([".*(ab)"])).restore(str(tmp_path))
    assert (s2.sid, s2.byte_count, s2.segments_fed) == (1, 2, 1)
    s2.feed(b"b")
    assert s2.close().accepted.tolist() == [True]
    s.close()
    # the hot swap is ported: an equal set is a no-op, a new one swaps
    assert sm.swap_patterns(_dfas([".*(ab)"])) is False
    assert sm.swap_patterns(_dfas([".*(cd)"])) is True
    assert m.planner.table_epoch == 1


def test_lane_ticks_close_map_composes():
    """A candidate-keyed session opened mid-stream (``open_at``) closes to a
    map that, composed onto the prefix's cursor, gives the whole-document
    finals."""
    from repro_torch.streaming import merge

    rng = np.random.default_rng(47)
    m = _matcher(num_chunks=4, batch_tile=4)
    sm = StreamMatcher(m, lane_ticks=True)
    doc = rng.choice(ALPHABET, size=90).tobytes()
    head = sm.open()
    head.feed(doc[:40], flush=True)
    key = m.dev.advance_key(-1, doc[:40])
    tail = sm.open_at(key)
    tail.feed(doc[40:70])
    tail.feed(doc[70:])
    seg = sm.close_map(tail)
    cur = merge(head.cursor, seg, tables=m.dev)
    np.testing.assert_array_equal(cur.states, m.packed.run_all(doc))


# --------------------------------------------------------------------------
# fault injection: retry with restore, requeue on give-up
# --------------------------------------------------------------------------

def _run_segments(sm, docs, seg):
    sessions = [sm.open() for _ in docs]
    rounds = max(-(-len(d) // seg) for d in docs)
    for r in range(rounds):
        for s, d in zip(sessions, docs):
            piece = d[r * seg:(r + 1) * seg]
            if piece:
                s.feed(piece)
        sm.flush()
    return sessions


def _check(sessions, docs, m):
    finals = np.stack([s.close().final_states for s in sessions])
    np.testing.assert_array_equal(finals, m.membership_batch(docs)
                                  .final_states)
    for s, d in zip(sessions, docs):
        assert s.byte_count == len(d)  # no loss, no double-compose


@pytest.mark.parametrize("phase", ["pre", "post"])
def test_injected_faults_retry_bit_identical(phase):
    rng = np.random.default_rng(0)
    docs = _docs(rng, [96] * 6)
    m = _matcher()
    plan = (FaultPlan(kill={0: 2, 1: 1}) if phase == "pre"
            else FaultPlan(kill_post={0: 2, 1: 1}))
    sm = StreamMatcher(m, retry=RetryPolicy(max_retries=3), fault_plan=plan)
    sessions = _run_segments(sm, docs, 32)
    _check(sessions, docs, m)
    assert plan.injected == 3 and sm.stats.retries == 3
    assert sm.stats.dispatch_failures == 3 and sm.stats.failed_ticks == 0


def test_giveup_requeues_and_later_flush_completes():
    rng = np.random.default_rng(2)
    docs = _docs(rng, [64] * 4)
    m = _matcher()
    plan = FaultPlan(kill={0: 5})
    sm = StreamMatcher(m, policy=LAZY, retry=RetryPolicy(max_retries=1),
                       fault_plan=plan)
    sessions = [sm.open() for _ in docs]
    for s, d in zip(sessions, docs):
        s.feed(d[:32])
    with pytest.raises(InjectedFault):
        sm.flush()
    assert sm.stats.failed_ticks == 1
    assert sm.stats.requeued_segments == len(docs)
    assert all(s.pending_bytes == 32 for s in sessions)
    for s, d in zip(sessions, docs):
        s.feed(d[32:])
    sm.flush()
    _check(sessions, docs, m)


def test_retry_backoff_and_validation():
    sleeps = []
    sm = StreamMatcher(_matcher(),
                       retry=RetryPolicy(max_retries=3, backoff_s=0.125,
                                         backoff_factor=2.0,
                                         max_backoff_s=1.0))
    sm.scheduler.fault_plan = FaultPlan(kill={0: 2})
    sm.scheduler._sleep = sleeps.append
    s = sm.open()
    s.feed(b"abab")
    assert sleeps == [0.125, 0.25] and s.byte_count == 4
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_factor=0.5)
    assert RetryPolicy(backoff_s=0.5, max_backoff_s=0.8).delay(3) == 0.8
    with pytest.raises(ValueError):
        FaultPlan().maybe_fail(0, 0, "mid")


def test_restart_manager_and_straggler_policy():
    calls = []

    def step(state, i):
        calls.append(i)
        if len(calls) == 2:
            raise RuntimeError("worker lost")
        return state + 1

    mgr = RestartManager(lambda st, i: None, lambda: (10, 0), max_restarts=1)
    assert mgr.run(0, 0, 3, step) == (13, 3)
    assert mgr.restarts == 1 and "worker lost" in mgr.failures[0][1]
    p = StragglerPolicy(n_workers=4)
    with pytest.raises(ValueError):
        p.capacities()
    assert p.update(np.array([1.0, 1.0, 1.0, 2.0]))
    caps = p.capacities()
    assert caps.shape == (4,) and caps[3] < caps[0]
    assert p.rebalanced_shards(100).sizes.sum() == 100
    from repro_torch.distributed import reshard_tree
    with pytest.raises(NotImplementedError, match="A14"):
        reshard_tree({}, {})
