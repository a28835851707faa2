"""The readers of the program's spans (``repro_torch.*`` ranges that the
port records while the profiler records): their interval arithmetic on a
hand-made trace with known answers, nothing to read without a trace or on a
program without spans, and a small trace recorded on the card (two calls of
prosite17-shards, 64 shards of 256 KiB-1 MiB each, NVIDIA H100 80GB HBM3)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, manifest  # noqa: E402
from portbench.trace import Trace  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures"
SPANS = FIXTURES / "trace_prosite17_2calls_spans.json"
NO_SPANS = FIXTURES / "trace_pcre14_2calls.json"   # recorded before the spans
METRICS = ("facade_idle_share", "pack_ms_per_call", "readback_wait_share",
           "upload_ms_per_GB", "lowerings_in_window")
FACADE = manifest.load_module("metrics", "facade_idle_share")


def read(name, run):
    return manifest.load_module("metrics", name).read(run)


def _call(t0, t1, nbytes=10**6):
    return harness.Call(0, t0, t1, nbytes, 1, np.zeros((1, 1), bool))


def _run(trace, calls, counters=None):
    return harness.Run(1.0, calls, calls[-1].t1 - calls[0].t0, 17, 0,
                       counters or {}, trace)


def _p(name, s, e):
    return ["repro_torch." + name, s, e]


# window [0, 120] us; the card busy on [0, 30], [40, 100] and [110, 120], so
# idle on [30, 40] (half in a pack, half in a read-back) and on [100, 110]
# (after the call)
HAND = Trace(
    w0=0.0, w1=120.0,
    device=[["Memcpy HtoD (Pageable -> Device)", 0, 20], ["scan", 20, 30],
            ["scan", 40, 100], ["scan", 110, 125]],
    host=[["portbench.call", 0, 100], _p("matcher.membership_batch", 0, 100),
          _p("executor.run", 0, 20), _p("executor.lower", 1, 2),
          _p("executor.upload", 2, 18), _p("matcher.readback", 20, 25),
          _p("matcher.pack", 25, 35), _p("matcher.readback", 35, 50),
          _p("matcher.scatter", 50, 52), _p("executor.lower", -8, -2)])


def test_facade_idle_share_intersects_idle_with_facade_self_time():
    assert HAND.idle() == [[30, 40], [100, 110]]
    # the facade's self time: its call less executor.run and the read-backs
    assert FACADE.facade_self(HAND) == [[25, 35], [50, 100]]
    # of the gap [30, 40], the half under the pack counts
    assert FACADE.overlap_us(HAND.idle(), FACADE.facade_self(HAND)) == 5
    run = _run(HAND, [_call(0.0, 1.0), _call(1.0, 2.0)])
    assert read("facade_idle_share", run) == pytest.approx(100 * 5 / 120)
    assert read("device_idle_share", run) == pytest.approx(100 * 20 / 120)


def test_span_sums_on_the_hand_trace():
    run = _run(HAND, [_call(0.0, 1.0), _call(1.0, 2.0)])
    assert read("pack_ms_per_call", run) == pytest.approx(10e-3 / 2)
    assert read("readback_wait_share", run) == pytest.approx(100 * 20 / 120)
    # 16 us of upload over 2 * 10^6 real bytes
    assert read("upload_ms_per_GB", run) == pytest.approx(16e-3 / 2e-3)
    # the lowering before the window does not count
    assert read("lowerings_in_window", run) == 1


@pytest.mark.parametrize("a, b, want", [
    ([[0, 10]], [[2, 3], [5, 7]], [[0, 2], [3, 5], [7, 10]]),
    ([[0, 10], [20, 30]], [[5, 25]], [[0, 5], [25, 30]]),
    ([[0, 10]], [[-5, 15]], []),
    ([[0, 4], [2, 6]], [], [[0, 6]]),
    ([[0, 10]], [[10, 12], [-3, 0]], [[0, 10]]),
])
def test_subtract(a, b, want):
    assert FACADE.subtract(a, b) == want


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_without_a_trace(name):
    assert read(name, _run(None, [_call(0.0, 1.0)])) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_from_a_program_without_spans(name):
    rec = json.loads(NO_SPANS.read_text())
    calls = [harness.Call(e, t0, t1, n, d, np.zeros((1, 1), bool))
             for e, t0, t1, n, d in rec["calls"]]
    run = harness.Run(1.0, calls, calls[-1].t1 - calls[0].t0, rec["k"],
                      rec["table_bytes"], rec["counters"],
                      Trace.from_json(rec))
    assert read("device_idle_share", run) is not None
    assert read(name, run) is None


def _recorded():
    rec = json.loads(SPANS.read_text())
    calls = [harness.Call(e, t0, t1, n, d, np.zeros((1, 1), bool))
             for e, t0, t1, n, d in rec["calls"]]
    tr = Trace.from_json(rec)
    return rec, tr, harness.Run(1.0, calls, calls[-1].t1 - calls[0].t0,
                                rec["k"], rec["table_bytes"], rec["counters"],
                                tr)


def test_recorded_trace_idle_splits_by_span():
    rec, tr, run = _recorded()
    idle = tr.idle()
    total = sum(e - s for s, e in idle)
    facade = FACADE.overlap_us(idle, FACADE.facade_self(tr))
    execu = FACADE.overlap_us(idle, FACADE.spans(tr, "executor.run"))
    readback = FACADE.overlap_us(idle, FACADE.spans(tr, "matcher.readback"))
    calls = FACADE.spans(tr, "matcher.membership_batch")
    outside = total - FACADE.overlap_us(idle, calls)
    assert facade + execu + readback + outside == pytest.approx(total)
    assert min(facade, execu, readback, outside) >= 0
    share = read("facade_idle_share", run)
    assert share == pytest.approx(100 * facade / (tr.w1 - tr.w0))
    assert 0 < share <= read("device_idle_share", run)


def test_recorded_trace_span_metrics():
    rec, tr, run = _recorded()
    tiles = rec["counters"]["tiles"]
    names = [n for n, _, _ in tr.host]
    for name in ("matcher.pack", "matcher.readback", "executor.run",
                 "executor.upload"):
        assert names.count("repro_torch." + name) == tiles
    assert names.count("repro_torch.matcher.membership_batch") == len(run.calls)
    values = {m: read(m, run) for m in METRICS}
    assert all(v is not None for v in values.values())
    assert values["lowerings_in_window"] == 0
    assert 0 < values["readback_wait_share"] < 100
    packs = sum(e - s for n, s, e in tr.host
                if n == "repro_torch.matcher.pack")
    assert values["pack_ms_per_call"] == pytest.approx(packs / 1e3 / 2)
    # the host blocks in each pageable copy at least as long as the card
    # copies
    assert values["upload_ms_per_GB"] >= read("h2d_ms_per_GB", run)
    # the program's annotations never count as device work
    assert not any(n.startswith("repro_torch.") for n, _, _ in tr.device)
    # the breakdown puts the largest idle item down to a program span
    top = tr.breakdown()["idle_gaps"][0][0]
    assert top.startswith("repro_torch.")
