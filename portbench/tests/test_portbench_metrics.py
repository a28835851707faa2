"""The metric readers' arithmetic, on a hand-made trace with known answers
and on a small trace recorded on the card (two calls of 16 documents to a
14-pattern matcher, NVIDIA H100 80GB HBM3)."""

import contextlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, manifest, peaks  # noqa: E402
from portbench.trace import Trace  # noqa: E402

FIXTURE = Path(__file__).parent / "fixtures" / "trace_pcre14_2calls.json"
HTOD = "Memcpy HtoD (Pageable -> Device)"


def read(name, run):
    return manifest.load_module("metrics", name).read(run)


def _run(trace, calls, counters=None, k=14, table_bytes=0, setup_s=1.0):
    window = calls[-1].t1 - calls[0].t0 if calls else 0.0
    return harness.Run(setup_s, calls, window, k, table_bytes,
                       counters or {}, trace)


def _call(t0, t1, nbytes=10**6, decisions=64 * 14, entry=0):
    return harness.Call(entry, t0, t1, nbytes, decisions, np.zeros((1, 1), bool))


HAND = Trace(
    w0=0.0, w1=100.0,
    device=[[HTOD, 10, 30], ["spec_scan_kernel", 30, 50], ["index", 45, 55],
            ["Memcpy DtoH (Device -> Pageable)", 80, 82],
            ["after", 120, 130], ["clipped", -5, 5]],
    host=[["portbench.call", 0, 60], ["portbench.executor.run", 8, 58],
          ["aten::copy_", 9, 31], ["portbench.call", 70, 95]])


def test_hand_trace_busy_idle_and_breakdown():
    assert HAND.busy() == [[0, 5], [10, 55], [80, 82]]
    assert HAND.busy_s() == pytest.approx(52e-6)
    assert HAND.idle() == [[5, 10], [55, 80], [82, 100]]
    b = HAND.breakdown()
    assert b["device_ops"][0] == [HTOD, pytest.approx(20e-6)]
    assert dict(b["idle_gaps"]) == {"(no host event)": pytest.approx(25e-6),
                                    "portbench.call": pytest.approx(23e-6)}
    run = _run(HAND, [_call(0.0, 1.0), _call(1.0, 2.0)])
    assert read("device_idle_share", run) == pytest.approx(48.0)
    assert read("h2d_ms_per_GB", run) == pytest.approx(0.020 / 0.002)
    least = 2 * peaks.membership_least_s(10**6, 14, 0, 64 * 14)
    assert least == pytest.approx(2 * 14e6 / 8.375e12)
    assert read("scan_roofline", run) == pytest.approx(100 * least / 35e-6)


def test_host_clock_metrics():
    calls = [_call(i * 0.1, i * 0.1 + 0.05 + 0.001 * i, nbytes=2 * 10**6)
             for i in range(20)]
    calls.append(harness.Call(0, 2.0, 2.5, 10**6, 1, None, "lost"))
    run = _run(None, calls, setup_s=12.5)
    assert run.window_s == pytest.approx(2.5)
    assert read("match_MBps", run) == pytest.approx(40e6 / 2.5 / 1e6)
    lat = [c.t1 - c.t0 for c in calls]
    assert read("call_p95_ms", run) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert read("call_p95_ms", run) > 60.0      # the raised call counts
    assert read("setup_s", run) == 12.5
    for name in ("tile_fill", "h2d_ms_per_GB", "scan_roofline",
                 "scan_launches_per_call", "device_idle_share"):
        assert read(name, run) is None          # nothing to read: no value


def test_tile_fill_counts_real_over_padded_bytes():
    run = _run(None, [_call(0, 1)], {"tile_bytes": 400, "real_bytes": 150})
    assert read("tile_fill", run) == pytest.approx(37.5)


def test_counted_executor_keeps_the_results():
    counters = {}
    inner = SimpleNamespace(run=lambda plan, buf, lens, **kw: ("out", kw))
    m = SimpleNamespace(executor=inner)
    manifest.load_module("drivers", "matcher").instrument(
        m, counters, lambda name: contextlib.nullcontext())
    buf = np.zeros((4, 8), np.uint8)
    assert m.executor.run("p", buf, np.array([8, 3, 0, 0]), layout=1) == (
        "out", {"layout": 1})
    assert counters == {"tiles": 1, "tile_bytes": 32, "real_bytes": 11}


def test_scan_launches_per_call_reads_the_snapshots():
    calls = [_call(0, 1), _call(1, 2), _call(2, 3), _call(3, 4)]
    run = _run(None, calls)
    assert read("scan_launches_per_call", run) is None
    run.before = {"launches": {"spec_match_merge": 5, "spec_compose_lanes": 1}}
    run.after = {"launches": {"spec_match_merge": 13, "spec_match": 2,
                              "spec_compose_lanes": 9}}
    assert read("scan_launches_per_call", run) == pytest.approx(10 / 4)


def _sweep_busy(device, w0, w1):
    """Busy time by an event-point sweep (another method than Trace.busy)."""
    points = []
    for _, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            points += [(s, 1), (e, -1)]
    busy, depth, last = 0.0, 0, None
    for t, d in sorted(points, key=lambda p: (p[0], -p[1])):
        if depth > 0:
            busy += t - last
        depth += d
        last = t
    return busy / 1e6


def test_recorded_trace():
    rec = json.loads(FIXTURE.read_text())
    tr = Trace.from_json(rec)
    calls = [harness.Call(e, t0, t1, n, d, np.zeros((1, 1), bool))
             for e, t0, t1, n, d in rec["calls"]]
    run = _run(tr, calls, rec["counters"], rec["k"], rec["table_bytes"])
    assert tr.busy_s() == pytest.approx(_sweep_busy(tr.device, tr.w0, tr.w1))
    idle = sum(e - s for s, e in tr.idle()) / 1e6
    assert idle + tr.busy_s() == pytest.approx(tr.window_s)
    names = [n for n, _, _ in tr.in_window()]
    assert any(n.startswith("Memcpy HtoD") for n in names)
    assert any("spec_scan_kernel" in n for n in names)
    real = sum(c.nbytes for c in calls)
    h2d = sum(e - s for n, s, e in tr.in_window() if n.startswith("Memcpy HtoD"))
    assert read("h2d_ms_per_GB", run) == pytest.approx(h2d / 1e3 / (real / 1e9))
    share = read("scan_roofline", run)
    assert 0 < share < 100
    assert 0 < read("device_idle_share", run) < 100
    assert read("tile_fill", run) == pytest.approx(
        100 * rec["counters"]["real_bytes"] / rec["counters"]["tile_bytes"])
    b = tr.breakdown()
    secs = [v for _, v in b["device_ops"]]
    assert secs == sorted(secs, reverse=True) and len(secs) <= 10
    assert sum(v for _, v in b["idle_gaps"]) <= idle + 1e-9
