"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

The window is a closed loop with one caller: each call hands the system
under test the next input of a pool drawn from the seed at set-up and waits
for its numpy result.  Once the window has closed, every call's [B, K] decisions
are compared with the reference's for the same input.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import sys
import time
from typing import Callable, Optional

import numpy as np

from portbench import manifest, modcheck
from portbench.reference import membership
from portbench.trace import WINDOW, Trace, from_profiler


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Call:
    entry: int                       # index of the input in the pool
    t0: float
    t1: float
    nbytes: int                      # real document bytes
    decisions: int                   # B * K
    accepted: Optional[np.ndarray]   # [B, K] bool; None if the call raised
    error: Optional[str] = None

    @property
    def answered(self) -> bool:
        return self.accepted is not None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    calls: list
    window_s: float          # first call's start to last call's end
    k: int
    table_bytes: int         # the packed DFA's table and byte classes
    counters: dict           # the driver's counts inside calls (traced run)
    trace: Optional[Trace]   # traced run on a card
    before: dict = dataclasses.field(default_factory=dict)  # the driver's
    after: dict = dataclasses.field(default_factory=dict)   # snapshot, each
    #                          side of the window


def build_sut(cell: manifest.Cell, device: str):
    """The system under test, built by the configuration's driver from its
    patterns' regex texts."""
    return manifest.driver(cell.config).build(
        cell.config, manifest.regexes(cell.config), device)


def check(calls: list, want: dict, limits: dict) -> dict:
    """Each compared number beside its limit: decisions that differ from the
    reference's, and calls that never answered."""
    wrong = unanswered = 0
    for c in calls:
        if not c.answered:
            unanswered += 1
            continue
        ref = want[c.entry]
        wrong += (ref.size if c.accepted.shape != ref.shape
                  else int((c.accepted != ref).sum()))
    values = {"wrong_decisions": wrong, "unanswered_calls": unanswered}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def reference_decisions(cell: manifest.Cell, pool: list, entries,
                        workers: int) -> dict:
    """{entry: [B, K] reference decisions} for the pool entries used."""
    entries = sorted(set(entries))
    docs = [d for e in entries for d in pool[e]]
    rows = membership.decide(list(manifest.regexes(cell.config).values()),
                             docs, workers=workers)
    out, i = {}, 0
    for e in entries:
        out[e] = rows[i:i + len(pool[e])]
        i += len(pool[e])
    return out


def measure(call: Callable, pool: list, seconds: float, k: int,
            span: Callable, sync: Callable) -> tuple[list, float]:
    """The window: calls in a closed loop until ``seconds`` have passed; the
    call running at the deadline completes and counts."""
    calls = []
    t_begin = time.perf_counter()
    deadline = t_begin + seconds
    i = 0
    with span(WINDOW):
        while True:
            e = i % len(pool)
            docs = pool[e]
            t0 = time.perf_counter()
            try:
                with span("portbench.call"):
                    acc = call(docs)
                err = None
            except Exception as ex:  # an answer that never comes: recorded
                acc, err = None, f"{type(ex).__name__}: {ex}"
            t1 = time.perf_counter()
            calls.append(Call(e, t0, t1, sum(len(d) for d in docs),
                              len(docs) * k, acc, err))
            i += 1
            if t1 >= deadline:
                break
        sync()
    return calls, calls[-1].t1 - t_begin


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             mix: Optional[dict] = None, factory: Optional[Callable] = None,
             workers: Optional[int] = None) -> Optional[dict]:
    """One run; returns the result line's object, or None where a forbidden
    module is loaded once the run is over.  ``t_start`` is the process start on the
    ``time.perf_counter`` clock.  ``mix`` replaces the cell's traffic
    parameters, ``factory(cell, device)`` the system under test, and
    ``workers`` the reference's process count (tests)."""
    import torch

    cell = manifest.resolve(name)
    if mix is not None:
        cell = dataclasses.replace(cell, mix={**cell.mix, **mix})
    on_card = device == "cuda"
    drv = manifest.driver(cell.config)
    t = time.perf_counter()
    sut = (factory or build_sut)(cell, device)
    log(f"patterns and system under test in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    gen = manifest.load_module("generators", cell.mix["generator"])
    pool = gen.make_pool(cell.config, cell.mix, seed)
    log(f"input pool in {time.perf_counter() - t:.3f} s: {len(pool)} calls "
        f"of {len(pool[0])} documents, "
        f"{sum(len(d) for p in pool for d in p) / 2**20:.1f} MiB")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t = time.perf_counter()
    for docs in pool[:2]:
        drv.call(sut, docs)
    sync()
    log(f"warm calls in {time.perf_counter() - t:.3f} s")
    before = drv.snapshot(sut)
    log(f"driver snapshot before the window: {str(before)[:600]}")
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")

    k = len(cell.config["patterns"])
    counters: dict = {}
    prof = None
    span = lambda name: contextlib.nullcontext()  # noqa: E731
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        span = record_function
        drv.instrument(sut, counters, span)
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_card else []))
    with prof if prof is not None else contextlib.nullcontext():
        calls, window_s = measure(lambda docs: drv.call(sut, docs), pool,
                                  seconds, k, span, sync)
    after = drv.snapshot(sut)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window: {len(calls)} calls in {window_s:.3f} s, "
        f"{sum(not c.answered for c in calls)} raised")
    for c in calls:
        if c.error:
            log(f"call {c.entry} raised {c.error}")
            break

    tr = None
    if prof is not None:
        t = time.perf_counter()
        tr = from_profiler(prof)
        log(f"trace read in {time.perf_counter() - t:.3f} s: "
            f"{len(tr.device)} device and {len(tr.host)} host events")
    table_bytes = drv.table_bytes(sut)
    del sut, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    want = reference_decisions(
        cell, pool, [c.entry for c in calls],
        workers=min(8, os.cpu_count() or 1) if workers is None else workers)
    log(f"reference in {time.perf_counter() - t:.3f} s")
    checks = check(calls, want, cell.limits)
    run = Run(setup_s, calls, window_s, k, table_bytes, counters, tr,
              before, after)
    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.load_module("metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(calls) and all(
                  v["value"] <= v["limit"] for v in checks.values()),
              "attempted": len(calls),
              "failed": sum(not c.answered for c in calls),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    found = modcheck.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return None
    return result
