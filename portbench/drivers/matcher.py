"""The port's batch membership test: ``Matcher.membership_batch``.

A driver is what the harness knows of the system under test, found by the
name a configuration gives under ``driver``:

    build(config, regexes, device) -> the system under test
    call(sut, docs) -> [B, K] bool decisions, as numpy
    instrument(sut, counters, span)   count and span inside a call (traced run)
    snapshot(sut) -> dict             the program's own counters, read before
                                      and after the window
    table_bytes(sut) -> int           the packed tables a call reads
"""

from __future__ import annotations

import copy
import sys
import time
from typing import Callable

import numpy as np


def build(config: dict, regexes: dict, device: str):
    """``Matcher`` over the configuration's patterns at its settings; on a
    card, the port's kernels are loaded first (built on a checkout's first
    run, into the port's fixed build directory inside the checkout)."""
    from repro_torch.core.engine import Matcher
    from repro_torch.core.patterns import PatternSet

    if device == "cuda":
        from repro_torch.kernels import _build

        t = time.perf_counter()
        _build.build_all()
        print(f"[portbench] kernels loaded in {time.perf_counter() - t:.3f} s "
              f"(compiled this run: {'yes' if _build.build_logs else 'no'}; "
              f"{_build.BUILD_DIR})", file=sys.stderr, flush=True)
    ps = PatternSet(regexes, search=config["semantics"] == "search")
    return Matcher(ps, device=device, **config["matcher"])


def call(sut, docs) -> np.ndarray:
    return np.asarray(sut.membership_batch(docs).accepted)


def instrument(sut, counters: dict, span: Callable) -> None:
    """Count the tiles the facade hands to ``sut.executor.run`` (rows x
    width, and the real bytes in them) and span each of its calls."""
    run = sut.executor.run

    def counted(plan, bytes_buf, lengths, **kw):
        counters["tiles"] = counters.get("tiles", 0) + 1
        counters["tile_bytes"] = counters.get("tile_bytes", 0) + int(bytes_buf.size)
        counters["real_bytes"] = (counters.get("real_bytes", 0)
                                  + int(np.asarray(lengths, np.int64).sum()))
        with span("portbench.executor.run"):
            return run(plan, bytes_buf, lengths, **kw)

    sut.executor.run = counted


def snapshot(sut) -> dict:
    """``perf_report()`` (lowerings, ``kernel_skipped_steps``, the planner's
    traffic) and the launch counts of the matching and compose kernels."""
    from repro_torch.kernels import dfa_match, lvec_compose

    report = sut.perf_report() if hasattr(sut, "perf_report") else {}
    return {"perf_report": copy.deepcopy(report),
            "launches": {**dfa_match.launches, **lvec_compose.launches}}


def table_bytes(sut) -> int:
    """The packed transition table and the 256-entry byte-class map."""
    packed = getattr(sut, "packed", None)
    return packed.table.nbytes + 256 if packed is not None else 0
