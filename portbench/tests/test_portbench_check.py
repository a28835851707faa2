"""The check that decides ``correct``: a sound run passes; the control (the
reference without the speculative merge) and runs with the timed path broken
underneath fail.

The runs here skip the harness's look for a card and drive the rest of a run
on CPU tensors at a small size (the kernels' plain versions); the control and
the faults were read at the cells' own size on the card as PERF.md records.
"""

import itertools
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import control, harness  # noqa: E402

CELLS = ("prosite17-shards",)
TINY = {"docs_per_call": 4, "min_bytes": 600, "max_bytes": 2000, "pool": 2,
        "boundary_stride": 512}


@pytest.fixture(autouse=True)
def _jax_loaded_elsewhere(monkeypatch):
    """A test worker may have run the JAX package's tests before these, so
    its ``sys.modules`` holds ``jax``; the run's check for that module is
    tested in test_portbench_imports.py, in fresh processes."""
    monkeypatch.setattr(harness.modcheck, "forbidden_modules", lambda: [])


def _run(name, factory=None, seed=2**31 + 1):
    return harness.run_cell(name, seed, 0.3, False, t_start=time.perf_counter(),
                            device="cpu", mix=TINY, factory=factory, workers=0)


def _broken(fault):
    """A factory of the port's Matcher with ``fault`` planted under
    ``membership_batch``."""
    def factory(cell, device):
        m = harness.build_sut(cell, device)
        real = m.membership_batch
        n = itertools.count()

        def broken(docs):
            res = real(docs)
            finals = res.final_states.copy()
            if fault == "state_unchanged":      # no step moves any state
                finals[:] = m.packed.starts
            elif fault == "half_batch":         # half the documents left out
                finals[len(docs) // 2:] = m.packed.starts
            elif fault == "answer_altered" and next(n) == 2:
                acc = res.accepted.copy()    # the first timed call's first
                acc[0, 0] = not acc[0, 0]    # decision, altered
                return types.SimpleNamespace(accepted=acc)
            return types.SimpleNamespace(accepted=m.packed.accepting[finals])

        m.membership_batch = broken
        return m
    return factory


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["wrong_decisions"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    r = _run(name, _broken(fault))
    assert not r["correct"]
    assert r["checks"]["wrong_decisions"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_call_that_raises_is_not_correct(name):
    def factory(cell, device):
        m = harness.build_sut(cell, device)
        real, n = m.membership_batch, itertools.count()

        def flaky(docs):
            if next(n) == 2:
                raise RuntimeError("lost")
            return real(docs)

        m.membership_batch = flaky
        return m
    r = _run(name, factory)
    assert not r["correct"] and r["failed"] == 1
    assert r["checks"]["unanswered_calls"]["value"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    """The control at a small size: pieces of 512 bytes matched apart, with
    the traffic's boundary plants at their boundaries."""
    mix = {**TINY, "docs_per_call": 8, "boundary_plants": 8}
    for r in control.readings(name, [1, 2, 2**31 + 11], split=512, mix=mix):
        assert r["wrong_decisions"] > 0
