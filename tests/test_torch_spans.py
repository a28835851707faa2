"""The port's profiler spans (``kernels.census_hooks.span``) on the CPU.

Under a running ``torch.profiler`` the matcher facade and its executor
record ``repro_torch.*`` ranges at their layer boundaries, nested on the
caller's thread; with no profiler running ``record_function`` is never
entered.  ``backend="cuda"`` on ``device="cpu"`` is the kernel lowering
through the kernels' plain versions, ``"local"`` the eager lowering.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as tcore

PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = np.frombuffer(b"abxy0189 ", np.uint8)
KW = dict(num_chunks=4, batch_tile=4, max_buckets=2)
# docs shorter than 4C (the sequential bucket), two speculative buckets, and
# more docs than a tile holds in one of them
LENGTHS = [3, 15, 100, 130, 250, 90, 7, 120, 240, 110]

FACADE = ("matcher.plan", "matcher.pack", "executor.run",
          "matcher.readback", "matcher.scatter")
EXECUTOR = ("executor.lower", "executor.upload", "executor.stages",
            "executor.launch")


def _matcher(backend):
    return tcore.Matcher([tcore.make_search_dfa(tcore.compile_regex(p))
                          for p in PATTERNS], backend=backend, device="cpu",
                         **KW)


def _docs(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [bytes(rng.choice(ALPHABET, size=n)) for n in lengths]


def _spans(prof):
    """[(name without the prefix, start, end, parent's name or None)] of the
    program's spans, the parent being the innermost span around each."""
    ev = sorted(((e.name[len("repro_torch."):], e.time_range.start,
                  e.time_range.end) for e in prof.events()
                 if e.name.startswith("repro_torch.")),
                key=lambda x: (x[1], -x[2]))
    out, stack = [], []
    for name, s, e in ev:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.append((name, s, e, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


def _count(spans, name):
    return sum(n == name for n, *_ in spans)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    return res, _spans(prof)


@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_membership_batch_spans_nest_once_a_tile(backend):
    docs = _docs()
    want = _matcher(backend).membership_batch(docs)
    m = _matcher(backend)
    res, spans = _traced(lambda: m.membership_batch(docs))
    np.testing.assert_array_equal(res.accepted, want.accepted)
    np.testing.assert_array_equal(res.final_states, want.final_states)
    assert res.bucket_calls == want.bucket_calls >= 3
    tiles = res.bucket_calls
    parents = {}
    for name, _, _, parent in spans:
        parents.setdefault(name, set()).add(parent)
    assert parents["matcher.membership_batch"] == {None}
    for name in FACADE:
        assert parents[name] == {"matcher.membership_batch"}, name
    for name in EXECUTOR:
        assert parents[name] == {"executor.run"}, name
    assert _count(spans, "matcher.membership_batch") == 1
    assert _count(spans, "matcher.plan") == 1
    for name in ("matcher.pack", "executor.run", "matcher.readback",
                 "executor.upload", "executor.stages", "executor.launch"):
        assert _count(spans, name) == tiles, name
    # one a tile, and one for the accept lookup and the work model
    assert _count(spans, "matcher.scatter") == tiles + 1
    # the first call lowers each plan once: the sequential and two spec
    # buckets
    assert _count(spans, "executor.lower") == len(m.executor.lowering_kinds)
    assert _count(spans, "executor.lower") == 3

    # the tile's spans run in order, and the executor's inside its run
    order = [n for n, *_ in spans if n in ("matcher.pack", "executor.run",
                                           "matcher.readback",
                                           "matcher.scatter")]
    assert order == ["matcher.pack", "executor.run", "matcher.readback",
                     "matcher.scatter"] * tiles + ["matcher.scatter"]

    again, spans = _traced(lambda: m.membership_batch(docs))
    np.testing.assert_array_equal(again.accepted, want.accepted)
    assert _count(spans, "executor.lower") == 0
    assert _count(spans, "matcher.pack") == again.bucket_calls == tiles


def test_streaming_entry_points_get_the_tile_spans():
    m = _matcher("cuda")
    segs = _docs(1, [40, 130, 200, 9])
    entry = np.tile(m.packed.starts, (len(segs), 1)).astype(np.int32)
    want = _matcher("cuda").advance_segments(segs, entry)
    res, spans = _traced(lambda: m.advance_segments(segs, entry))
    np.testing.assert_array_equal(res.final_states, want.final_states)
    assert _count(spans, "matcher.membership_batch") == 0
    for name in ("matcher.pack", "executor.run", "matcher.readback",
                 "matcher.scatter"):
        assert _count(spans, name) == res.bucket_calls, name
    assert {p for n, *_, p in spans if n == "matcher.pack"} == {None}


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    m = _matcher("cuda")
    docs = _docs(2)
    m.membership_batch(docs)
    m.membership_batch(docs)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        m.membership_batch(docs)
    assert entered[0] == "repro_torch.matcher.membership_batch"
    assert "repro_torch.executor.launch" in entered


def test_kernel_skipped_steps_add_up_across_calls():
    """The in-kernel early exit's skipped blocks accumulate on the device:
    each identical call adds the same count, and reading it changes
    nothing."""
    m = tcore.Matcher(tcore.make_search_dfa(tcore.compile_regex(".*(hit)")),
                      backend="cuda", device="cpu", num_chunks=4)
    m.executor.spec_l_blk[0] = 64
    docs = [b"hit " * 200, b"xyz " * 200]
    counts = [m.executor.kernel_skipped_steps()]
    for _ in range(3):
        m.membership_batch(docs)
        counts.append(m.executor.kernel_skipped_steps())
    step = counts[1] - counts[0]
    assert counts[0] == 0 and step > 0
    assert counts == [0, step, 2 * step, 3 * step]
    assert m.executor.kernel_skipped_steps() == 3 * step
    assert m.perf_report()["kernel_skipped_steps"] == 3 * step
