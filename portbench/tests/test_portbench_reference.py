"""The plain reference: Python's re.search over whole documents, agreeing
with the port's own CPU path on the cells' patterns and traffic."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness, manifest  # noqa: E402
from portbench.reference import membership  # noqa: E402

CELLS = ("prosite17-shards",)
TINY = {"docs_per_call": 6, "min_bytes": 1500, "max_bytes": 6000, "pool": 2,
        "boundary_stride": 1024}


def test_reference_is_re_search_over_the_whole_document():
    pats = [r"ab.c", r"\d{3}", r"[^x]{2}y"]
    docs = [b"ab\ncz", b"a12 345", b"", b"xxy", b"\n\ny", b"zzzab" * 10 + b"1"]
    got = membership.decide(pats, docs)
    want = np.array([[re.search(p.encode(), d, re.DOTALL) is not None
                      for p in pats] for d in docs])
    assert got.shape == (6, 3) and np.array_equal(got, want)
    assert got[0, 0] and got[4, 2]       # '.' and [^x] take a newline
    assert np.array_equal(membership.decide(pats, docs, workers=2), want)


def test_split_loses_exactly_the_matches_across_pieces():
    pats = [r"abcd"]
    docs = [b"xxabcdxx", b"xxxabcdx", b"abcdxxxx" + b"xxxxabcd"]
    assert membership.decide(pats, docs).ravel().tolist() == [True] * 3
    assert membership.decide(pats, docs, split=4).ravel().tolist() == [
        False, False, True]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    """The cell's patterns and (small) traffic: the reference and the port's
    Matcher on CPU tensors give the same [B, K] decisions, boundary plants
    included."""
    cell = manifest.resolve(name)
    mix = {**cell.mix, **TINY}
    pool = manifest.load_module("generators", mix["generator"]).make_pool(
        cell.config, mix, 2**31 + 3)
    m = harness.build_sut(cell, "cpu")
    want = harness.reference_decisions(cell, pool, range(len(pool)), 0)
    for e, docs in enumerate(pool):
        got = m.membership_batch(docs).accepted
        assert np.array_equal(got, want[e])
    assert 0 < sum(w.sum() for w in want.values()) < sum(w.size for w in want.values())
