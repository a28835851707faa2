"""Host layer parity: the port's numpy compile/plan code against the JAX
package's, on the fixture corpus and on seeded ragged batches."""

import functools
import json
import pathlib

import numpy as np
import pytest

import repro.core as jcore
from repro.core.engine.plan import DeviceTables as JDeviceTables
from repro.core.engine.plan import Planner as JPlanner

import repro_torch.core as tcore
from repro_torch.core.engine.plan import DeviceTables as TDeviceTables
from repro_torch.core.engine.plan import Planner as TPlanner

FIXTURES = json.loads((pathlib.Path(__file__).parent / "fixtures"
                       / "pattern_corpus.json").read_text())["entries"]


@functools.lru_cache(maxsize=None)
def _packed_pair(pattern: str):
    j = jcore.PatternSet([pattern], search=True).blocks[0]
    t = tcore.PatternSet([pattern], search=True).blocks[0]
    return j, t


@pytest.mark.parametrize("r", [1, 2, "auto"])
@pytest.mark.parametrize("entry", FIXTURES, ids=[e["name"] for e in FIXTURES])
def test_fixture_tables_agree(entry, r):
    j, t = _packed_pair(entry["pattern"])
    assert tcore.packed_signature(t) == jcore.packed_signature(j)
    jd = JDeviceTables.build(j, lookahead_r=r)
    td = TDeviceTables.build(t, lookahead_r=r, device="cpu")
    assert td.spec_r == jd.spec_r
    assert td.i_max == jd.i_max and td.n_keys == jd.n_keys
    np.testing.assert_array_equal(td.tables.candidates, jd.tables.candidates)
    np.testing.assert_array_equal(td.tables.cand_index, jd.tables.cand_index)
    np.testing.assert_array_equal(td.cand_pad_t.numpy(),
                                  np.asarray(jd.cand_pad_j))
    np.testing.assert_array_equal(td.cidx_pad_t.numpy(),
                                  np.asarray(jd.cidx_pad_j))
    np.testing.assert_array_equal(td.table_pad_t.numpy(),
                                  np.asarray(jd.table_pad_j))
    np.testing.assert_array_equal(td.absorbing, jd.absorbing)


def test_pcre_pack_and_advance_key_agree():
    j = jcore.PatternSet(jcore.PCRE_PATTERNS, k_blk=64).blocks[0]
    t = tcore.PatternSet(tcore.PCRE_PATTERNS, k_blk=64).blocks[0]
    assert tcore.packed_signature(t) == jcore.packed_signature(j)
    jd, td = JDeviceTables.build(j), TDeviceTables.build(t, device="cpu")
    assert (td.spec_r, td.i_max) == (jd.spec_r, jd.i_max)
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 9):
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        for prev in (-1, 0, 5):
            assert td.advance_key(prev, data) == jd.advance_key(prev, data)


def test_packed_from_arrays_roundtrip():
    j = jcore.pack_dfas([jcore.make_search_dfa(jcore.compile_regex(p))
                         for p in (".*(ab|ba){2}", ".*[0-9]{3}")])
    arrays = {name: np.asarray(getattr(j, name))
              for name in ("table", "accepting", "starts", "sinks",
                           "offsets", "byte_to_class")}
    t = tcore.packed_from_arrays(arrays)
    assert isinstance(t, tcore.PackedDFA)
    assert tcore.packed_signature(t) == jcore.packed_signature(j)
    doc = b"x12ab ba345"
    np.testing.assert_array_equal(t.run_all(doc), j.run_all(doc))
    with pytest.raises(KeyError):
        tcore.packed_from_arrays({"table": arrays["table"]})


@pytest.mark.parametrize("num_chunks,max_buckets", [(4, 2), (8, 1), (8, 3)])
def test_planner_buckets_agree(num_chunks, max_buckets):
    rng = np.random.default_rng(num_chunks * 10 + max_buckets)
    jp = JPlanner(num_chunks=num_chunks, max_buckets=max_buckets)
    tp = TPlanner(num_chunks=num_chunks, max_buckets=max_buckets)
    for _ in range(4):  # sticky keys carry across calls
        lengths = rng.integers(0, 3000, size=int(rng.integers(1, 40)))
        lengths[rng.random(lengths.size) < 0.2] = 0
        jplan, tplan = jp.plan(lengths), tp.plan(lengths)
        np.testing.assert_array_equal(tplan.spec_mask, jplan.spec_mask)
        np.testing.assert_array_equal(tplan.chunk_len, jplan.chunk_len)
        assert len(tplan.buckets) == len(jplan.buckets)
        for tb, jb in zip(tplan.buckets, jplan.buckets):
            assert (tb.kind, tb.width, tb.chunk_len) == (jb.kind, jb.width,
                                                         jb.chunk_len)
            np.testing.assert_array_equal(tb.doc_idx, jb.doc_idx)
            if tb.kind == "spec":
                tl, jl = tp.layout_for(tb.chunk_len), jp.layout_for(jb.chunk_len)
                np.testing.assert_array_equal(tl.starts, jl.starts)
                np.testing.assert_array_equal(tl.ends, jl.ends)
                assert tl.lmax == jl.lmax
            assert (tp.lane_plan(tb, spec_r=2).key
                    == jp.lane_plan(jb, spec_r=2).key)
        assert tp.spec_keys == jp.spec_keys and tp.seq_width == jp.seq_width
