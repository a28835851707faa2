"""The port's sharded backend against the JAX package, on the CPU.

Counterparts of tests/test_sharded_executor.py and the sharded rows of
tests/test_fault_tolerance.py.  The JAX package's own sharded rows fail on
this host's jax (its ``shard_map`` refuses the mesh), so the port is held
against the JAX package's ``backend="local"`` (same decisions by
construction), its numpy layout arithmetic (``engine/plan.py``), and the
port's own ``local`` backend.  Three tiers:

  * in-process, no world: the layout arithmetic (``ChunkLayout.weighted``,
    ``MeshLayout``, ``tile_rows``, ``device_work``, ``Planner`` weights)
    equals the JAX package's exactly on meshes 1x1, 1x4, 2x2, 4x1, 2x4;
  * one world of one (gloo, a ``file://`` store, destroyed after the
    module): the facade, the streaming hooks, the compose fold, a measured
    tune, the corpus filter, ``reshard_tree``, ``restore_checkpoint
    (shardings=)`` and snapshots across the packages;
  * four spawned worlds (2x2, 1x4, 4x1, 2x4): one process per rank over
    gloo, each running every case in one spawn against arrays the parent
    computed with the JAX package.  The children import no jax.

Every compared value is a state id, a count or a bit: comparisons are exact.
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = b"abxy0189"
RAGGED = [0, 1, 3, 10, 31, 32, 33, 100, 255, 256, 513, 900, 1024]
MESH_SHAPES = [(1, 1), (1, 4), (2, 2), (4, 1), (2, 4)]
SPAWNED = [(2, 2), (1, 4), (4, 1), (2, 4)]
CHILD_TIMEOUT_S = 150


def _docs(rng, sizes):
    return [bytes(rng.choice(list(ALPHABET), size=int(n)).astype(np.uint8))
            for n in sizes]


def _skewed_caps(shape, seed=0):
    """A capacity profile that varies within each mesh row."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.6, 1.8, size=shape[0] * shape[1])


def _pack(docs):
    off = np.concatenate([[0], np.cumsum([len(d) for d in docs])])
    return np.frombuffer(b"".join(docs), np.uint8).copy(), off.astype(np.int64)


def _unpack(blob, off):
    return [bytes(blob[a:b]) for a, b in zip(off[:-1], off[1:])]


def _tdfas():
    from repro_torch.core import compile_regex, make_search_dfa
    return [make_search_dfa(compile_regex(p)) for p in PATTERNS]


def _jdfas():
    from repro.core import compile_regex, make_search_dfa
    return [make_search_dfa(compile_regex(p)) for p in PATTERNS]


def _weights(partition, caps, shape):
    """(per-row Eq. 1 weights, doc-axis row weights) as the facade forms
    them, with one package's ``capacity_weights``."""
    if caps is None:
        return None, None
    caps2 = np.asarray(caps, np.float64).reshape(shape)
    w = np.stack([partition.capacity_weights(row) for row in caps2])
    rw = (partition.capacity_weights(caps2.sum(axis=1)) if shape[0] > 1
          else None)
    return w, rw


def _jax_planner(shape, caps, num_chunks=8, spec_m=1):
    from repro.core import partition as jpart
    from repro.core.engine.plan import Planner as JPlanner
    w, rw = _weights(jpart, caps, shape)
    return JPlanner(num_chunks=num_chunks, max_buckets=2, devices=shape[1],
                    weights=w, spec_m=spec_m, doc_shards=shape[0],
                    row_weights=rw)


def _jax_device_work(shape, caps, lengths, batch_tile):
    """[D] real symbols per device of one ``membership_batch`` call, by the
    JAX package's layout arithmetic and the facade's accounting."""
    from repro.core.engine.plan import MeshLayout, layout_device_work
    jp = _jax_planner(shape, caps)
    lengths = np.asarray(lengths, np.int64)
    work = np.zeros(shape[0] * shape[1], np.int64)
    for bucket in jp.plan(lengths).buckets:
        if bucket.kind != "spec":
            continue
        layout = jp.layout_for(bucket.chunk_len)
        if not isinstance(layout, MeshLayout):
            work += layout_device_work(layout, lengths[bucket.doc_idx])
            continue
        for lo in range(0, bucket.doc_idx.size, batch_tile):
            sel = bucket.doc_idx[lo:lo + batch_tile]
            rowpos = (layout.tile_rows(sel.size, batch_tile)
                      if layout.is_ragged else np.arange(sel.size))
            lens = np.zeros(batch_tile, np.int64)
            lens[rowpos] = lengths[sel]
            work += layout.device_work(lens)
    return work


# --------------------------------------------------------------------------
# in-process: the layout arithmetic equals the JAX package's
# --------------------------------------------------------------------------

def test_factor_matcher_mesh_equals_jax():
    from repro.launch.mesh import factor_matcher_mesh as jfactor

    from repro_torch.launch.mesh import factor_matcher_mesh
    for n in range(1, 17):
        assert factor_matcher_mesh(n) == jfactor(n)
    with pytest.raises(ValueError):
        factor_matcher_mesh(0)


def _same_chunk_layout(got, want):
    assert got.width == want.width and got.lmax == want.lmax
    for name in ("starts", "ends", "device_of", "exact", "sizes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.num_chunks, got.num_devices) == (want.num_chunks,
                                                 want.num_devices)


def _same_layout(got, want, rng, tile):
    from repro.core.engine.plan import MeshLayout as JMeshLayout
    from repro.core.engine.plan import layout_device_work as jwork

    from repro_torch.core.engine.plan import MeshLayout, layout_device_work
    assert isinstance(got, MeshLayout) == isinstance(want, JMeshLayout)
    lengths = rng.integers(0, 2 * got.width + 1, size=tile)
    lengths[rng.random(tile) < 0.25] = 0
    if not isinstance(got, MeshLayout):
        _same_chunk_layout(got, want)
        np.testing.assert_array_equal(layout_device_work(got, lengths),
                                      jwork(want, lengths))
        return
    assert got.row_weights == want.row_weights
    assert (got.doc_shards, got.num_chunks, got.lmax, got.num_devices,
            got.is_ragged) == (want.doc_shards, want.num_chunks, want.lmax,
                               want.num_devices, want.is_ragged)
    for g, w in zip(got.rows, want.rows):
        _same_chunk_layout(g, w)
        np.testing.assert_array_equal(layout_device_work(g, lengths),
                                      jwork(w, lengths))
    np.testing.assert_array_equal(got.device_work(lengths),
                                  want.device_work(lengths))
    for n in range(tile + 1):
        np.testing.assert_array_equal(got.doc_counts(n), want.doc_counts(n))
        np.testing.assert_array_equal(got.tile_rows(n, tile),
                                      want.tile_rows(n, tile))


@pytest.mark.parametrize("spec_m", ["1", "i_max"])
@pytest.mark.parametrize("weights", ["uniform", "profile", "skewed"])
@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=[f"{a}x{b}" for a, b in MESH_SHAPES])
def test_layout_arithmetic_equals_jax(shape, weights, spec_m):
    from repro.core import partition as jpart
    from repro.core.engine import plan as jplan

    from repro_torch.core import partition as tpart
    from repro_torch.core import pack_dfas, profile_workers
    from repro_torch.core import synthetic_capacities
    from repro_torch.core.engine import plan as tplan

    d = shape[0] * shape[1]
    caps = {"uniform": None, "profile": synthetic_capacities(d),
            "skewed": _skewed_caps(shape, seed=d)}[weights]
    if weights == "profile":
        np.testing.assert_array_equal(profile_workers(caps),
                                      jpart.capacity_weights(caps))
    m = 1 if spec_m == "1" else tplan.DeviceTables.build(
        pack_dfas(_tdfas()), device="cpu").i_max
    tw, trw = _weights(tpart, caps, shape)
    jw, jrw = _weights(jpart, caps, shape)
    if caps is not None:
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(
            tplan.expand_device_weights(tw[0], 3),
            jplan.expand_device_weights(jw[0], 3))
        for width in (7, 64, 1000):
            _same_chunk_layout(
                tplan.ChunkLayout.weighted(width, 2 * shape[1], shape[1],
                                           tw[-1], m),
                jplan.ChunkLayout.weighted(width, 2 * shape[1], shape[1],
                                           jw[-1], m))
    kw = dict(num_chunks=6, max_buckets=2, devices=shape[1], spec_m=m,
              doc_shards=shape[0])
    tp = tplan.Planner(weights=tw, row_weights=trw, **kw)
    jp = jplan.Planner(weights=jw, row_weights=jrw, **kw)
    assert tp.num_chunks == jp.num_chunks
    rng = np.random.default_rng(d * 7 + len(weights) + m)
    tile = 8 * shape[0]
    for step in range(2):
        for lc in (1, 3, 16, 257):
            _same_layout(tp.layout_for(lc), jp.layout_for(lc), rng, tile)
        lengths = rng.integers(0, 3000, size=20)
        tplan_, jplan_ = tp.plan(lengths), jp.plan(lengths)
        assert [(b.kind, b.width, b.chunk_len) for b in tplan_.buckets] == [
            (b.kind, b.width, b.chunk_len) for b in jplan_.buckets]
        # a rebalance: new weights, the cached layouts drop
        new = _skewed_caps(shape, seed=100 + step)
        tw, trw = _weights(tpart, new, shape)
        jw, jrw = _weights(jpart, new, shape)
        tp.set_weights(tw, row_weights=trw)
        jp.set_weights(jw, row_weights=jrw)
    with pytest.raises(ValueError):
        tp.set_weights(np.ones(d + 1))


def test_on_device_classify_matches_classify_ref():
    """The executors' classify (``classify_pad_ref``) against the host
    ``classify_ref`` of both packages, row by row."""
    from repro.kernels.ref import classify_ref as jclassify_ref

    from repro_torch.core import pack_dfas
    from repro_torch.core.engine import DeviceTables, LocalExecutor
    from repro_torch.kernels.ref import classify_ref
    rng = np.random.default_rng(25)
    packed = pack_dfas(_tdfas())
    ex = LocalExecutor(DeviceTables.build(packed, device="cpu"),
                       num_chunks=4)
    for _ in range(5):
        b, w = int(rng.integers(1, 6)), int(rng.integers(1, 200))
        buf = rng.integers(0, 256, size=(b, w), dtype=np.uint8)
        lens = rng.integers(0, w + 1, size=b).astype(np.int32)
        got = ex._classify(torch.from_numpy(buf),
                           torch.from_numpy(lens)).numpy()
        for r in range(b):
            want = classify_ref(packed.byte_to_class, buf[r, :lens[r]])
            np.testing.assert_array_equal(got[r, :lens[r]], want)
            np.testing.assert_array_equal(
                want, jclassify_ref(packed.byte_to_class, buf[r, :lens[r]]))
            assert (got[r, lens[r]:] == ex.t.pad_cls).all()
        assert classify_ref(packed.byte_to_class, bytes(buf[0])).dtype \
            == np.int32


# --------------------------------------------------------------------------
# one world of one for the rest of the module
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    assert not dist.is_initialized()
    store = tmp_path_factory.mktemp("world") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_make_matcher_mesh_shapes_and_refusals(world):
    from repro_torch.launch.mesh import (make_matcher_mesh,
                                         matcher_mesh_extents, mesh_info)
    mesh = make_matcher_mesh(device="cpu")
    assert matcher_mesh_extents(mesh) == (1, 1)
    assert make_matcher_mesh(shape="auto", device="cpu") is mesh
    assert make_matcher_mesh(1, shape=(1, 1), device="cpu") is mesh
    assert mesh_info(mesh) == {"axes": {"doc": 1, "chunk": 1},
                               "n_devices": 1, "dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_matcher_mesh(shape=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="does not use"):
        make_matcher_mesh(devices=1, shape=(1, 2), device="cpu")
    from repro_torch.core import Matcher
    with pytest.raises(ValueError, match="not both"):
        Matcher(_tdfas(), backend="sharded", mesh=mesh, mesh_shape=(1, 1),
                device="cpu")
    with pytest.raises(ValueError, match="1 capacities"):
        Matcher(_tdfas(), backend="sharded", capacities=[1.0, 2.0],
                device="cpu")
    m = Matcher(_tdfas(), backend="local", device="cpu")
    with pytest.raises(ValueError, match="sharded backend only"):
        m.rebalance([1.0])


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["uniform", "weighted"])
@pytest.mark.parametrize("r", [1, 2])
def test_world_of_one_equals_jax_local(world, r, weighted):
    from repro.core import Matcher as JMatcher

    from repro_torch.core import Matcher
    rng = np.random.default_rng(20 + r + 2 * weighted)
    docs = _docs(rng, RAGGED + list(rng.integers(0, 700, size=11)))
    caps = [1.7] if weighted else None
    kw = dict(num_chunks=8, batch_tile=8, lookahead_r=r)
    jm = JMatcher(_jdfas(), **kw)
    tl = Matcher(_tdfas(), backend="local", device="cpu", **kw)
    ts = Matcher(_tdfas(), backend="sharded", capacities=caps, device="cpu",
                 **kw)
    want = jm.membership_batch(docs)
    got = ts.membership_batch(docs)
    np.testing.assert_array_equal(got.final_states, want.final_states)
    np.testing.assert_array_equal(got.accepted, want.accepted)
    np.testing.assert_array_equal(
        got.final_states, tl.membership_batch(docs).final_states)
    lengths = [len(d) for d in docs]
    np.testing.assert_array_equal(
        got.device_work, _jax_device_work((1, 1), caps, lengths, 8))
    assert got.early_exits == 0
    kinds = set(ts.perf_report()["lowerings"].values())
    assert kinds == {"spec-sharded", "seq-torch"}
    assert ts.perf_report()["kernel_skipped_steps"] is None
    # the streaming hooks
    cuts = [len(d) // 2 for d in docs]
    heads = [d[:k] for d, k in zip(docs, cuts)]
    tails = [d[k:] for d, k in zip(docs, cuts)]
    entry = np.tile(ts.packed.starts, (len(docs), 1)).astype(np.int32)
    h = ts.advance_segments(heads, entry)
    jh = jm.advance_segments(heads, entry)
    np.testing.assert_array_equal(h.final_states, jh.final_states)
    t = ts.advance_segments(tails, h.final_states)
    np.testing.assert_array_equal(t.final_states, want.final_states)
    keys = np.array([ts.dev.advance_key(-1, x) for x in heads], np.int32)
    keep = keys >= 0
    s = ts.dev.i_max
    lanes = np.repeat(h.final_states[keep][:, :, None], s, axis=2)
    segs = [x for x, k in zip(tails, keep) if k]
    cur = ts.advance_cursors(segs, lanes, keys[keep])
    jcur = jm.advance_cursors(segs, lanes, keys[keep])
    np.testing.assert_array_equal(cur.lane_states, jcur.lane_states)
    # a rebalance re-lowers the spec programs and changes no decision
    traces = ts.trace_count
    ts.rebalance([0.4])
    np.testing.assert_array_equal(
        ts.membership_batch(docs).final_states, want.final_states)
    assert ts.trace_count > traces
    np.testing.assert_array_equal(
        ts.advance_cursors(segs, lanes, keys[keep]).lane_states,
        jcur.lane_states)


def test_world_of_one_compose_and_recalibrate(world):
    from repro.kernels.ref import spec_merge_lanes_scan_ref

    from repro_torch.core import Matcher
    from repro_torch.core.profiling import clear_calibration_cache
    rng = np.random.default_rng(5)
    ts = Matcher(_tdfas(), backend="sharded", num_chunks=4, device="cpu")
    k, s, q = ts.n_patterns, ts.tables.i_max, ts.packed.n_states
    for b, n in ((3, 5), (4, 8), (1, 1)):
        maps = rng.integers(0, q, size=(b, n, k, s)).astype(np.int32)
        keys = rng.integers(0, ts.dev.pad_key + 1, size=(b, n)).astype(
            np.int32)
        got = ts.compose_lane_maps(maps, keys)
        want = np.asarray(spec_merge_lanes_scan_ref(
            maps, keys, ts.dev.cidx_pad_t.numpy(), ts.packed.sinks,
            pad_cls=ts.dev.pad_key))[:, -1]    # the last scan prefix
        np.testing.assert_array_equal(got, want)
    assert ts.perf_report()["compose_lowering"] == "compose-kernel-carry"
    clear_calibration_cache()
    mc = Matcher(_tdfas(), backend="sharded", calibrate=True, device="cpu")
    assert mc.capacities.shape == (1,) and mc.capacities[0] > 0
    caps = mc.recalibrate(n_symbols=4096, repeats=1)
    assert caps.shape == (1,) and mc.capacities is not None
    docs = _docs(rng, [40, 300, 5])
    np.testing.assert_array_equal(
        mc.membership_batch(docs).final_states,
        Matcher(_tdfas(), backend="local", device="cpu")
        .membership_batch(docs).final_states)


def test_world_of_one_tune_and_filter(world, monkeypatch, tmp_path):
    from repro.data import CorpusFilter as JCorpusFilter

    from repro_torch.core import Matcher
    from repro_torch.core.profiling import clear_autotune_cache
    from repro_torch.data import CorpusFilter
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    clear_autotune_cache()
    rng = np.random.default_rng(9)
    docs = _docs(rng, [0, 20, 64, 300, 800])
    mt = Matcher(_tdfas(), backend="sharded", autotune=True,
                 mesh_shape="auto", batch_tile=8, device="cpu")
    tuned = mt.perf_report()["autotune"]
    assert tuned["mesh_shape"] == (1, 1) and tuned["source"] == "measured"
    assert mt.num_chunks == tuned["num_chunks"]
    np.testing.assert_array_equal(
        mt.membership_batch(docs).final_states,
        Matcher(_tdfas(), backend="local", device="cpu")
        .membership_batch(docs).final_states)
    patterns = [r"SECRET-[0-9]+", r"key=[a-z]{4}"]
    corpus = []
    for n in rng.integers(5, 400, size=16):
        d = bytearray(rng.choice(list(b"abc 01xyz="), size=int(n))
                      .astype(np.uint8))
        if rng.random() < 0.5:
            d[2:2] = b"SECRET-7"
        corpus.append(bytes(d))
    want = JCorpusFilter(patterns, num_chunks=8).scan_batch(corpus)
    for kw in ({}, {"k_blk": 1}):
        got = CorpusFilter(patterns, num_chunks=8, backend="sharded",
                           capacities=[1.0], batch_tile=8, device="cpu",
                           **kw).scan_batch(corpus)
        np.testing.assert_array_equal(got, want)


def test_world_of_one_reshard_tree_and_restore_checkpoint(world, tmp_path):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import reshard_tree
    from repro_torch.launch.mesh import make_matcher_mesh
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    mesh = make_matcher_mesh(device="cpu")
    repl = (mesh, [Replicate(), Replicate()])
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": [torch.ones(4), np.bool_(True)], "c": np.int64(7)}
    out = reshard_tree(tree, {"a": (mesh, [Replicate(), Shard(0)]),
                              "b": [repl, None], "c": repl})
    assert isinstance(out["a"], DTensor) and isinstance(out["c"], DTensor)
    np.testing.assert_array_equal(out["a"].full_tensor().numpy(), tree["a"])
    assert torch.equal(out["b"][0].full_tensor(), tree["b"][0])
    assert out["b"][1] is tree["b"][1] and out["c"].shape == ()
    assert int(out["c"].to_local()) == 7
    save_checkpoint(str(tmp_path), {"w": torch.arange(5.0),
                                    "n": np.arange(3)}, 2)
    got, step = restore_checkpoint(
        str(tmp_path), {"w": torch.zeros(0), "n": np.zeros(0)},
        shardings={"w": repl, "n": repl})
    assert step == 2
    assert torch.equal(got["w"].full_tensor(), torch.arange(5.0))
    np.testing.assert_array_equal(got["n"].to_local().numpy(), np.arange(3))


def _stream_half(sm, docs):
    sessions = [sm.open() for _ in docs]
    for s, d in zip(sessions, docs):
        s.feed(d[:16])
    sm.flush()
    for s, d in zip(sessions, docs):
        s.feed(d[16:40])           # pending at snapshot time
    return sessions


def _stream_rest(sm, sessions, docs):
    for s, d in zip(sessions, docs):
        s.feed(d[40:])
    sm.flush()
    return np.stack([s.close().final_states for s in sessions])


def _ooo_half(ooo, docs_segs):
    streams = [ooo.open() for _ in docs_segs]
    for s, (doc, segs) in zip(streams, docs_segs):
        s.feed(0, segs[0])
        for i in range(1, len(segs), 2):
            s.feed(i, segs[i],
                   prev_tail=doc[i * 6 - 2:i * 6] if i % 4 == 1 else None)
    ooo.flush()
    return streams


def _ooo_rest(streams, docs_segs):
    for s, (_, segs) in zip(streams, docs_segs):
        for i in range(2, len(segs), 2):
            s.feed(i, segs[i])
    return np.stack([s.close().final_states for s in streams])


@pytest.mark.parametrize("direction", ["jax-to-sharded", "sharded-to-jax"])
def test_world_of_one_snapshots_cross_packages(world, tmp_path, direction):
    from repro.core import Matcher as JMatcher
    from repro.streaming import OooPolicy as JOooPolicy
    from repro.streaming import OooStreamMatcher as JOooStreamMatcher
    from repro.streaming import StreamMatcher as JStreamMatcher
    from repro.streaming import TickPolicy as JTickPolicy

    from repro_torch.core import Matcher
    from repro_torch.streaming import (OooPolicy, OooStreamMatcher,
                                       StreamMatcher, TickPolicy)
    rng = np.random.default_rng(31)
    docs = _docs(rng, [48, 90, 130, 70])
    want = JMatcher(_jdfas()).membership_batch(docs).final_states
    lazy, jlazy = TickPolicy(max_batch=1 << 20), JTickPolicy(max_batch=1 << 20)

    def sharded():
        return Matcher(_tdfas(), backend="sharded", num_chunks=4,
                       batch_tile=8, device="cpu")

    def jax_local():
        return JMatcher(_jdfas(), num_chunks=4, batch_tile=8)

    src_is_jax = direction == "jax-to-sharded"
    make_src, make_dst = ((lambda: JStreamMatcher(jax_local(), policy=jlazy),
                           lambda: StreamMatcher(sharded(), policy=lazy))
                          if src_is_jax else
                          (lambda: StreamMatcher(sharded(), policy=lazy),
                           lambda: JStreamMatcher(jax_local(), policy=jlazy)))
    sm = make_src()
    sessions = _stream_half(sm, docs)
    sm.snapshot(str(tmp_path / "s"))
    sm2 = make_dst()
    restored = {s.sid: s for s in sm2.restore(str(tmp_path / "s"))}
    got = _stream_rest(sm2, [restored[s.sid] for s in sessions], docs)
    np.testing.assert_array_equal(got, want)
    # the out-of-order tier: parked maps and raw payloads cross too
    plan = []
    for seed in (41, 42, 43):
        r = random.Random(seed)
        doc = bytes(r.choice(list(ALPHABET)) for _ in range(72))
        plan.append((doc, [doc[i * 6:(i + 1) * 6] for i in range(12)]))
    owant = JMatcher(_jdfas()).membership_batch(
        [d for d, _ in plan]).final_states
    make_osrc, make_odst = (
        (lambda: JOooStreamMatcher(jax_local(), policy=JOooPolicy(
            match_batch=64)),
         lambda: OooStreamMatcher(sharded(), policy=OooPolicy(
             match_batch=64)))
        if src_is_jax else
        (lambda: OooStreamMatcher(sharded(), policy=OooPolicy(
            match_batch=64)),
         lambda: JOooStreamMatcher(jax_local(), policy=JOooPolicy(
             match_batch=64))))
    ooo = make_osrc()
    streams = _ooo_half(ooo, plan)
    ooo.snapshot(str(tmp_path / "o"))
    ooo2 = make_odst()
    back = {s.sid: s for s in ooo2.restore(str(tmp_path / "o"))}
    got = _ooo_rest([back[s.sid] for s in streams], plan)
    np.testing.assert_array_equal(got, owant)


# --------------------------------------------------------------------------
# spawned worlds: one process per rank over gloo
# --------------------------------------------------------------------------

def _expected(shape, path):
    """Every array a spawned world is held to, computed with the JAX
    package (``backend="local"``) and its layout arithmetic."""
    from repro.core import Matcher as JMatcher
    d = shape[0] * shape[1]
    rng = np.random.default_rng(60 + 7 * shape[0] + shape[1])
    docs = _docs(rng, RAGGED + list(rng.integers(0, 1200, size=11)))
    longs = _docs(rng, rng.integers(300, 900, size=6))
    jm = JMatcher(_jdfas(), num_chunks=8, batch_tile=8)
    want = jm.membership_batch(docs).final_states
    lengths = [len(x) for x in docs]
    caps = _skewed_caps(shape, seed=d)
    caps2 = np.roll(caps, 1) * 1.5
    cuts = [len(x) // 2 for x in docs]
    heads = [x[:k] for x, k in zip(docs, cuts)]
    tails = [x[k:] for x, k in zip(docs, cuts)]
    h = jm.advance_segments(heads, np.tile(jm.packed.starts, (len(docs), 1)))
    keys = np.array([jm.dev.advance_key(-1, x) for x in heads], np.int32)
    keep = np.flatnonzero(keys >= 0)
    lanes = np.repeat(h.final_states[keep][:, :, None], jm.tables.i_max,
                      axis=2)
    cur = jm.advance_cursors([tails[i] for i in keep], lanes, keys[keep])
    ooo_docs = _docs(rng, [60, 96, 150, 33, 120, 80])
    segs, orders = [], []
    for doc in ooo_docs:
        cut = sorted(set(rng.integers(0, len(doc), size=8).tolist()
                         + [0, len(doc)]))
        segs.append(np.array(cut, np.int64))
        orders.append(rng.permutation(len(cut) - 1))
    stream_docs = _docs(rng, [64, 100, 40, 77])
    blob, off = _pack(docs)
    lblob, loff = _pack(longs)
    oblob, ooff = _pack(ooo_docs)
    sblob, soff = _pack(stream_docs)
    cut_off = np.concatenate([[0], np.cumsum([len(c) for c in segs])])
    ord_off = np.concatenate([[0], np.cumsum([len(o) for o in orders])])
    np.savez(
        path, docs=blob, doc_off=off, longs=lblob, long_off=loff,
        want=want, want_long=jm.membership_batch(longs).final_states,
        work_uniform=_jax_device_work(shape, None, lengths, 8),
        work_weighted=_jax_device_work(shape, caps, lengths, 8),
        work_rebalanced=_jax_device_work(shape, caps2, lengths, 8),
        caps=caps, caps2=caps2, cuts=np.array(cuts), head_finals=
        h.final_states, keep=keep, keys=keys, want_lanes=cur.lane_states,
        ooo_docs=oblob, ooo_off=ooff,
        ooo_cuts=np.concatenate(segs), ooo_cut_off=cut_off,
        ooo_orders=np.concatenate(orders), ooo_order_off=ord_off,
        want_ooo=jm.membership_batch(ooo_docs).final_states,
        stream_docs=sblob, stream_off=soff,
        want_stream=jm.membership_batch(stream_docs).final_states)


def _child_cases(shape, data, snap_dir) -> dict:
    """Every case of one spawned world, on this rank (no jax here)."""
    from repro_torch.core import Matcher
    from repro_torch.distributed import StragglerPolicy
    from repro_torch.launch import mesh as lmesh
    from repro_torch.streaming import (FaultPlan, OooPolicy,
                                       OooStreamMatcher, StreamMatcher,
                                       TickPolicy)
    dfas = _tdfas()
    d = shape[0] * shape[1]
    docs = _unpack(data["docs"], data["doc_off"])
    mesh = lmesh.make_matcher_mesh(shape=shape, device="cpu")
    # count the collectives per group: "chunk", "doc" or the whole mesh
    names = {id(mesh.get_group("chunk")): "chunk",
             id(mesh.get_group("doc")): "doc",
             id(lmesh.mesh_group(mesh)): "mesh"}
    seen = []
    gather = lmesh._ALL_GATHER

    def spy(out, src, group=None):
        seen.append(names.get(id(group), "other"))
        return gather(out, src, group=group)

    lmesh._ALL_GATHER = spy
    rep = {}

    def same(got, want, what):
        if not np.array_equal(got, want):
            raise AssertionError(f"{shape}: {what} differs")

    kw = dict(num_chunks=8, batch_tile=8, backend="sharded", mesh=mesh,
              device="cpu")
    m = Matcher(dfas, **kw)
    res = m.membership_batch(docs)
    same(res.final_states, data["want"], "uniform finals")
    same(res.device_work, data["work_uniform"], "uniform device_work")
    assert res.early_exits == 0
    # a call of speculative documents only: one lane-state gather over
    # "chunk" and one row collection over "doc" a tile, nothing else
    seen.clear()
    res = m.membership_batch(_unpack(data["longs"], data["long_off"]))
    same(res.final_states, data["want_long"], "long finals")
    rep["spec_collectives"] = {a: seen.count(a) for a in set(seen)}
    rep["spec_tiles"] = res.bucket_calls
    mw = Matcher(dfas, capacities=data["caps"], **kw)
    res = mw.membership_batch(docs)
    same(res.final_states, data["want"], "weighted finals")
    same(res.device_work, data["work_weighted"], "weighted device_work")
    mw.rebalance(data["caps2"])
    res = mw.membership_batch(docs)
    same(res.final_states, data["want"], "rebalanced finals")
    same(res.device_work, data["work_rebalanced"], "rebalanced device_work")
    rep["kinds"] = sorted(set(mw.perf_report()["lowerings"].values()))
    # the streaming hooks, after the rebalance
    cuts = data["cuts"]
    heads = [x[:k] for x, k in zip(docs, cuts)]
    tails = [x[k:] for x, k in zip(docs, cuts)]
    h = mw.advance_segments(heads, np.tile(mw.packed.starts, (len(docs), 1)))
    same(h.final_states, data["head_finals"], "advance_segments heads")
    t = mw.advance_segments(tails, h.final_states)
    same(t.final_states, data["want"], "advance_segments tails")
    keep = data["keep"]
    lanes = np.repeat(h.final_states[keep][:, :, None], mw.tables.i_max,
                      axis=2)
    cur = mw.advance_cursors([tails[i] for i in keep], lanes,
                             data["keys"][keep])
    same(cur.lane_states, data["want_lanes"], "advance_cursors lanes")
    # one out-of-order run over a sharded matcher
    ooo = OooStreamMatcher(Matcher(dfas, num_chunks=4, batch_tile=8,
                                   backend="sharded", mesh=mesh,
                                   device="cpu"),
                           policy=OooPolicy(match_batch=8))
    odocs = _unpack(data["ooo_docs"], data["ooo_off"])
    cut_off, ord_off = data["ooo_cut_off"], data["ooo_order_off"]
    streams = [ooo.open() for _ in odocs]
    for j, (s, doc) in enumerate(zip(streams, odocs)):
        cut = data["ooo_cuts"][cut_off[j]:cut_off[j + 1]]
        for i in data["ooo_orders"][ord_off[j]:ord_off[j + 1]]:
            s.feed(int(i), doc[cut[i]:cut[i + 1]],
                   prev_tail=doc[max(0, cut[i] - 2):cut[i]] if i % 2 else None)
    got = np.stack([s.close().final_states for s in streams])
    same(got, data["want_ooo"], "out-of-order finals")
    rep["ooo_scan_folds"] = ooo.stats.scan_folds
    # the straggler hook: rank 0 reported 8x slower from tick 1 on
    skew = np.ones(d)
    skew[0] = 8.0
    sm = StreamMatcher(dfas, backend="sharded", mesh=mesh, num_chunks=4,
                       batch_tile=8, device="cpu",
                       policy=TickPolicy(max_batch=1 << 20),
                       straggler=StragglerPolicy(n_workers=d),
                       fault_plan=FaultPlan(capacity_skew={
                           t: skew for t in range(1, 128)}))
    sdocs = _unpack(data["stream_docs"], data["stream_off"])
    sessions = [sm.open() for _ in sdocs]
    for r in range(max(-(-len(x) // 8) for x in sdocs)):
        for s, x in zip(sessions, sdocs):
            if x[r * 8:(r + 1) * 8]:
                s.feed(x[r * 8:(r + 1) * 8])
        sm.flush()
    got = np.stack([s.close().final_states for s in sessions])
    same(got, data["want_stream"], "straggler stream finals")
    rep["rebalances"] = sm.stats.rebalances
    rep["stream_caps"] = sm.matcher.capacities.tolist()
    # a snapshot mid-stream: one rank writes it, the parent restores it on
    # other meshes and in the JAX package
    sm = StreamMatcher(Matcher(dfas, num_chunks=4, batch_tile=8,
                               backend="sharded", mesh=mesh, device="cpu"),
                       policy=TickPolicy(max_batch=1 << 20))
    rep["snap_sids"] = [s.sid for s in _stream_half(sm, sdocs)]
    rep["snap_path"] = sm.snapshot(snap_dir)
    rep["snap_seen"] = os.path.isdir(rep["snap_path"])
    lmesh._ALL_GATHER = gather
    return rep


def _child_main(rank: int, world: int, store: str, shape, data_path: str,
                out_path: str, snap_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        rep = _child_cases(shape, np.load(data_path), snap_dir)
        rep["foreign"] = sorted(m for m in sys.modules
                                if m in ("jax", "repro")
                                or m.startswith(("jax.", "repro.")))
        with open(out_path, "w") as fh:
            json.dump(rep, fh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", SPAWNED,
                         ids=[f"{a}x{b}" for a, b in SPAWNED])
def test_spawned_world(world, shape, tmp_path):
    """One process per rank; every case against the JAX package's arrays;
    each child under a time limit, any child's failure fails the test.  The
    world's mid-stream snapshot then restores on this process's 1x1 mesh
    and in the JAX package."""
    n = shape[0] * shape[1]
    data = tmp_path / "want.npz"
    _expected(shape, data)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(n), str(tmp_path / "store"),
         f"{shape[0]}x{shape[1]}", str(data), str(tmp_path / f"out{r}.json"),
         str(tmp_path / "snap")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    t0, logs = time.monotonic(), []
    try:
        for p in procs:
            left = CHILD_TIMEOUT_S - (time.monotonic() - t0)
            logs.append(p.communicate(timeout=max(left, 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:])
              for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, failed
    reps = [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(n)]
    for rep in reps:
        assert rep["foreign"] == []
        tiles = rep["spec_tiles"]
        # one gather a tile over each axis of more than one rank (an axis
        # of one rank moves nothing)
        assert rep["spec_collectives"] == {
            a: tiles for a, k in zip(("doc", "chunk"), shape) if k > 1}
        # a tile of 8 rows splits over 4 or 8 ranks: "seq-sharded"
        assert rep["kinds"] == ["seq-sharded", "spec-sharded"]
        assert rep["ooo_scan_folds"] > 0
        assert rep["rebalances"] >= 1
    # every rank agreed on the rebalance: the same capacities everywhere
    assert all(rep["stream_caps"] == reps[0]["stream_caps"] for rep in reps)
    assert reps[0]["stream_caps"][0] < max(reps[0]["stream_caps"])
    # the snapshot: published once, seen by every rank, restored elsewhere
    assert all(rep["snap_seen"] and rep["snap_path"] == reps[0]["snap_path"]
               for rep in reps)
    assert os.listdir(tmp_path / "snap") == ["step_00000000"]
    from repro.core import Matcher as JMatcher
    from repro.streaming import StreamMatcher as JStreamMatcher
    from repro.streaming import TickPolicy as JTickPolicy

    from repro_torch.core import Matcher
    from repro_torch.streaming import StreamMatcher, TickPolicy
    want = np.load(data)
    sdocs = _unpack(want["stream_docs"], want["stream_off"])
    for sm in (StreamMatcher(Matcher(_tdfas(), backend="sharded",
                                     device="cpu"),
                             policy=TickPolicy(max_batch=1 << 20)),
               JStreamMatcher(JMatcher(_jdfas()),
                              policy=JTickPolicy(max_batch=1 << 20))):
        back = {s.sid: s for s in sm.restore(str(tmp_path / "snap"))}
        got = _stream_rest(sm, [back[i] for i in reps[0]["snap_sids"]],
                           sdocs)
        np.testing.assert_array_equal(got, want["want_stream"])


if __name__ == "__main__":
    _r, _w, _store, _shape, _data, _out, _snap = sys.argv[1:8]
    _child_main(int(_r), int(_w), _store,
                tuple(int(x) for x in _shape.split("x")), _data, _out, _snap)
