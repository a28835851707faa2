"""The port's plain PyTorch oracles (``repro_torch.kernels.ref``) against the
JAX package's (``repro.kernels.ref``) on random packed tables, under r=1 and
r=2 boundary keys with pad-key rows.  Zero tolerance: all outputs are ids."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pack_dfas, random_dfa
from repro.core.engine.plan import DeviceTables
from repro.kernels import ref as jref

from repro_torch.kernels import ref as tref


def _case(shape, r, seed):
    """Random packed tables and one padded chunked batch (the shapes of the
    JAX package's kernel tests), as numpy arrays."""
    b, c, lc = shape
    rng = np.random.default_rng(seed)
    packed = pack_dfas([random_dfa(8, 4, rng=rng), random_dfa(5, 3, rng=rng)])
    dev = DeviceTables.build(packed, lookahead_r=r)
    t = dev.tables
    k, s, q = packed.n_patterns, t.i_max, packed.n_states
    table = np.concatenate(
        [packed.table, np.arange(q, dtype=np.int32).reshape(-1, 1)], axis=1)
    cidx = np.concatenate([t.cand_index, np.full((1, q), -1, np.int32)])
    cand = np.concatenate([t.candidates, t.candidates[:1]])
    docs = [rng.integers(0, 256, size=int(n), dtype=np.uint8)
            for n in rng.integers(c * lc // 3, c * lc + 1, size=b)]
    chunks = np.full((b, c, lc), dev.pad_cls, np.int32)
    for i, d in enumerate(docs):
        cls = packed.classes_of(d)
        chunks.reshape(b, -1)[i, :len(cls)] = cls
    last1 = chunks[:, :-1, -1]
    if dev.spec_r == 2:
        key = chunks[:, :-1, -2] * dev.pad_cls + last1
        key = np.where(last1 == dev.pad_cls, dev.pad_key, key)
    else:
        key = last1
    la = np.zeros((b, c), np.int32)
    la[:, 1:] = key
    init = np.zeros((b, c, k, s), np.int32)
    init[:, 0] = np.broadcast_to(packed.starts[:, None], (k, s))
    init[:, 1:] = cand[la[:, 1:]]
    lane_init = init.copy()
    lane_init[:, 0] = t.candidates[rng.integers(0, dev.n_keys, size=b)]
    return dict(packed=packed, dev=dev, table=table, cidx=cidx, cand=cand,
                chunks=chunks, la=la, init=init.reshape(b, c, k * s),
                lane_init=lane_init.reshape(b, c, k * s), docs=docs)


SHAPES = [(2, 4, 8), (3, 2, 16), (1, 8, 32)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_spec_match_merge_ref_agrees(shape, r):
    cs = _case(shape, r, seed=80 + r)
    dev = cs["dev"]
    args = (cs["table"], cs["chunks"], cs["init"], cs["la"], cs["cidx"],
            cs["packed"].sinks)
    want = np.asarray(jref.spec_match_merge_ref(
        *map(jnp.asarray, args), pad_cls=dev.pad_key))
    got = tref.spec_match_merge_ref(*map(_t, args), pad_cls=dev.pad_key)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = np.stack([cs["packed"].run_all(d) for d in cs["docs"]])
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_spec_match_merge_lanes_ref_agrees(shape, r):
    cs = _case(shape, r, seed=90 + r)
    dev = cs["dev"]
    args = (cs["table"], cs["chunks"], cs["lane_init"], cs["la"], cs["cidx"],
            cs["packed"].sinks)
    want = np.asarray(jref.spec_match_merge_lanes_ref(
        *map(jnp.asarray, args), pad_cls=dev.pad_key))
    got = tref.spec_match_merge_lanes_ref(*map(_t, args), pad_cls=dev.pad_key)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lanes", [False, True], ids=["finals", "lanes"])
@pytest.mark.parametrize("r", [1, 2])
def test_spec_merge_exact_flags_agree(r, lanes):
    """The fold with ``exact`` chunk flags (weighted layouts' zero-length
    leading chunks) and random lane states."""
    cs = _case((3, 5, 8), r, seed=100 + r)
    dev = cs["dev"]
    rng = np.random.default_rng(5)
    b, c = cs["la"].shape
    k = cs["packed"].n_patterns
    q = cs["packed"].n_states
    lv = rng.integers(0, q, size=(b, c, k, dev.i_max)).astype(np.int32)
    exact = np.array([True, False, True, False, False])
    jfn, tfn = ((jref.spec_merge_lanes_ref, tref.spec_merge_lanes_ref) if lanes
                else (jref.spec_merge_ref, tref.spec_merge_ref))
    want = np.asarray(jfn(jnp.asarray(lv), jnp.asarray(cs["la"]),
                          jnp.asarray(cs["cidx"]),
                          jnp.asarray(cs["packed"].sinks),
                          pad_cls=dev.pad_key, exact=jnp.asarray(exact)))
    got = tfn(_t(lv), _t(cs["la"]), _t(cs["cidx"]), _t(cs["packed"].sinks),
              pad_cls=dev.pad_key, exact=exact)
    np.testing.assert_array_equal(got.numpy(), want)


def test_classify_pad_ref_agrees():
    rng = np.random.default_rng(6)
    b2c = rng.integers(0, 7, size=256).astype(np.int32)
    buf = rng.integers(0, 256, size=(4, 32), dtype=np.uint8)
    lengths = np.array([0, 5, 32, 17])
    want = jref.classify_pad_ref(b2c, buf, lengths, 7)
    got = tref.classify_pad_ref(_t(b2c), _t(buf), _t(lengths), 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r", [1, 2])
def test_cursor_merge_ref_agrees(r):
    cs = _case((4, 2, 8), r, seed=110 + r)
    dev = cs["dev"]
    rng = np.random.default_rng(7)
    b, k, s = 4, cs["packed"].n_patterns, dev.i_max
    cursor = rng.integers(0, cs["packed"].n_states, size=(b, k, s))
    seg = rng.integers(0, cs["packed"].n_states, size=(b, k, s))
    keys = np.array([0, dev.pad_key, dev.n_keys - 1, 1], np.int32)
    args = (cursor, seg, keys, cs["cidx"], cs["packed"].sinks)
    np.testing.assert_array_equal(
        tref.cursor_merge_ref(*args, pad_cls=dev.pad_key),
        jref.cursor_merge_ref(*args, pad_cls=dev.pad_key))


# the full-map oracles of the paper engine's kernels (B6, B7, B8), at the
# shapes of the JAX package's kernel tests

def _table(q, ncls, seed):
    return np.random.default_rng(seed).integers(
        0, q, size=(q, ncls)).astype(np.int32)


@pytest.mark.parametrize("q,ncls,c,l,s", [
    (4, 2, 1, 16, 1), (17, 5, 6, 384, 9), (130, 7, 3, 130, 130),
    (257, 26, 2, 97, 33)])
def test_spec_match_ref_agrees(q, ncls, c, l, s):
    rng = np.random.default_rng(q + l)
    table = _table(q, ncls, q)
    chunks = rng.integers(0, ncls, size=(c, l)).astype(np.int32)
    init = rng.integers(0, q, size=(c, s)).astype(np.int32)
    want = np.asarray(jref.spec_match_ref(*map(jnp.asarray,
                                                (table, chunks, init))))
    got = tref.spec_match_ref(_t(table), _t(chunks), _t(init))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,q", [(1, 4), (8, 17), (16, 128), (7, 33),
                                 (24, 257)])
def test_lvec_compose_ref_agrees(c, q):
    maps = np.random.default_rng(c * q).integers(
        0, q, size=(c, q)).astype(np.int32)
    want = np.asarray(jref.lvec_compose_ref(jnp.asarray(maps)))
    got = tref.lvec_compose_ref(_t(maps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    batched = tref.lvec_compose_ref(_t(np.stack([maps, maps[::-1]])))
    np.testing.assert_array_equal(batched[0].numpy(), want)


@pytest.mark.parametrize("q,ncls,l,blk", [
    (4, 2, 64, 16), (16, 4, 256, 64), (64, 8, 512, 128), (128, 16, 256, 256),
    (257, 5, 96, 32)])
def test_onehot_block_maps_ref_agrees(q, ncls, l, blk):
    rng = np.random.default_rng(q + l)
    table = _table(q, ncls, q + 1)
    syms = rng.integers(0, ncls, size=l).astype(np.int32)
    want = np.asarray(jref.onehot_block_maps_ref(jnp.asarray(table),
                                                 jnp.asarray(syms), blk))
    got = tref.onehot_block_maps_ref(_t(table), _t(syms), blk)
    assert got.dtype == torch.int32 and got.shape == (l // blk, q)
    np.testing.assert_array_equal(got.numpy(), want)
