"""The keyed lane-map compose of the port (kernels B3/B4 and their callers).

The same real lane-map runs — matched by the JAX package from seeded random
traffic, so the sinks absorb and the combine is associative — go through
the JAX function and its port: ``merge_scan_lanes_torch`` against
``merge_scan_lanes_jnp``, the port's ``ops.spec_compose_lanes`` on CPU
tensors (the kernels' plain versions) against the JAX Pallas kernels in
interpret mode, and ``Matcher.compose_lane_maps`` against the JAX
``Matcher``.  Every output is int32 state ids: the tolerance is zero.  Pad
lanes are masked only against the sequential oracle, where the contract
lets a tree or scan order differ (``repro.kernels.ops.spec_compose_lanes``).
The CUDA kernels themselves are held against their plain versions by
``tests/test_torch_kernels.py::test_compose_kernels_equal_plain_on_card``,
which needs the card.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.lvector import merge_scan_lanes_jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref

import repro_torch.core as tcore
from repro_torch.core.lvector import (compose, compose_torch, identity_lvec,
                                      merge_scan_lanes_torch, merge_sequential,
                                      merge_tree)
from repro_torch.kernels import lvec_compose, ops
from repro_torch.kernels import ref as tref

PATTERNS = [".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"]
ALPHABET = np.frombuffer(b"abxy0189", np.uint8)
RAGGED = ([4, 4, 4], [1, 5, 3, 7], [2], [6, 1])


def _jax_matcher(backend="local", r="auto", **kw):
    return jcore.Matcher([jcore.make_search_dfa(jcore.compile_regex(p))
                          for p in PATTERNS], backend=backend, lookahead_r=r,
                         num_chunks=2, batch_tile=8, **kw)


def _port_matcher(backend="local", r="auto"):
    return tcore.Matcher([tcore.make_search_dfa(tcore.compile_regex(p))
                          for p in PATTERNS], backend=backend, lookahead_r=r,
                         num_chunks=2, batch_tile=8, device="cpu")


def _lane_runs(m, rng, lens, seg_len=48):
    """Real lane-map runs of a matcher ``m`` (either package): row i chains
    ``lens[i]`` segment maps keyed on their true boundary keys; shorter rows
    right-pad with ``pad_key`` identities.  Returns maps [B, N, K, S] and
    keys [B, N]."""
    b, n = len(lens), max(lens)
    k, s = m.packed.n_patterns, m.dev.tables.i_max
    cands = np.asarray(m.dev.tables.candidates, np.int32)
    maps = np.zeros((b, n, k, s), np.int32)
    keys = np.full((b, n), m.dev.pad_key, np.int32)
    segs, flat_keys, where = [], [], []
    for i in range(b):
        data = rng.choice(ALPHABET, size=2 + lens[i] * seg_len).tobytes()
        key = m.dev.advance_key(-1, data[:2])
        for j in range(lens[i]):
            p = data[2 + j * seg_len:2 + (j + 1) * seg_len]
            segs.append(p)
            flat_keys.append(key)
            where.append((i, j))
            keys[i, j] = key
            key = m.dev.advance_key(key, p)
    fk = np.asarray(flat_keys, np.int32)
    res = m.advance_cursors(segs, np.ascontiguousarray(cands[fk]), fk)
    for (i, j), lm in zip(where, np.asarray(res.lane_states, np.int32)):
        maps[i, j] = lm
    return maps, keys


def _mask_pad_lanes(tables, out, keys0, fill=-7):
    """Keep the real candidate lanes of each run's first key (the lanes a
    consumer can address through ``cand_index``); fill the pad lanes."""
    cidx = np.asarray(tables.cand_index)
    cands = np.asarray(tables.candidates)
    b, (k, s) = len(keys0), cands.shape[1:]
    mask = (np.take_along_axis(cidx[keys0], cands[keys0].reshape(b, -1),
                               axis=1).reshape(b, k, s) == np.arange(s))
    return np.where(mask, out, fill)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


# --------------------------------------------------------------------------
# core.lvector
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2])
def test_merge_scan_lanes_torch_matches_jax(r):
    """Every prefix, every lane equals ``merge_scan_lanes_jnp`` (the odd/even
    recursion is mirrored); real lanes equal the sequential oracle."""
    rng = np.random.default_rng(90 + r)
    jm, tm = _jax_matcher(r=r), _port_matcher(r=r)
    assert tm.dev.spec_r == jm.dev.spec_r == r
    scan_jnp = jax.jit(functools.partial(  # eager jnp runs op by op: slow
        merge_scan_lanes_jnp, pad_key=jm.dev.pad_key, axis=1))
    for lens in ([1, 5, 3, 7], [6, 1], [8, 3, 5]):  # N = 7, 6, 8
        maps, keys = _lane_runs(jm, rng, lens)
        want = np.asarray(scan_jnp(maps, keys, jm.dev.cidx_pad_j,
                                   jm.dev.sinks_j))
        got = merge_scan_lanes_torch(_t(maps), _t(keys), tm.dev.cidx_pad_t,
                                     tm.dev.sinks_t, pad_key=tm.dev.pad_key,
                                     axis=1)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{lens}")
        oracle = tref.spec_merge_lanes_scan_ref(
            maps, keys, tm.dev.cidx_pad_t.numpy(), tm.packed.sinks,
            pad_cls=tm.dev.pad_key)
        np.testing.assert_array_equal(
            oracle, jref.spec_merge_lanes_scan_ref(
                maps, keys, np.asarray(jm.dev.cidx_pad_j), jm.packed.sinks,
                pad_cls=jm.dev.pad_key))
        for i in range(maps.shape[1]):
            np.testing.assert_array_equal(
                _mask_pad_lanes(tm.dev.tables, got.numpy()[:, i], keys[:, 0]),
                _mask_pad_lanes(tm.dev.tables, oracle[:, i], keys[:, 0]))
        # the scan axis may sit anywhere: axis 0 of a [N, K, S] run
        one = merge_scan_lanes_torch(_t(maps[0]), _t(keys[0]),
                                     tm.dev.cidx_pad_t, tm.dev.sinks_t,
                                     pad_key=tm.dev.pad_key)
        np.testing.assert_array_equal(one.numpy(), want[0])


def test_lvector_host_helpers():
    rng = np.random.default_rng(3)
    maps = rng.integers(0, 6, size=(5, 6)).astype(np.int32)
    full = identity_lvec(6)
    for m in maps:
        full = compose(full, m)
    np.testing.assert_array_equal(merge_tree(maps), full)
    assert merge_sequential(maps, 2) == int(full[2])
    got = compose_torch(_t(maps[:-1]), _t(maps[1:]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(maps[1:], maps[:-1], 1))
    with pytest.raises(ValueError):
        merge_tree(maps[:0])


# --------------------------------------------------------------------------
# kernels: ops.spec_compose_lanes on CPU tensors vs the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("mode", ["carry", "tree"])
def test_spec_compose_lanes_matches_pallas(mode, r):
    rng = np.random.default_rng(80 + r)
    jm, tm = _jax_matcher(r=r), _port_matcher(r=r)
    dev = tm.dev
    for lens in RAGGED:
        maps, keys = _lane_runs(jm, rng, lens)
        want = np.asarray(jops.spec_compose_lanes(
            maps, keys, jm.dev.cidx_pad_j, jm.dev.sinks_j,
            pad_key=jm.dev.pad_key, mode=mode))
        got = ops.spec_compose_lanes(_t(maps), _t(keys), dev.cidx_pad_t,
                                     dev.sinks_t, pad_key=dev.pad_key,
                                     mode=mode)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{mode} r={r} {lens}")
        oracle = tref.spec_compose_lanes_ref(
            maps, keys, dev.cidx_pad_t.numpy(), tm.packed.sinks,
            pad_cls=dev.pad_key)
        if mode == "carry":  # the oracle's order: every lane agrees
            np.testing.assert_array_equal(got.numpy(), oracle)
        np.testing.assert_array_equal(
            _mask_pad_lanes(dev.tables, got.numpy(), keys[:, 0]),
            _mask_pad_lanes(dev.tables, oracle, keys[:, 0]))


def test_plain_versions_pad_like_the_wrapper():
    """The plain versions equal the wrapper at the padded N it hands them;
    the carry pads to an ``n_blk`` multiple, the tree to a power of two."""
    rng = np.random.default_rng(7)
    jm, tm = _jax_matcher(r=2), _port_matcher(r=2)
    dev = tm.dev
    maps, keys = _lane_runs(jm, rng, [5, 3, 6])
    args = (dev.cidx_pad_t, dev.sinks_t)
    carry = lvec_compose.spec_compose_lanes_torch(
        _t(maps), _t(keys), *args, pad_key=dev.pad_key)
    for n_blk in (1, 4, 8):
        np.testing.assert_array_equal(
            ops.spec_compose_lanes(_t(maps), _t(keys), *args,
                                   pad_key=dev.pad_key, n_blk=n_blk).numpy(),
            carry.numpy())
    pad = np.full((3, 2), dev.pad_key, np.int32)
    tree = lvec_compose.spec_compose_lanes_tree_torch(
        _t(np.concatenate([maps, np.zeros_like(maps[:, :2])], 1)),
        _t(np.concatenate([keys, pad], 1)), *args, pad_key=dev.pad_key)
    np.testing.assert_array_equal(
        ops.spec_compose_lanes(_t(maps), _t(keys), *args,
                               pad_key=dev.pad_key, mode="tree").numpy(),
        tree.numpy())
    with pytest.raises(ValueError, match="power of two"):
        lvec_compose.spec_compose_lanes_tree_torch(_t(maps), _t(keys), *args,
                                                   pad_key=dev.pad_key)


def test_spec_compose_lanes_contract_errors():
    tm = _port_matcher()
    dev = tm.dev
    maps = torch.zeros((2, 3, tm.packed.n_patterns, dev.i_max),
                       dtype=torch.int32)
    keys = torch.full((2, 3), dev.pad_key, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        ops.spec_compose_lanes(maps, keys, dev.cidx_pad_t, dev.sinks_t,
                               pad_key=dev.pad_key, mode="bogus")
    with pytest.raises(AssertionError):
        ops.spec_compose_lanes(maps[:, :0], keys[:, :0], dev.cidx_pad_t,
                               dev.sinks_t, pad_key=dev.pad_key)
    # a run of pad-key identities is its seed
    for mode in ("carry", "tree"):
        out = ops.spec_compose_lanes(maps + 3, keys, dev.cidx_pad_t,
                                     dev.sinks_t, pad_key=dev.pad_key,
                                     mode=mode)
        assert bool((out == 3).all())
    # CPU tensors never reach the CUDA wrappers
    with pytest.raises(ValueError, match="CUDA"):
        lvec_compose.spec_compose_lanes_cuda(maps, keys, dev.cidx_pad_t,
                                             dev.sinks_t, pad_key=dev.pad_key)
    assert lvec_compose.launches == {"spec_compose_lanes": 0,
                                     "spec_compose_lanes_tree": 0,
                                     "lvec_compose": 0}
    assert lvec_compose.tree_in_smem(32, 14, 15)
    assert not lvec_compose.tree_in_smem(2048, 14, 15)
    assert not lvec_compose.tree_in_smem(32, 14, 15, in_smem=False)
    with pytest.raises(ValueError, match="shared memory"):
        lvec_compose.tree_in_smem(2048, 14, 15, in_smem=True)


# --------------------------------------------------------------------------
# facade: Matcher.compose_lane_maps on both backends vs the JAX Matcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2])
def test_compose_lane_maps_matches_jax(r):
    """Port ``local`` equals JAX ``local`` (the scan) on every lane, port
    ``cuda`` equals JAX ``pallas`` (the kernels) on every lane in both
    modes, and all of them equal the oracle on real lanes."""
    rng = np.random.default_rng(84 + r)
    pairs = {"local": (_jax_matcher("local", r), _port_matcher("local", r)),
             "carry": (_jax_matcher("pallas", r), _port_matcher("cuda", r)),
             "tree": (_jax_matcher("pallas", r), _port_matcher("cuda", r))}
    for jm, tm in (pairs["tree"],):
        jm.executor.compose_mode = tm.executor.compose_mode = "tree"
    ref_m = pairs["local"][0]
    for lens in ([3, 3], [1, 6, 4], [5]):
        maps, keys = _lane_runs(ref_m, rng, lens)
        oracle = tref.spec_compose_lanes_ref(
            maps, keys, np.asarray(ref_m.dev.cidx_pad_j), ref_m.packed.sinks,
            pad_cls=ref_m.dev.pad_key)
        for name, (jm, tm) in pairs.items():
            got = tm.compose_lane_maps(maps, keys)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(
                got, np.asarray(jm.compose_lane_maps(maps, keys)),
                err_msg=f"{name} r={r} {lens}")
            np.testing.assert_array_equal(
                _mask_pad_lanes(tm.dev.tables, got, keys[:, 0]),
                _mask_pad_lanes(tm.dev.tables, oracle, keys[:, 0]))
    for name, want in (("local", "compose-scan"),
                       ("carry", "compose-kernel-carry"),
                       ("tree", "compose-kernel-tree")):
        jm, tm = pairs[name]
        rep, jrep = tm.perf_report(), jm.perf_report()
        assert rep["compose_lowering"] == jrep["compose_lowering"] == want
        assert rep["compose_calls"] == jrep["compose_calls"] == 3
        # N pads to a power of two: 3 -> 4, 6 -> 8, 5 -> 8
        assert sorted(k for k, kind in tm.executor.lowering_kinds.items()
                      if kind.startswith("compose")) == sorted(
            k for k, kind in jm.executor.lowering_kinds.items()
            if kind.startswith("compose"))


def test_compose_lane_maps_fast_paths_and_validation():
    tm = _port_matcher("cuda")
    k, s = tm.packed.n_patterns, tm.dev.i_max
    assert tm.perf_report()["compose_lowering"] is None
    assert tm.compose_lane_maps(np.zeros((0, 3, k, s)),
                                np.zeros((0, 3))).shape == (0, k, s)
    assert tm.compose_lane_maps(np.zeros((2, 0, k, s)),
                                np.zeros((2, 0))).shape == (2, k, s)
    one = np.arange(2 * k * s, dtype=np.int32).reshape(2, 1, k, s) % 5
    np.testing.assert_array_equal(tm.compose_lane_maps(one, np.zeros((2, 1))),
                                  one[:, 0])
    assert tm.compose_calls == 0
    with pytest.raises(ValueError, match="lane_maps"):
        tm.compose_lane_maps(np.zeros((2, 3, k, s + 1)), np.zeros((2, 3)))
    with pytest.raises(ValueError, match="entry_keys must be"):
        tm.compose_lane_maps(np.zeros((2, 3, k, s)), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="boundary keys"):
        tm.compose_lane_maps(np.zeros((1, 2, k, s)),
                             np.array([[0, tm.dev.pad_key + 1]]))
