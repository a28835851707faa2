"""The fused match + merge wrappers (kernels B1/B2), the paper engine's
kernels' wrappers (B6 ``spec_match``, B7 ``lvec_compose``, B8
``onehot_block_maps``), the serving kernels' wrappers (B5 ``token_mask``,
B9 ``flash_attn``) and the card checks of every kernel.

On CPU tensors the port's ops run the kernels' plain versions.
``ops.spec_match_merge``/``spec_match_merge_lanes`` must return the JAX
Pallas kernels' finals or lanes, ``skipped`` block counts and ``l_blk``
exactly, ``ops.spec_match``/``lvec_compose``/``onehot_block_maps`` the JAX
ops' ids on both ``spec_match`` routes, ``ops.token_mask`` the JAX op's bits; ``ops.flash_attn`` agrees with
the JAX op within atol = rtol = 3e-2, the JAX package's own tolerance for
the kernel (the JAX side runs in interpret mode, as its own tests do).  The
CUDA kernels are held against their plain versions by the tests that need
the card; they skip here.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compile_regex as t_compile_regex
from repro_torch.core import make_search_dfa as t_make_search_dfa
from repro_torch.core import pack_dfas as t_pack_dfas
from repro_torch.core import random_dfa as t_random_dfa
from repro_torch.core.engine.plan import DeviceTables
from repro_torch.kernels import (dfa_match, flash_attn, lvec_compose,
                                 onehot_match, ops)
from repro_torch.kernels import ref as tref
from repro_torch.kernels import token_mask


def _batch(packed, dev, docs, c, lc, rng, lanes):
    """[B, C, Lc] classes, boundary keys and entry lanes of a doc batch."""
    b = len(docs)
    t = dev.tables
    k, s = packed.n_patterns, t.i_max
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
    cand = np.concatenate([t.candidates, t.candidates[:1]])
    init = np.zeros((b, c, k, s), np.int32)
    if lanes:
        init[:, 0] = t.candidates[rng.integers(0, dev.n_keys, size=b)]
    else:
        init[:, 0] = np.broadcast_to(packed.starts[:, None], (k, s))
    init[:, 1:] = cand[la[:, 1:]]
    return chunks, la, init.reshape(b, c, k * s)


def _operands(dev, chunks, la, init, device="cpu"):
    put = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32,
                                    device=device)
    return (put(dev.table_pad_t), put(chunks), put(init), put(la),
            put(dev.cidx_pad_t), put(dev.sinks_t), put(dev.absorbing_t))


def _random_case(r, seed, shape=(3, 4, 24)):
    b, c, lc = shape
    rng = np.random.default_rng(seed)
    packed = t_pack_dfas([t_random_dfa(8, 4, rng=rng),
                          t_random_dfa(5, 3, rng=rng)])
    dev = DeviceTables.build(packed, lookahead_r=r, device="cpu")
    docs = [rng.integers(0, 256, size=int(n), dtype=np.uint8)
            for n in rng.integers(c * lc // 3, c * lc + 1, size=b)]
    return packed, dev, docs, rng, shape


def _hit_case(seed, shape=(3, 4, 40)):
    """K = 1 search DFA on documents full of hits: lanes absorb early, so
    small blocks are skipped."""
    b, c, lc = shape
    rng = np.random.default_rng(seed)
    packed = t_pack_dfas([t_make_search_dfa(t_compile_regex(".*(ab|ba)"))])
    dev = DeviceTables.build(packed, device="cpu")
    docs = [b"ab" * (c * lc // 2), b"xyz" * 20 + b"ba" * 40, b"q" * (c * lc)]
    return packed, dev, docs[:b], rng, shape


CASES = [("random-r1", lambda: _random_case(1, 11)),
         ("random-r2", lambda: _random_case(2, 12)),
         ("hits", lambda: _hit_case(13))]


@pytest.fixture(scope="module")
def jops():
    return pytest.importorskip("repro.kernels.ops")


@pytest.mark.parametrize("l_blk", [8, 512])
@pytest.mark.parametrize("lanes", [False, True], ids=["B1", "B2"])
@pytest.mark.parametrize("case", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_ops_cpu_equals_pallas_interpret(jops, case, lanes, l_blk):
    import jax.numpy as jnp

    packed, dev, docs, rng, (b, c, lc) = case()
    chunks, la, init = _batch(packed, dev, docs, c, lc, rng, lanes)
    args_t = _operands(dev, chunks, la, init)
    args_j = tuple(jnp.asarray(a.numpy()) for a in args_t)
    tfn = ops.spec_match_merge_lanes if lanes else ops.spec_match_merge
    jfn = jops.spec_match_merge_lanes if lanes else jops.spec_match_merge
    for early_exit in (False, True):
        got, skipped, blk = tfn(*args_t, pad_cls=dev.pad_cls,
                                pad_key=dev.pad_key, early_exit=early_exit,
                                l_blk=l_blk)
        want, jskipped, jblk = jfn(*args_j, pad_cls=dev.pad_cls,
                                   pad_key=dev.pad_key,
                                   early_exit=early_exit, l_blk=l_blk)
        assert got.dtype == torch.int32 and skipped.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(skipped.numpy(), np.asarray(jskipped))
        assert blk == jblk
        if not early_exit:
            assert (skipped.numpy() == 0).all()
        if not lanes:
            oracle = np.stack([packed.run_all(d) for d in docs])
            np.testing.assert_array_equal(got.numpy(), oracle)


def test_hit_case_skips_blocks():
    packed, dev, docs, rng, (b, c, lc) = _hit_case(14)
    chunks, la, init = _batch(packed, dev, docs, c, lc, rng, False)
    _, skipped, blk = ops.spec_match_merge(
        *_operands(dev, chunks, la, init), pad_cls=dev.pad_cls,
        pad_key=dev.pad_key, l_blk=8)
    assert blk == 8
    assert skipped[0] > 0 and skipped[2] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    packed, dev, docs, rng, (b, c, lc) = _random_case(1, 15)
    chunks, la, init = _batch(packed, dev, docs, c, lc, rng, False)
    before = dict(dfa_match.launches)
    with pytest.raises(ValueError, match="CUDA"):
        dfa_match.spec_match_merge_cuda(*_operands(dev, chunks, la, init),
                                        pad_key=dev.pad_key, l_blk=lc)
    assert dfa_match.launches == before


def test_smem_plan():
    assert dfa_match.smem_plan(194, 38, 8, 1680) == (True, True)
    assert dfa_match.smem_plan(194, 38, 8, 1680, table_in_smem=False) == (
        False, True)
    assert dfa_match.smem_plan(72531, 23, 8, 10) == (False, True)
    assert dfa_match.smem_plan(100, 10, 8, 10 ** 6) == (True, False)
    assert dfa_match.smem_plan(194, 38, 8, 1680, carry_in_smem=False) == (
        True, False)
    with pytest.raises(ValueError):
        dfa_match.smem_plan(72531, 23, 8, 10, table_in_smem=True)
    with pytest.raises(ValueError):
        dfa_match.smem_plan(100, 10, 8, 10 ** 6, carry_in_smem=True)


def _class16_case(seed, shape):
    """One random DFA of 15 classes (16 with the pad column) and a sink."""
    b, c, lc = shape
    rng = np.random.default_rng(seed)
    packed = t_pack_dfas([t_random_dfa(40, 15, rng=rng)])
    dev = DeviceTables.build(packed, lookahead_r=1, device="cpu")
    docs = [rng.integers(0, 256, size=int(n), dtype=np.uint8)
            for n in rng.integers(c * lc // 2, c * lc + 1, size=b)]
    return packed, dev, docs, rng, shape


def _staggered_case(seed, shape=(4, 8, 512)):
    """K = 1 search DFA; chunk i of a document meets its first hit in
    symbol block i (of 64), so the CTAs of one cluster absorb at different
    blocks; one document never absorbs, one absorbs at once."""
    b, c, lc = shape
    rng = np.random.default_rng(seed)
    packed = t_pack_dfas([t_make_search_dfa(t_compile_regex(".*(ab|ba)"))])
    dev = DeviceTables.build(packed, device="cpu")
    docs = []
    for d in range(b):
        doc = bytearray(b"q" * (c * lc))
        for i in range(c):
            blk = {0: i, 1: c - 1 - i, 3: 0}.get(d)
            if blk is not None:
                at = i * lc + blk * 64 + 10
                doc[at:at + 2] = b"ab"
        docs.append(bytes(doc))
    return packed, dev, docs, rng, shape


def _merge_on_card(args, b, l_blk, lanes, what, pad_key):
    """B1 or B2 on the card against its plain version: every placement,
    early exit on and off, ``skipped`` included."""
    table, chunks = args[0], args[1]
    pad_cls = table.shape[1] - 1
    tfn = ops.spec_match_merge_lanes if lanes else ops.spec_match_merge
    pfn = (dfa_match.spec_match_merge_lanes_torch if lanes
           else dfa_match.spec_match_merge_torch)
    for early_exit in (False, True):
        chunks_p, blk = ops._pad_merge_chunks(chunks, pad_cls, l_blk)
        want, wskip = pfn(table, chunks_p, *args[2:], pad_key=pad_key,
                          l_blk=blk, early_exit=early_exit)
        for smem, carry in ((True, True), (False, True), (True, False),
                            (False, False)):
            got, skip, _ = tfn(*args, pad_cls=pad_cls, pad_key=pad_key,
                               early_exit=early_exit, l_blk=l_blk,
                               table_in_smem=smem, carry_in_smem=carry)
            torch.cuda.synchronize()
            tag = (what, lanes, early_exit, smem, carry)
            assert torch.equal(got.reshape(b, -1), want.reshape(b, -1)), tag
            assert torch.equal(skip, wskip), tag
    return wskip


def _synthetic_merge(seed, b, c, l, k, s, q=64, n_cls=7, absorbing=32):
    """Random B1/B2 operands of K*S lanes per chunk: a table whose first
    ``absorbing`` states are fixed points, random entry lanes, boundary
    keys, candidate index (misses included) and sinks."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, q, size=(q, n_cls + 1)).astype(np.int32)
    table[:absorbing] = np.arange(absorbing)[:, None]
    table[:, n_cls] = np.arange(q)
    n_keys = n_cls
    cand = rng.integers(-1, s, size=(n_keys + 1, q)).astype(np.int32)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32)).cuda()
    return (put(table), put(rng.integers(0, n_cls, size=(b, c, l))),
            put(rng.integers(0, q, size=(b, c, k * s))),
            put(rng.integers(0, n_keys + 1, size=(b, c))), put(cand),
            put(np.array([3, -1][:k])),
            put((table == np.arange(q)[:, None]).all(axis=1)))


def test_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): the CUDA kernels against their plain
    versions, bit for bit with ``skipped``: both table and both lane-carry
    placements, early exit on and off, r = 1 and 2, a 16-column table, L
    not a multiple of 4 or of the ring tile, C not a multiple of a cluster
    CTA's chunks, the CTAs of one cluster absorbing at different blocks,
    and lanes beyond one CTA's registers (passes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    for make, l_blk in ((lambda: _random_case(1, 21, (5, 8, 200)), 16),
                        (lambda: _random_case(2, 22, (5, 8, 200)), 16),
                        (lambda: _hit_case(23, (3, 8, 160)), 16),
                        (lambda: _class16_case(24, (6, 5, 200)), 13),
                        (lambda: _random_case(1, 25, (3, 7, 96)), 24),
                        (lambda: _staggered_case(26), 64)):
        packed, dev, docs, rng, (b, c, lc) = make()
        for lanes in (False, True):
            chunks, la, init = _batch(packed, dev, docs, c, lc, rng, lanes)
            args = _operands(dev, chunks, la, init, device="cuda")
            skip = _merge_on_card(args, b, l_blk, lanes, (b, c, lc),
                                  dev.pad_key)
        if c == 8 and lc == 512:   # the staggered case exits per document
            assert skip.tolist() == [0, 0, 0, 7], skip
    for k, s in ((2, 4000), (1, 9)):
        args = _synthetic_merge(27, 2, 2, 64, k, s)
        plan = dfa_match.merge_plan(2, 2, k * s, 64, 8, 64, 16)
        assert (plan["passes"] > 1) == (s == 4000)
        for lanes in (False, True):
            skip = _merge_on_card(args, 2, 16, lanes, (k, s), 7)
            assert int(skip.min()) > 0, skip


def _compose_runs(seed, r, lens, seg_len=16):
    """Real lane-map runs of a K=3 matcher under ``lookahead_r=r``: row i
    chains ``lens[i]`` segment maps at their true boundary keys, shorter
    rows pad with zero maps under ``pad_key``."""
    rng = np.random.default_rng(seed)
    m = t_matcher([".*(ab|ba){2}", ".*[0-9]{3}", ".*x+y"], r)
    dev = m.dev
    b, n = len(lens), max(lens)
    cands = dev.tables.candidates.astype(np.int32)
    maps = np.zeros((b, n, m.packed.n_patterns, dev.i_max), np.int32)
    keys = np.full((b, n), dev.pad_key, np.int32)
    segs, where = [], []
    for i in range(b):
        data = rng.choice(np.frombuffer(b"abxy0189", np.uint8),
                          size=2 + lens[i] * seg_len)
        key = dev.advance_key(-1, data[:2])
        for j in range(lens[i]):
            seg = data[2 + j * seg_len:2 + (j + 1) * seg_len]
            keys[i, j] = key
            segs.append(seg)
            where.append((i, j))
            key = dev.advance_key(key, seg)
    flat = np.array([keys[i, j] for i, j in where], np.int32)
    res = m.advance_cursors(segs, np.ascontiguousarray(cands[flat]), flat)
    rows, cols = np.array(where).T
    maps[rows, cols] = res.lane_states
    return dev, maps, keys


def t_matcher(patterns, r):
    from repro_torch.core import Matcher
    return Matcher([t_make_search_dfa(t_compile_regex(p)) for p in patterns],
                   lookahead_r=r, num_chunks=2, batch_tile=8, device="cpu")


def test_compose_kernels_equal_plain_on_card():
    """Needs an NVIDIA card (sm_90a): B3 and B4 against their plain versions
    on every lane, r = 1 and 2, ragged runs, B4 on its own plan, split into
    1, 2, 8 and 16 segments (16: past one cluster, a second launch) and on
    its wide instance; both on a run of N = 2,048, on runs that are all
    ``pad_key`` after element 0, on random operands with Q % 4 != 0
    (unaligned ``cand_index`` rows), patterns with and without sinks,
    several runs to a CTA, operands off 16 bytes, and B4 at phase 9's
    (B, N), [1024, 32], [8, 2048], with more distinct keys than its row
    slots, and past shared memory (PS00028's shape: the wide instance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the compose kernels have no CPU "
                    "mode")
    for r in (1, 2):
        for lens in ([8, 3, 5, 1, 8], [64, 20, 33], [1, 1]):
            dev, maps, keys = _compose_runs(30 + r, r, lens)
            args = (torch.from_numpy(maps).cuda(),
                    torch.from_numpy(keys).cuda(), dev.cidx_pad_t.cuda(),
                    dev.sinks_t.cuda())
            want = lvec_compose.spec_compose_lanes_torch(
                *args, pad_key=dev.pad_key)
            got = lvec_compose.spec_compose_lanes_cuda(
                *args, pad_key=dev.pad_key)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (r, lens)
            _tree_on_card(args, dev.pad_key, (r, lens))
    # real runs: one of N = 2,048, and runs that pad after element 0
    dev, maps, keys = _compose_runs(33, 2, [2048, 700])
    keys = np.concatenate([keys, np.full_like(keys[:1], dev.pad_key)])
    keys[-1, 0] = keys[0, 0]
    maps = np.concatenate([maps, maps[:1]])
    args = (torch.from_numpy(maps).cuda(), torch.from_numpy(keys).cuda(),
            dev.cidx_pad_t.cuda(), dev.sinks_t.cuda())
    want = lvec_compose.spec_compose_lanes_torch(*args, pad_key=dev.pad_key)
    got = lvec_compose.spec_compose_lanes_cuda(*args, pad_key=dev.pad_key)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[-1], args[0][-1, 0])   # pads after element 0
    got = _tree_on_card(args, dev.pad_key, "N = 2,048", (1, 2, 8, 16))
    assert torch.equal(got[-1], args[0][-1, 0])
    # random operands: Q % 4 in {0, 1, 2, 3}, sinks on some patterns only,
    # pad keys scattered, B from one run to several runs per CTA
    rng = np.random.default_rng(34)
    for b, n, q, k, s in ((1, 5, 17, 3, 4), (300, 9, 194, 14, 15),
                          (140, 33, 10, 2, 3), (1024, 32, 195, 7, 30),
                          (4, 40, 43, 1, 1000), (2, 7, 8, 2, 2)):
        n_keys = 2 * q + 3
        cidx = rng.integers(-1, s, size=(n_keys + 1, q))
        cidx[-1] = -1
        sinks = np.where(rng.random(k) < 0.5, rng.integers(0, q, size=k), -1)
        lanes = rng.integers(0, q, size=(b, n, k, s))
        keys = rng.integers(0, n_keys + 1, size=(b, n))   # n_keys = pad
        args = tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32))
                     .cuda() for x in (lanes, keys, cidx, sinks))
        want = lvec_compose.spec_compose_lanes_torch(*args, pad_key=n_keys)
        got = lvec_compose.spec_compose_lanes_cuda(*args, pad_key=n_keys)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, n, q, k, s)
        # operands that do not start on 16 bytes (the 4-byte copy path)
        shifted = tuple(_off16(x) for x in args)
        got = lvec_compose.spec_compose_lanes_cuda(*shifted, pad_key=n_keys)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, n, q, k, s, "shifted")
    # B4 on random operands: phase 9's (B, N), [1024, 32], [8, 2048], Q % 4
    # in {0, 1, 2, 3}, sinks on some patterns only, more distinct keys than
    # the CTA's row slots (Q = 4,001), forced splits and operands off 16
    # bytes
    for b, n, q, k, s, forced in (
            (959, 16, 194, 14, 15, ()), (205, 16, 194, 14, 15, ()),
            (21, 4, 194, 14, 15, ()), (1024, 32, 194, 14, 15, ()),
            (8, 2048, 194, 14, 15, ()), (1, 8, 17, 3, 4, (2, 8)),
            (300, 8, 195, 7, 30, (2,)), (3, 64, 10, 2, 3, (1, 16)),
            (4, 64, 43, 1, 1000, (8,)), (2, 256, 4001, 2, 30, (1, 16))):
        n_keys = 2 * q + 3
        cidx = rng.integers(-1, s, size=(n_keys + 1, q))
        cidx[-1] = -1
        sinks = np.where(rng.random(k) < 0.5, rng.integers(0, q, size=k), -1)
        lanes = rng.integers(0, q, size=(b, n, k, s))
        keys = rng.integers(0, n_keys + 1, size=(b, n))   # n_keys = pad
        keys[-1, 1:] = n_keys                             # pads after 0
        args = tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32))
                     .cuda() for x in (lanes, keys, cidx, sinks))
        got = _tree_on_card(args, n_keys, (b, n, q, k, s), forced)
        assert torch.equal(got[-1], args[0][-1, 0])
        _tree_on_card(tuple(_off16(x) for x in args), n_keys,
                      (b, n, q, k, s, "shifted"))
        if q == 4001:   # a CTA holds fewer row slots than its distinct keys
            plan = lvec_compose.tree_plan(b, n, q, k, s)
            assert 0 < plan["slots"] < plan["seg"] - 1
    # past the ring (the wide instance): a cand_index row and a lane map
    # past four ring slots (PS00028's Q = 43,125 and S = 22,857; Q = 20,000),
    # more lanes than one CTA's threads carry (K*S = 5,000)
    for b, n, q, k, s in ((3, 9, 43_125, 1, 22_857), (2, 40, 17, 2, 2_500),
                          (5, 33, 20_000, 3, 100)):
        assert lvec_compose.carry_plan(b, n, q, k, s)["wide"]
        assert lvec_compose.tree_plan(b, 8, q, k, s)["wide"] == (k * s > 3968)
        n_keys = 40
        cidx = rng.integers(-1, s, size=(n_keys + 1, q))
        cidx[-1] = -1
        sinks = np.where(rng.random(k) < 0.5, rng.integers(0, q, size=k), -1)
        lanes = rng.integers(0, q, size=(b, n, k, s))
        keys = rng.integers(0, n_keys + 1, size=(b, n))
        args = tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32))
                     .cuda() for x in (lanes, keys, cidx, sinks))
        want = lvec_compose.spec_compose_lanes_torch(*args, pad_key=n_keys)
        got = lvec_compose.spec_compose_lanes_cuda(*args, pad_key=n_keys)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, n, q, k, s, "wide")
        _tree_on_card((args[0][:, :8].contiguous(),
                       args[1][:, :8].contiguous(), *args[2:]), n_keys,
                      (b, 8, q, k, s, "wide"))


def _tree_on_card(args, pad_key, what, forced=()):
    """B4 on ``args`` (lanes, keys, cand_index, sinks on the card) through
    its own plan, each forced segment count in ``forced`` and the forced
    wide instance, each against the plain tree on every lane; returns the
    plan's result."""
    lanes, keys, cidx, _ = args
    b, n, k, s = lanes.shape
    want = lvec_compose.spec_compose_lanes_tree_torch(*args, pad_key=pad_key)
    got = lvec_compose.spec_compose_lanes_tree_cuda(*args, pad_key=pad_key)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (what, "plan")
    lanes, keys = lanes.contiguous(), keys.contiguous()
    for g in forced:
        plan = lvec_compose._tree_plan(b, n, cidx.shape[1], k, s, g)
        assert plan["segments"] == g and not plan["wide"]
        other = lvec_compose._tree_launch(lanes, keys, cidx, args[3], pad_key,
                                          plan)
        torch.cuda.synchronize()
        assert torch.equal(other, want), (what, g)
    if b * n * k * s <= 1 << 24:
        other = lvec_compose._tree_launch(
            lanes, keys, cidx, args[3], pad_key,
            lvec_compose._tree_plan(b, n, cidx.shape[1], k, s, None, True))
        torch.cuda.synchronize()
        assert torch.equal(other, want), (what, "wide")
    return got


def test_matcher_compose_lane_maps_past_the_ring_on_card():
    """Needs an NVIDIA card (sm_90a): ``Matcher(PS00028).compose_lane_maps``
    (Q = 43,125, S = I_max = 22,857: a key row and a lane map past B3's
    ring, so its wide instance) equals the plain carry fold on every lane,
    through one B3 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the compose kernels have no CPU "
                    "mode")
    from repro_torch.core import Matcher
    from repro_torch.core.patterns import PROSITE_PATTERNS
    from repro_torch.core.regex import prosite_to_regex
    dfa = t_make_search_dfa(t_compile_regex(
        ".*(" + prosite_to_regex(PROSITE_PATTERNS["PS00028_ZINC_FINGER_C2H2"])
        + ")"))
    m = Matcher(dfa)
    dev = m.dev
    k, s, q = m.packed.n_patterns, dev.i_max, dfa.n_states
    assert lvec_compose.carry_plan(4, 8, q, k, s)["wide"]
    rng = np.random.default_rng(35)
    b, n = 4, 6   # compose_lane_maps pads N to 8 with pad_key elements
    lanes = rng.integers(0, q, size=(b, n, k, s)).astype(np.int32)
    keys = rng.integers(0, dev.pad_key + 1, size=(b, n)).astype(np.int32)
    lvec_compose.reset_launches()
    got = m.compose_lane_maps(lanes, keys)
    assert lvec_compose.launches["spec_compose_lanes"] == 1
    want = lvec_compose.spec_compose_lanes_torch(
        torch.from_numpy(lanes).cuda(), torch.from_numpy(keys).cuda(),
        dev.cidx_pad_t, dev.sinks_t, pad_key=dev.pad_key)
    assert np.array_equal(got, want.cpu().numpy())


def _literal_docs(seed, pats, n=12):
    """Documents of ``f``-``z`` filler, 2-6 KiB, every third with some
    pattern's literal planted."""
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(n):
        body = rng.integers(ord("f"), ord("z") + 1,
                            size=int(rng.integers(2048, 6145)),
                            dtype=np.uint8).tobytes()
        if d % 3 == 0:
            lit = pats[int(rng.integers(0, len(pats)))].encode()
            body = body[:100] + lit + body[100 + len(lit):]
        docs.append(body)
    return docs


def test_matcher_swap_moves_the_table_between_placements_on_card():
    """Needs an NVIDIA card (sm_90a): ``Matcher.swap_patterns`` from 32 to
    512 literal search patterns (packed table 272 KiB: past shared memory)
    and back; at each step B1 on the swapped tables equals its plain
    version, the table lands where its size says, and ``membership_batch``
    equals a fresh matcher on ``backend="local"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from repro_torch.core import Matcher, PatternSet
    from repro_torch.core.engine import ENTRY_STARTS, LanePlan
    pats = [f"P{i:04x}e" for i in range(512)]
    sets = {32: PatternSet(pats[:32], k_blk=1 << 30),
            512: PatternSet(pats, k_blk=1 << 30)}
    docs = _literal_docs(36, pats)
    m = Matcher(sets[32], num_chunks=8, batch_tile=16)
    for step, k in enumerate((32, 512, 32)):
        assert m.swap_patterns(sets[k]) is (step > 0)
        dev = m.dev
        q, n_cls_pad = dev.table_pad_t.shape
        plan = dfa_match.merge_plan(16, 8, k * dev.i_max, q, n_cls_pad,
                                    1024, 512)
        assert plan["table_in_smem"] is (k == 32), (k, q, n_cls_pad)
        dfa_match.reset_launches()
        res = m.membership_batch(docs)
        assert dfa_match.launches["spec_match_merge"] > 0
        want = Matcher(sets[k], num_chunks=8, batch_tile=16,
                       backend="local").membership_batch(docs)
        assert np.array_equal(res.final_states, want.final_states), k
        assert res.accepted.any()
        # B1 itself on the swapped tables, against its plain version
        width = 8 * 1024
        buf = np.zeros((len(docs), width), np.uint8)
        lens = np.array([min(len(d), width) for d in docs], np.int32)
        for i, d in enumerate(docs):
            buf[i, :lens[i]] = np.frombuffer(d[:width], np.uint8)
        body, la, init = m.executor._spec_stages(
            LanePlan("spec", width, 1024, ENTRY_STARTS, spec_r=dev.spec_r),
            torch.from_numpy(buf).cuda(), torch.from_numpy(lens).cuda(),
            None, None)
        args = (dev.table_pad_t, body, init, la, dev.cidx_pad_t, dev.sinks_t,
                dev.absorbing_t)
        got, skip, _ = ops.spec_match_merge(*args, pad_cls=dev.pad_cls,
                                            pad_key=dev.pad_key, l_blk=512)
        pwant, pskip = dfa_match.spec_match_merge_torch(
            *args, pad_key=dev.pad_key, l_blk=512)
        torch.cuda.synchronize()
        assert torch.equal(got, pwant) and torch.equal(skip, pskip), k


def _off16(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


# --------------------------------------------------------------------------
# B5 token_mask and B9 flash_attn
# --------------------------------------------------------------------------

def _bits(x) -> np.ndarray:
    """The raw bits of a float32/bfloat16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32 if x.dtype == torch.float32
                      else torch.int16).cpu().numpy()
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int16)


def _mask_case(b, q, v, dtype, seed):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, q, size=(b,), dtype=np.int32)
    allowed = rng.integers(0, 2, size=(q, v), dtype=np.uint8)
    logits = rng.normal(size=(b, v)).astype(np.float32)
    return states, allowed, logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,q,v", [(1, 3, 2048), (5, 17, 4096), (8, 64, 2048),
                                   (3, 5, 3000)])
def test_token_mask_cpu_equals_pallas_interpret(jops, b, q, v, dtype):
    """Bit for bit, including the ragged vocab (V = 3000) and the masked
    value's rounding to the logits' dtype."""
    import jax.numpy as jnp

    states, allowed, logits = _mask_case(b, q, v, dtype, b * v)
    jl = jnp.asarray(logits).astype(jnp.dtype(dtype))
    want = jops.token_mask(jnp.asarray(states), jnp.asarray(allowed), jl)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = ops.token_mask(torch.from_numpy(states), torch.from_numpy(allowed),
                         tl)
    assert got.dtype == tl.dtype and got.shape == (b, v)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref_out = tref.token_mask_ref(torch.from_numpy(states),
                                  torch.from_numpy(allowed).bool(), tl)
    np.testing.assert_array_equal(_bits(got), _bits(ref_out))
    neg = _bits(jnp.asarray(-1e30, jnp.dtype(dtype)))
    assert (_bits(got)[allowed[states] == 0] == neg).all()


FLASH_CASES = [(2, 128, 128, 32, True, 0), (4, 256, 256, 64, True, 0),
               (2, 128, 128, 32, True, 48), (3, 64, 192, 16, False, 0),
               (1, 384, 384, 128, True, 128)]


def _qkv(bh, t, s, d, seed, bkv=None):
    rng = np.random.default_rng(seed)
    bkv = bh if bkv is None else bkv
    return (rng.normal(size=(bh, t, d)).astype(np.float32),
            rng.normal(size=(bkv, s, d)).astype(np.float32),
            rng.normal(size=(bkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("bh,t,s,d,causal,window", FLASH_CASES)
def test_flash_attn_cpu_equals_pallas_interpret(jops, bh, t, s, d, causal,
                                                window):
    """The plain version of B9 against the JAX op (interpret mode) and the
    port's oracle, atol = rtol = 3e-2 (bf16 tiles, sums in another order)."""
    import jax.numpy as jnp

    q, k, v = _qkv(bh, t, s, d, t + s + d)
    want = np.asarray(jops.flash_attn(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=causal, window=window, q_blk=64, kv_blk=64), np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = ops.flash_attn(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, t, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)
    oracle = tref.flash_attn_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), oracle.float().numpy(),
                               atol=3e-2, rtol=3e-2)


def test_flash_attn_grouped_kv_equals_repeated(jops):
    """Unrepeated kv heads with ``group`` equal the JAX op on repeated kv
    heads (the layer's GQA call), with odd T and S tails."""
    import jax.numpy as jnp

    q, k, v = _qkv(8, 100, 100, 32, 5, bkv=2)
    want = np.asarray(jops.flash_attn(
        jnp.asarray(q).astype(jnp.bfloat16),
        *(jnp.repeat(jnp.asarray(x).astype(jnp.bfloat16), 4, axis=0)
          for x in (k, v)), causal=True), np.float32)
    got = ops.flash_attn(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                         causal=True, group=4)
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)
    with pytest.raises(ValueError):
        ops.flash_attn(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                       group=3)


def test_serving_wrappers_refuse_cpu_tensors():
    states, allowed, logits = _mask_case(2, 3, 64, "float32", 1)
    before = (dict(token_mask.launches), dict(flash_attn.launches))
    with pytest.raises(ValueError, match="CUDA"):
        token_mask.token_mask_cuda(torch.from_numpy(states),
                                   torch.from_numpy(allowed),
                                   torch.from_numpy(logits))
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(2, 32, 32, 16, 2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attn_cuda(q, k, v)
    assert (token_mask.launches, flash_attn.launches) == before


def _bits_t(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


def test_token_mask_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): B5 bit for bit against its plain
    version, f32 and bf16, vector-aligned and ragged vocabularies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    for b, q, v in ((1, 3, 2048), (8, 64, 32000), (3, 5, 3001), (4, 7, 13)):
        states, allowed, logits = _mask_case(b, q, v, "float32", v)
        for dtype in (torch.float32, torch.bfloat16):
            args = (torch.from_numpy(states).cuda(),
                    torch.from_numpy(allowed).cuda(),
                    torch.from_numpy(logits).to("cuda", dtype))
            want = token_mask.token_mask_torch(*args)
            got = token_mask.token_mask_cuda(*args)
            torch.cuda.synchronize()
            assert torch.equal(_bits_t(got), _bits_t(want)), (b, q, v, dtype)


def test_token_mask_on_a_swapped_grammar_on_card():
    """Needs an NVIDIA card (sm_90a): after ``GrammarConstraint
    .swap_grammar`` B5 reads the new grammar's mask table and equals its
    plain version bit for bit, through ``mask_logits`` too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from repro_torch.serving import GrammarConstraint
    gc = GrammarConstraint(t_compile_regex(r"([0-9]{1,6}[.,] )*[0-9]{0,6}"),
                           32_000, eos_id=None)
    assert gc.swap_grammar(t_compile_regex(r"[a-z]{1,8}(, [a-z]{1,8})*"))
    rng = np.random.default_rng(37)
    states = torch.from_numpy(rng.integers(0, gc.dfa.n_states, size=8,
                                           dtype=np.int32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.from_numpy(rng.normal(size=(8, 32_000)).astype(
            np.float32)).to("cuda", dtype)
        want = token_mask.token_mask_torch(states, gc.allowed, logits)
        token_mask.reset_launches()
        got = gc.mask_logits(states, logits)
        torch.cuda.synchronize()
        assert token_mask.launches["token_mask"] == 1
        assert torch.equal(_bits_t(got), _bits_t(want)), dtype
        ok = gc.allowed[states.long()].bool()
        assert torch.equal(_bits_t(got)[ok], _bits_t(logits)[ok])


def test_flash_attn_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): B9 against its plain version within
    atol = rtol = 3e-2, max |err| <= 1e-2 and RMS error <= 1e-3 of the
    plain output's RMS: every head dim, causal, windowed, cross-shaped and
    grouped kv heads, T and S off the kernel's 128-row tiles, S != T,
    windows that start inside a tile, group 8 with a ragged S tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    cases = FLASH_CASES + [(8, 100, 100, 64, True, 0, 4),
                           (4, 77, 130, 32, False, 0, 2),
                           (2, 300, 300, 128, True, 0, 1),
                           (4, 1000, 1000, 64, True, 300, 1),
                           (2, 520, 520, 16, True, 200, 1),
                           (16, 333, 333, 128, True, 0, 8),
                           (8, 200, 333, 16, False, 0, 8),
                           (4, 130, 70, 64, True, 0, 1),
                           (2, 129, 257, 32, False, 100, 1)]
    for case in cases:
        bh, t, s, d, causal, window = case[:6]
        group = case[6] if len(case) > 6 else 1
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in _qkv(bh, t, s, d, t + s, bkv=bh // group))
        kw = dict(causal=causal, window=window, group=group)
        want = flash_attn.flash_attn_torch(q, k, v, **kw).float()
        got = flash_attn.flash_attn_cuda(q, k, v, **kw).float()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2,
                                   msg=str(case))
        err = (got - want).abs()
        rel_rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
        assert float(err.max()) <= 1e-2 and rel_rms <= 1e-3, (case, rel_rms)


@pytest.mark.parametrize("d", flash_attn.HEAD_DIMS)
def test_flash_plan_sizes_shared_memory(d):
    """The kernel's shared memory (Q block, the K/V ring, barriers and the
    alignment slack) fits one block at every head dim; rows swizzle by
    their bytes."""
    plan = flash_attn.flash_plan(256, 256, d)
    assert plan["smem"] <= 232_448
    assert plan["swizzle"] == min(2 * d, 128)
    assert plan["parts"] * plan["swizzle"] == 2 * d
    assert plan["stages"] >= 2 and plan["q_blocks"] == 2


@pytest.mark.parametrize("t,s,causal,window", [
    (2048, 2048, True, 0), (300, 300, True, 0), (1000, 1000, True, 300),
    (520, 520, True, 200), (129, 257, False, 100), (77, 130, False, 0),
    (130, 70, True, 0), (4096, 4096, True, 512)])
def test_flash_plan_walks_every_live_tile(t, s, causal, window):
    """Each q block's kv tiles cover every (q, k) pair the mask keeps, and
    a tile it leaves out holds no such pair."""
    plan = flash_attn.flash_plan(t, s, 64, causal=causal, window=window)
    blk = flash_attn.BLK_CUDA
    for b, (j_lo, j_hi) in enumerate(plan["tiles"]):
        q = np.arange(b * blk, min(b * blk + blk, t))[:, None]
        k = np.arange(s)[None, :]
        keep = np.ones((len(q), s), bool)
        if causal:
            keep &= k <= q
        if window > 0:
            keep &= k > q - window
        live = np.flatnonzero(keep.any(axis=0)) // blk
        assert 0 <= j_lo <= j_hi <= -(-s // blk)
        if live.size:
            assert j_lo <= live.min() and live.max() < j_hi
            assert keep[:, j_lo * blk:(j_lo + 1) * blk].any()
            assert keep[:, (j_hi - 1) * blk:j_hi * blk].any()


def test_flash_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head dim"):
        flash_attn.flash_plan(64, 64, 48)


# --------------------------------------------------------------------------
# B6 spec_match, B7 lvec_compose, B8 onehot_block_maps
# --------------------------------------------------------------------------

def _spec_case(q, ncls, c, l, s, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, q, size=(q, ncls)).astype(np.int32)
    chunks = rng.integers(0, ncls, size=(c, l)).astype(np.int32)
    init = rng.integers(0, q, size=(c, s)).astype(np.int32)
    return table, chunks, init


SPEC_GATHER = [(4, 2, 1, 16, 1), (17, 5, 6, 384, 9), (64, 16, 8, 512, 16),
               (130, 7, 3, 130, 130), (257, 26, 2, 1024, 33),
               (11, 3, 13, 601, 5)]
SPEC_MXU = [(8, 3, 2, 64, 8), (32, 4, 4, 256, 32), (128, 8, 2, 512, 64),
            (20, 6, 3, 389, 20)]


@pytest.mark.parametrize("q,ncls,c,l,s,use_mxu",
                         [g + (False,) for g in SPEC_GATHER]
                         + [m + (True,) for m in SPEC_MXU])
def test_spec_match_cpu_equals_pallas_interpret(jops, q, ncls, c, l, s,
                                                use_mxu):
    """Both routes of ``ops.spec_match`` (the gather route runs unpadded,
    the product route pads L) against the JAX op (which pads both) and the
    oracles, prime L and C included."""
    import jax.numpy as jnp

    table, chunks, init = _spec_case(q, ncls, c, l, s, q * 1000 + l)
    want = np.asarray(jops.spec_match(*map(jnp.asarray, (table, chunks, init)),
                                      use_mxu=use_mxu))
    args = tuple(map(torch.from_numpy, (table, chunks, init)))
    got = ops.spec_match(*args, use_mxu=use_mxu)
    assert got.dtype == torch.int32 and got.shape == (c, s)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.spec_match_ref(*args).numpy(), want)
    np.testing.assert_array_equal(dfa_match.spec_match_torch(*args).numpy(),
                                  want)
    assert ops.mxu_profitable(q, s) == jops.mxu_profitable(q, s)


def test_mxu_profitable_decides_as_jax(jops):
    grid = [(q, s) for q in (1, 2, 8, 9, 16, 17, 64, 128, 200, 255, 256, 257,
                             300, 1288, 43125)
            for s in (1, 4, 8, 9, 16, 32, 64, 100, 128, 129, 256, 257, 22857)]
    assert [ops.mxu_profitable(q, s) for q, s in grid] == [
        jops.mxu_profitable(q, s) for q, s in grid]
    assert ops.mxu_profitable(256, 256) and not ops.mxu_profitable(257, 257)


@pytest.mark.parametrize("c,q", [(1, 4), (8, 17), (16, 128), (7, 33),
                                 (24, 257)])
def test_lvec_compose_cpu_equals_pallas_interpret(jops, c, q):
    import jax.numpy as jnp

    maps = np.random.default_rng(c * q).integers(
        0, q, size=(c, q)).astype(np.int32)
    want = np.asarray(jops.lvec_compose(jnp.asarray(maps)))
    got = ops.lvec_compose(torch.from_numpy(maps))
    assert got.dtype == torch.int32 and got.shape == (q,)
    np.testing.assert_array_equal(got.numpy(), want)
    both = ops.lvec_compose(torch.from_numpy(np.stack([maps, maps])))
    assert both.shape == (2, q)
    np.testing.assert_array_equal(both.numpy(), np.stack([want, want]))


def _worst_case_table(q=96):
    """Many-to-one transitions (non-permutation P): every state -> 0 on
    class 0, identity on class 1, a cycle on class 2."""
    table = np.zeros((q, 3), dtype=np.int32)
    table[:, 1] = np.arange(q)
    table[:, 2] = (np.arange(q) + 1) % q
    return table


@pytest.mark.parametrize("q,ncls,l,blk", [
    (4, 2, 64, 16), (16, 4, 256, 64), (64, 8, 512, 128), (128, 16, 256, 256),
    (23, 5, 97, 32), ("worst", 3, 128, 64)])
def test_onehot_block_maps_cpu_equals_pallas_interpret(jops, q, ncls, l, blk):
    """Including a prime L (identity-class padding) and the worst-case
    one-hot matrices."""
    import jax.numpy as jnp

    rng = np.random.default_rng(l + blk)
    if q == "worst":
        table = _worst_case_table()
        syms = np.tile([0, 1, 2, 2], l // 4).astype(np.int32)
    else:
        table = rng.integers(0, q, size=(q, ncls)).astype(np.int32)
        syms = rng.integers(0, ncls, size=l).astype(np.int32)
    want = np.asarray(jops.onehot_block_maps(
        jnp.asarray(table), jnp.asarray(syms), block_l=blk))
    got = ops.onehot_block_maps(torch.from_numpy(table),
                                torch.from_numpy(syms), block_l=blk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    batched = ops.onehot_block_maps(torch.from_numpy(table),
                                    torch.from_numpy(np.stack([syms, syms])),
                                    block_l=blk)
    np.testing.assert_array_equal(batched.numpy(), np.stack([want, want]))


def test_build_pmats_equals_jax():
    from repro.kernels.onehot_match import build_pmats as j_build_pmats
    import jax.numpy as jnp

    table = _worst_case_table(12)
    want = np.asarray(j_build_pmats(jnp.asarray(table)).astype(jnp.float32))
    got = onehot_match.build_pmats(torch.from_numpy(table))
    assert got.dtype == torch.bfloat16 and got.shape == (36, 12)
    np.testing.assert_array_equal(got.float().numpy(), want)


SPEC_SHAPES = [(4096, 44, 16_384), (4096, 120, 16_384), (40, 256, 26_214),
               (1, 1, 4 << 20), (40, 22_857, 4096), (7, 5000, 100),
               (4096, 1, 64), (3, 33, 10_007), (100_000, 44, 64),
               (300, 9000, 64), (37, 9, 10_007), (4096, 3, 4096)]


def _spec_cover(plan, c, s):
    """(chunk, lane) -> how many consumer lanes of the B6 launch hold it,
    walking the kernel's mapping: CTA (x, y) holds chunks [x * c_blk, ...)
    and lanes [y * s_blk, ...); consumer thread t its row t // tpc and
    lanes g + u * tpc of it."""
    seen = np.zeros((c, s), np.int64)
    tpc = plan["tpc"]
    gx, gy = plan["grid"]
    t = np.arange(plan["cons"])
    for x in range(gx):
        c0 = x * plan["c_blk"]
        rows = min(plan["c_blk"], c - c0)
        for y in range(gy):
            s0 = y * plan["s_blk"]
            width = min(plan["s_blk"], s - s0)
            live = t < rows * tpc
            row, g = t // tpc, t % tpc
            for u in range(dfa_match.LPT):
                j = g + u * tpc
                ok = live & (j < width)
                np.add.at(seen, (c0 + row[ok], s0 + j[ok]), 1)
    return seen


def test_plan_constants_equal_the_kernel_header():
    """The plans' lanes per thread, ring stages, step group and consumer
    threads are the ones csrc/spec_scan.cuh compiles in."""
    import re
    from pathlib import Path

    header = (Path(dfa_match.__file__).parent / "csrc"
              / "spec_scan.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", header))
    assert {k: int(consts[k]) for k in ("LPT", "STAGES", "GROUP",
                                        "MAX_CONSUMERS")} == {
        "LPT": dfa_match.LPT, "STAGES": dfa_match.STAGES,
        "GROUP": dfa_match.GROUP, "MAX_CONSUMERS": dfa_match.MAX_CONSUMERS}
    assert dfa_match.LPT > 1   # a thread carries several chains


def test_compose_plan_constants_equal_the_kernel_source():
    """The B3/B7 plans' ring stages, consumer threads, cluster size, states
    and lanes per thread and tile pairs are the ones csrc/lvec_compose.cu
    compiles in."""
    import re
    from pathlib import Path

    src = (Path(lvec_compose.__file__).parent / "csrc"
           / "lvec_compose.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    names = ("STAGES", "MAX_CONSUMERS", "MAX_CLUSTER", "QPT", "LPT", "PAIRS")
    assert {k: int(consts[k]) for k in names} == {
        k: getattr(lvec_compose, k) for k in names}
    assert lvec_compose.PAIRS == 32   # one pair per producer lane


LVEC_SHAPES = [(1, 4096, 256), (40, 103, 256), (40, 103, 16), (40, 103, 64),
               (40, 103, 128), (4096, 64, 17), (4096, 64, 120), (1, 1, 4),
               (3, 100, 17), (2, 7, 1500), (5, 0, 9), (1, 300, 1),
               (7, 50, 103), (1, 10 ** 6, 64), (200, 5, 33), (1, 40, 14_000),
               (2, 64, 20_000), (1, 300, 60_000), (1, 8, 16_000),
               (300, 4, 30_000)]


def _lvec_cover(b, n, q, plan):
    """Maps of each composition the plan's CTAs take (stage 1), and the
    partials of each composition its fold takes (stage 2); a wide plan's
    CTAs along the states (grid y) take the same maps."""
    g, cl, pack = plan["segments"], plan["cluster"], plan["pack"]
    seen = np.zeros((b, n), np.int64)
    folded = np.zeros((b, plan["folds"]), np.int64)
    xs = plan["ctas"] // (lvec_compose._wide_blocks(q) if plan["wide"] else 1)
    for cta in range(xs):
        seg, b0 = cta % g, cta // g * pack
        lo, hi = seg * n // g, (seg + 1) * n // g
        for u in range(min(pack, b - b0)):
            seen[b0 + u, lo:hi] += 1
            if seg % cl == 0:   # one fold row per cluster
                folded[b0 + u, seg // cl] += 1
    return seen, folded


@pytest.mark.parametrize("b,n,q", LVEC_SHAPES)
def test_lvec_plan_covers_every_map_once(b, n, q):
    """The B7 launch takes every map of every composition exactly once, in
    segments of consecutive maps; a cluster is <= 8 CTAs and divides the
    segments; a second launch folds the cluster partials of compositions
    split past one cluster; each CTA's consumers hold every state of its
    compositions within 992 threads and QPT states a thread; shared memory
    within one block's budget; a batch of few long compositions fills the
    132 SMs with segments of >= MIN_SEGMENT maps.  Maps past the ring take
    the wide instance, whose CTAs cover every state."""
    plan = lvec_compose.lvec_plan(b, n, q)
    g, cl = plan["segments"], plan["cluster"]
    ring = lvec_compose.lvec_smem(1, 1, q, 1) <= lvec_compose.SMEM_BUDGET \
        and q <= lvec_compose.MAX_CONSUMERS * lvec_compose.QPT
    assert plan["wide"] == (not ring)
    assert 1 <= cl <= lvec_compose.MAX_CLUSTER and g % cl == 0
    assert plan["folds"] == g // cl and (g <= cl or cl == 8 or plan["wide"])
    if plan["wide"]:
        blocks = lvec_compose._wide_blocks(q)
        assert blocks * lvec_compose.WIDE_THREADS * lvec_compose.WPT >= q
        assert (blocks - 1) * lvec_compose.WIDE_THREADS * lvec_compose.WPT < q
        assert plan["ctas"] == b * g * blocks and cl == 1
        assert plan["smem"] == 0
    else:
        assert plan["cons"] % 32 == 0
        assert plan["cons"] <= lvec_compose.MAX_CONSUMERS
        assert plan["pack"] * plan["tpu"] <= plan["cons"]
        assert plan["tpu"] * plan["nq"] >= q
        assert plan["nq"] <= lvec_compose.QPT
        assert plan["pack"] == 1 or q < 64
        assert plan["smem"] <= lvec_compose.SMEM_BUDGET
        assert lvec_compose.lvec_smem(plan["pack"], plan["fold_tile"], q, 1) \
            <= lvec_compose.SMEM_BUDGET
    seen, folded = _lvec_cover(b, n, q, plan)
    assert (seen == 1).all() and (folded == 1).all()
    if g > 1:
        assert n // g >= lvec_compose.MIN_SEGMENT
    if b * n >= lvec_compose.SMS * lvec_compose.MIN_SEGMENT * plan["pack"]:
        assert plan["ctas"] >= 0.9 * lvec_compose.SMS or b >= 16 * 132


@pytest.mark.parametrize("g", [1, 2, 5, 8, 16, 24, 128, 1024])
def test_lvec_plan_forced_segments(g):
    """A forced G covers every map once, also where N < G (empty segments
    are identities); G past one cluster must be a multiple of 8 on the ring
    instance, any G on the wide one."""
    for b, n, q in ((3, 37, 16), (1, 4096, 256), (2, 5, 64), (2, 1, 1500),
                    (2, 5, 20_000)):
        plan = lvec_compose._lvec_plan(b, n, q, g)
        assert plan["segments"] == g
        seen, folded = _lvec_cover(b, n, q, plan)
        assert (seen == 1).all() and (folded == 1).all()
    with pytest.raises(ValueError, match="segments"):
        lvec_compose._lvec_plan(1, 100, 64, 12)
    assert lvec_compose._lvec_plan(1, 100, 20_000, 12)["folds"] == 12


def test_lvec_plan_takes_the_wide_instance_past_the_ring():
    """The ring takes every map whose four slots fit shared memory; one
    state more, or more states than QPT a thread, takes the wide instance
    (no shared memory), and no Q is refused."""
    q = max(x for x in range(64, 16_000)
            if lvec_compose.lvec_smem(1, 1, x, 1) <= lvec_compose.SMEM_BUDGET)
    assert 14_000 < q < lvec_compose.MAX_CONSUMERS * lvec_compose.QPT
    assert not lvec_compose.lvec_plan(1, 8, q)["wide"]
    assert lvec_compose.lvec_plan(1, 8, q + 1)["wide"]
    for big in (16_000 + 992 * 16, 43_125, 1 << 20):
        plan = lvec_compose.lvec_plan(3, 8, big)
        assert plan["wide"] and plan["smem"] == 0


CARRY_SHAPES = [(1024, 32, 194, 14, 15), (8, 2048, 194, 14, 15),
                (1024, 32, 195, 7, 30), (5, 8, 41, 3, 8), (2, 1, 4, 1, 1),
                (140, 33, 10, 2, 3), (4, 40, 43, 1, 1000), (1, 3, 17, 3, 4),
                (3000, 16, 80, 8, 2), (64, 8, 43_125, 1, 8),
                (4, 8, 43_125, 1, 22_857), (2, 40, 17, 2, 2_500),
                (959, 16, 194, 14, 15), (205, 16, 194, 14, 15),
                (21, 4, 194, 14, 15)]


@pytest.mark.parametrize("b,n,q,k,s", CARRY_SHAPES)
def test_carry_plan_covers_every_element_once(b, n, q, k, s):
    """The B3 launch holds every lane of every run exactly once (``runs``
    runs a CTA, ``lpt`` lanes of one run a thread); its tiles cover every
    element once with at most one (run, element) pair per producer lane;
    the ring fits one block's shared memory (two CTAs an SM where it can);
    several runs share a CTA only when the batch still fills the 132
    SMs.  An element past the ring, or more lanes than one CTA carries,
    takes the wide instance, whose CTAs hold every lane once."""
    ks = k * s
    plan = lvec_compose.carry_plan(b, n, q, k, s)
    ring = (lvec_compose.carry_smem(1, 1, q, ks) <= lvec_compose.SMEM_BUDGET
            and ks <= lvec_compose.MAX_CONSUMERS * lvec_compose.LPT)
    assert plan["wide"] == (not ring)
    if plan["wide"]:
        width = lvec_compose.WIDE_THREADS * lvec_compose.WPT
        blocks = lvec_compose._wide_blocks(ks)
        assert plan["ctas"] == b * blocks and plan["smem"] == 0
        lanes = np.zeros(ks, np.int64)
        t = np.arange(lvec_compose.WIDE_THREADS)
        for y in range(blocks):
            for u in range(lvec_compose.WPT):
                o = y * width + t + u * lvec_compose.WIDE_THREADS
                np.add.at(lanes, o[o < ks], 1)
        assert (lanes == 1).all()
        return
    runs, tile, cons, tpr, lpt = (plan[x] for x in ("runs", "tile", "cons",
                                                    "tpr", "lpt"))
    assert runs * tile <= lvec_compose.PAIRS and tile >= 1
    assert cons % 32 == 0 and runs * tpr <= cons <= lvec_compose.MAX_CONSUMERS
    assert lpt in (1, lvec_compose.LPT) and tpr * lpt >= ks
    assert lpt == lvec_compose.LPT or runs == 1
    assert plan["smem"] <= lvec_compose.SMEM_BUDGET
    assert plan["smem"] == lvec_compose.carry_smem(runs, tile, q, ks)
    lanes = np.zeros((b, ks), np.int64)
    t = np.arange(cons)
    r, g = t // tpr, t % tpr
    for cta in range(plan["ctas"]):
        for u in range(lpt):
            o = g + u * tpr
            live = (r < min(runs, b - cta * runs)) & (o < ks)
            np.add.at(lanes, (cta * runs + r[live], o[live]), 1)
    assert (lanes == 1).all()
    elems = np.zeros(n, np.int64)
    for i in range(-(-n // tile)):
        elems[i * tile:(i + 1) * tile] += 1
    assert (elems == 1).all()
    if runs > 1:
        assert plan["ctas"] >= lvec_compose.SMS
    if tile >= 4:
        assert tile % 4 == 0   # whole 16-byte spans of K*S % 4 != 0 maps
    ring = lvec_compose.STAGES * lvec_compose.carry_stage_bytes(runs, tile,
                                                                q, ks)
    if ring > lvec_compose.CARRY_RING_BYTES and plan["ctas"] > 132:
        assert tile == 1   # two CTAs an SM where it can be


TREE_SHAPES = [(959, 16, 194, 14, 15), (205, 16, 194, 14, 15),
               (21, 4, 194, 14, 15), (1024, 32, 194, 14, 15),
               (8, 2048, 194, 14, 15), (3, 8, 43_125, 1, 22_857),
               (1, 2048, 194, 14, 15), (2, 1, 4, 1, 1), (300, 8, 195, 7, 30),
               (4, 64, 43, 1, 1000), (2, 256, 4001, 2, 30),
               (2, 8, 17, 2, 2_500), (1, 1 << 16, 194, 14, 15),
               (5000, 2, 8, 1, 4)]


def _tree_cover(b, n, q, k, s, plan):
    """Checks of one ring plan of B4: its CTAs hold every element of every
    run exactly once, in aligned power-of-two segments; a unit's threads
    hold each lane once and each level's pairs once; the limits of the
    card and of the source hold."""
    ks = k * s
    g, seg, cl, runs, hp = (plan[x] for x in ("segments", "seg", "cluster",
                                              "runs", "hp"))
    assert seg == n // g and seg & (seg - 1) == 0 and g & (g - 1) == 0
    assert cl == min(g, lvec_compose.MAX_CLUSTER) and g % cl == 0
    assert plan["folds"] == g // cl and (g == 1 or runs == 1)
    assert 1 <= runs <= 15   # named barrier ids 1..runs
    assert runs == 1 or (g == 1 and seg <= lvec_compose.MIN_TREE_SEGMENT
                         and b >= runs * lvec_compose.SMS)
    threads = plan["threads"]
    assert threads == lvec_compose.tree_threads(ks, hp) and threads % 32 == 0
    assert runs * threads <= lvec_compose.MAX_CONSUMERS
    assert runs * threads <= lvec_compose.TREE_THREADS or hp == 1
    width = max(seg, cl)
    assert plan["hsize"] & (plan["hsize"] - 1) == 0
    assert plan["hsize"] > runs * width
    assert 0 <= plan["slots"] <= runs * max(seg - 1, 0)
    assert plan["smem"] == lvec_compose.tree_smem(runs, seg, cl, q, ks,
                                                  plan["slots"],
                                                  plan["hsize"])
    assert plan["smem"] <= lvec_compose.SMEM_BUDGET
    seen = np.zeros((b, n), np.int64)
    for cta in range(plan["ctas"]):
        if g > 1:
            r, lo = cta // g, cta % g * seg
            assert lo % seg == 0
            seen[r, lo:lo + seg] += 1
        else:
            seen[cta * runs:(cta + 1) * runs] += 1
    assert (seen == 1).all()
    tl = -(-ks // lvec_compose.LPT)
    t = np.arange(threads)
    h, lane = t // tl, t % tl
    held = np.zeros(ks, np.int64)
    for u in range(lvec_compose.LPT):
        o = lane + u * tl
        ok = (h < hp) & (o < ks)
        np.add.at(held, o[ok & (h == 0)], 1)
    assert (held == 1).all()
    st = 1
    while st < width:   # every pair of every level, one pair group each
        pairs = width // (2 * st)
        groups = np.zeros(pairs, np.int64)
        for hh in range(hp):
            groups[hh::hp] += 1
        assert (groups == 1).all()
        st *= 2
    if plan["folds"] > 1:
        fold = plan["fold"]
        assert not fold["wide"] and fold["segments"] == 1
        _tree_cover(b, plan["folds"], q, k, s, fold)


@pytest.mark.parametrize("b,n,q,k,s", TREE_SHAPES)
def test_tree_plan_covers_every_element_once(b, n, q, k, s):
    """The B4 launch (``tree_plan``) holds every element of every run once,
    in aligned power-of-two segments on clusters of <= 8 CTAs (a second
    launch past one), within one block's shared memory, 992 consumer
    threads and named barrier ids 1..15; phase 9's calls take one launch
    each (no split: B4's launch count on the tree run is unchanged); a
    batch of few long runs fills the 132 SMs; a unit past shared memory
    or the threads of a CTA (PS00028's K*S = 22,857) takes the wide
    instance."""
    plan = lvec_compose.tree_plan(b, n, q, k, s)
    assert plan["wide"] == (k * s > lvec_compose.LPT
                            * lvec_compose.MAX_CONSUMERS)
    if plan["wide"]:
        assert plan["ctas"] == b and plan["smem"] == 0
        assert plan["threads"] <= 1024 and plan["fold"] is None
        return
    _tree_cover(b, n, q, k, s, plan)
    if (b, n) in ((959, 16), (205, 16), (21, 4)):
        assert plan["segments"] == 1
    if b * n >= lvec_compose.SMS * lvec_compose.MIN_TREE_SEGMENT:
        assert plan["ctas"] >= lvec_compose.SMS or b >= lvec_compose.SMS
    if plan["segments"] > 1 and n * 4 * k * s <= lvec_compose.SMEM_BUDGET // 2:
        assert plan["seg"] >= lvec_compose.MIN_TREE_SEGMENT


@pytest.mark.parametrize("g", [1, 2, 8, 16, 64])
def test_tree_plan_forced_segments(g):
    """A forced G covers every element once, clusters of min(G, 8), a
    second launch past 8; G must be a power of two dividing N, and the
    wide instance can be forced."""
    for b, n, q, k, s in ((3, 64, 10, 2, 3), (4, 128, 194, 14, 15),
                          (2, 256, 4001, 2, 30), (1, 64, 17, 3, 4)):
        plan = lvec_compose._tree_plan(b, n, q, k, s, g)
        assert plan["segments"] == g and not plan["wide"]
        _tree_cover(b, n, q, k, s, plan)
    with pytest.raises(ValueError, match="segments"):
        lvec_compose._tree_plan(1, 64, 17, 3, 4, 3)
    with pytest.raises(ValueError, match="segments"):
        lvec_compose._tree_plan(1, 4, 17, 3, 4, 8)
    assert lvec_compose._tree_plan(2, 64, 17, 3, 4, None, True)["wide"]


@pytest.mark.parametrize("c,s,l", SPEC_SHAPES)
def test_spec_plan_covers_every_lane(c, s, l):
    """The B6 launch holds every (chunk, lane) exactly once, within one
    CTA's consumer threads and shared memory; a CTA holds whole chunks
    unless it splits one chunk's lanes; large C x S fill whole waves of
    132 SMs."""
    plan = dfa_match.spec_launch_plan(c, s, l, 230, 16)
    assert plan["table_in_smem"]
    assert 1 <= plan["c_blk"] <= c and 1 <= plan["s_blk"] <= s
    assert plan["s_blk"] == s or plan["c_blk"] == 1
    assert plan["cons"] % 32 == 0
    assert plan["c_blk"] * plan["tpc"] <= plan["cons"] \
        <= dfa_match.MAX_CONSUMERS
    assert plan["smem"] <= dfa_match.SMEM_BUDGET
    assert plan["tile"] % dfa_match.GROUP == 0
    if c * s <= 4_000_000:
        assert (_spec_cover(plan, c, s) == 1).all()
    ctas = plan["grid"][0] * plan["grid"][1]
    if c * s >= dfa_match.SMS * 1024:
        waves = -(-ctas // dfa_match.SMS)
        assert ctas >= 0.9 * waves * dfa_match.SMS, (ctas, waves)
    if s >= 8:   # a live thread carries several chains on average
        assert plan["s_blk"] / plan["tpc"] >= 2


MERGE_SHAPES = [(64, 8, 210, 194, 38, 8192, 512), (1024, 8, 210, 194, 38,
                                                     8192, 512),
                (64, 8, 22_857, 43_125, 6, 8192, 512), (5, 5, 40, 41, 16,
                                                        208, 13),
                (3, 7, 26, 13, 5, 96, 24), (2, 2, 8000, 64, 8, 64, 16),
                (1, 1, 9, 40, 16, 48, 16), (64, 8, 100_000, 100, 10, 512,
                                            512)]


@pytest.mark.parametrize("b,c,ks,q,ncls,l,l_blk", MERGE_SHAPES)
def test_merge_plan_covers_every_lane_once(b, c, ks, q, ncls, l, l_blk):
    """The B1/B2 cluster launch: at most 8 CTAs a document, no more than
    C, their chunk ranges cover C; every lane of a document is held once
    over the passes; shared memory (ring, table, carry) within one block's
    budget; whole tiles per symbol block."""
    plan = dfa_match.merge_plan(b, c, ks, q, ncls, l, l_blk)
    cs = plan["cluster"]
    assert 1 <= cs <= dfa_match.MAX_CLUSTER and cs <= c and cs & (cs - 1) == 0
    assert plan["cons"] % 32 == 0 and plan["cons"] <= dfa_match.MAX_CONSUMERS
    assert plan["smem"] <= dfa_match.SMEM_BUDGET
    assert l_blk % plan["tile"] == 0
    lo = [r * c // cs for r in range(cs + 1)]
    assert lo[0] == 0 and lo[-1] == c
    assert all(1 <= lo[r + 1] - lo[r] <= plan["rows"] for r in range(cs))
    seen = np.zeros((c, ks), np.int64)
    tpc, cons = plan["tpc"], plan["cons"]
    for r in range(cs):
        rows = lo[r + 1] - lo[r]
        for p in range(plan["passes"]):
            x = p * cons + np.arange(cons)
            live = x < rows * tpc
            row, g = x // tpc, x % tpc
            for u in range(dfa_match.LPT):
                j = g + u * tpc
                ok = live & (j < ks)
                np.add.at(seen, (lo[r] + row[ok], j[ok]), 1)
    assert (seen == 1).all()
    if ks <= dfa_match.MAX_CONSUMERS * dfa_match.LPT:
        assert plan["rows"] * tpc <= cons * plan["passes"]
    if b * 2 <= dfa_match.SMS and c >= 2:
        assert cs >= 2   # a small batch spreads its documents over SMs


def test_merge_plan_forced_placements():
    """Forced shared placements raise where they cannot fit, for any
    cluster; a forced global placement always plans."""
    with pytest.raises(ValueError):
        dfa_match.merge_plan(64, 8, 10, 72531, 23, 512, 512,
                             table_in_smem=True)
    with pytest.raises(ValueError):
        dfa_match.merge_plan(64, 8, 10 ** 6, 100, 10, 512, 512,
                             carry_in_smem=True)
    plan = dfa_match.merge_plan(64, 8, 210, 194, 38, 8192, 512,
                                table_in_smem=False, carry_in_smem=False)
    assert not plan["table_in_smem"] and not plan["carry_in_smem"]
    with pytest.raises(ValueError):
        dfa_match.spec_launch_plan(40, 22_857, 4096, 43_125, 5,
                                   table_in_smem=True)
    plan = dfa_match.spec_launch_plan(40, 22_857, 4096, 43_125, 5)
    assert not plan["table_in_smem"]
    assert (_spec_cover(plan, 40, 22_857) == 1).all()


def test_paper_kernel_wrappers_refuse_cpu_tensors():
    table, chunks, init = map(torch.from_numpy,
                              _spec_case(8, 3, 2, 16, 4, 1))
    before = (dict(dfa_match.launches), dict(lvec_compose.launches),
              dict(onehot_match.launches))
    with pytest.raises(ValueError, match="CUDA"):
        dfa_match.spec_match_cuda(table, chunks, init)
    with pytest.raises(ValueError, match="CUDA"):
        lvec_compose.lvec_compose_cuda(init[None])
    with pytest.raises(ValueError, match="CUDA"):
        onehot_match.onehot_block_maps_cuda(table, chunks, l_blk=16)
    assert (dfa_match.launches, lvec_compose.launches,
            onehot_match.launches) == before


def test_spec_match_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): B6 against its plain version, both
    table placements, chunks grouped and lanes split over CTAs, a 16-class
    table, L not a multiple of 4 or of the ring tile, one lane over 1 Mi
    symbols (its plain version on the CPU), and ``ops.spec_match``'s
    gather route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    cases = SPEC_GATHER + [(9, 4, 1, 5000, 1), (300, 6, 3, 200, 5000),
                           (40, 5, 700, 100, 3), (256, 16, 40, 300, 256),
                           (230, 16, 300, 130, 120), (17, 5, 37, 10_007, 9)]
    for q, ncls, c, l, s in cases:
        args = tuple(torch.from_numpy(x).cuda()
                     for x in _spec_case(q, ncls, c, l, s, q + s))
        want = dfa_match.spec_match_torch(*args)
        for smem in (True, False):
            got = dfa_match.spec_match_cuda(*args, table_in_smem=smem)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (q, c, l, s, smem)
        got = ops.spec_match(*args, use_mxu=False)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (q, c, l, s)
    args = _spec_case(64, 16, 1, (1 << 20) + 3, 1, 5)
    want = dfa_match.spec_match_torch(*map(torch.from_numpy, args))
    for smem in (True, False):
        got = dfa_match.spec_match_cuda(
            *(torch.from_numpy(x).cuda() for x in args), table_in_smem=smem)
        assert torch.equal(got.cpu(), want), smem


def test_lvec_compose_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): B7 against its plain version, one and
    many maps per tile, more states than threads, no maps, one map; small
    maps packed several to a CTA (Q = 16, 17, 103 and 4,096 compositions of
    64 maps of 17 states); compositions split into segments on a cluster
    and past one (a second launch), the plan's largest G on one
    composition of 4,096 maps, and forced splits the plan never makes
    (N not a multiple of G, N < G); maps past the ring (Q = 20,000 and
    60,000: the wide instance, split and folded too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    for b, n, q, g in ((1, 1, 4, None), (3, 100, 17, None),
                       (40, 103, 256, None), (1, 4096, 256, None),
                       (2, 7, 1500, None),
                       (5, 0, 9, None), (4096, 64, 17, None),
                       (40, 103, 16, None), (40, 103, 64, None),
                       (40, 103, 128, None), (7, 50, 103, None),
                       (3, 37, 16, 5), (3, 37, 64, 8), (2, 5, 64, 7),
                       (2, 100, 17, 24), (3, 3, 256, 16), (2, 1, 64, 4),
                       (9, 1, 16, None), (3, 2000, 1500, 16),
                       (2, 64, 20_000, None), (1, 300, 60_000, None),
                       (2, 5, 20_000, 7), (3, 1, 14_600, None)):
        maps = torch.from_numpy(
            rng.integers(0, q, size=(b, n, q)).astype(np.int32)).cuda()
        want = lvec_compose.lvec_compose_torch(maps)
        plan = lvec_compose._lvec_plan(b, n, q, g) if b and q else None
        assert plan is None or plan["wide"] == (q >= 14_600)
        got = lvec_compose._lvec_launch(maps, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, n, q, g)
        if n and b * n * q < 10 ** 6:   # maps not starting on 16 bytes
            got = lvec_compose._lvec_launch(_off16(maps), plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (b, n, q, g, "shifted")
    maps = torch.from_numpy(
        rng.integers(0, 64, size=(3, 200, 64)).astype(np.int32)).cuda()
    assert torch.equal(lvec_compose.lvec_compose_cuda(maps),
                       lvec_compose.lvec_compose_torch(maps))


def test_onehot_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): B8 against its plain version at every
    padded width class: Q_pad off a multiple of 64 (17, 100, 200), one and
    two warpgroups per CTA, the chunked P_c ring (240, 256), Q = 192 and
    256 at l_blk = 256, a wide alphabet, the worst-case matrices, and
    ``ops.spec_match``'s product route against its gather route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(4)
    for q, ncls, c, l, blk in ((1, 2, 2, 64, 64), (5, 3, 3, 256, 256),
                               (16, 16, 2, 512, 256), (17, 4, 2, 96, 32),
                               (100, 9, 3, 256, 128), (128, 16, 2, 256, 256),
                               (200, 7, 2, 512, 256), (192, 16, 2, 512, 256),
                               (240, 5, 2, 256, 64), (256, 17, 2, 512, 256),
                               (256, 257, 1, 64, 64), ("worst", 3, 2, 128, 64),
                               ("worst256", 3, 2, 512, 256)):
        if str(q).startswith("worst"):
            table = _worst_case_table(256 if q == "worst256" else 96)
            syms = np.tile([0, 1, 2, 2], (c, l // 4)).astype(np.int32)
        else:
            table = rng.integers(0, q, size=(q, ncls)).astype(np.int32)
            syms = rng.integers(0, ncls, size=(c, l)).astype(np.int32)
        t, sy = torch.from_numpy(table).cuda(), torch.from_numpy(syms).cuda()
        want = onehot_match.onehot_block_maps_torch(t, sy, l_blk=blk)
        got = onehot_match.onehot_block_maps_cuda(t, sy, l_blk=blk)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (q, ncls, c, l, blk)
    for q, ncls, c, l, s in SPEC_MXU + [(256, 16, 4, 700, 256)]:
        args = tuple(torch.from_numpy(x).cuda()
                     for x in _spec_case(q, ncls, c, l, s, q))
        want = ops.spec_match(*args, use_mxu=False)
        got = ops.spec_match(*args, use_mxu=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (q, c, l, s)


@pytest.mark.parametrize("q", [1, 16, 17, 63, 64, 65, 100, 128, 191, 192,
                               200, 224, 225, 240, 256])
def test_onehot_plan_sizes_shared_memory(q):
    """One consumer warpgroup per 64-row slab, at most two per CTA; the
    P_c ring fits one block, whole P_c buffers up to Q_pad = 224 and two
    k-chunks above."""
    plan = onehot_match.onehot_plan(q)
    qp = plan["qp"]
    assert qp % 16 == 0 and q <= qp < q + 16
    assert plan["slabs"] == -(-qp // 64)
    assert plan["consumers"] * plan["ctas"] >= plan["slabs"]
    assert plan["consumers"] * (plan["ctas"] - 1) < plan["slabs"]
    assert plan["smem"] <= 232_448
    assert plan["chunks"] == (2 if qp >= 240 else 1)
    assert plan["stages"] >= plan["chunks"] + 1
    assert plan["threads"] == plan["consumers"] * 128 + (
        128 if qp >= 192 else 32)


@pytest.mark.parametrize("q", [0, 257])
def test_onehot_plan_refuses_q_out_of_range(q):
    with pytest.raises(ValueError, match="Q"):
        onehot_match.onehot_plan(q)


def test_wgmma_header_is_generated():
    """``csrc/wgmma.cuh`` is what ``csrc/gen_wgmma.py`` writes."""
    import importlib.util
    import pathlib

    csrc = pathlib.Path(onehot_match.__file__).parent / "csrc"
    spec = importlib.util.spec_from_file_location("gen_wgmma",
                                                  csrc / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (csrc / "wgmma.cuh").read_text() == gen.render()
