"""The fused match + merge wrappers (kernels B1/B2), the serving kernels'
wrappers (B5 ``token_mask``, B9 ``flash_attn``) and the card checks of every
kernel.

On CPU tensors the port's ops run the kernels' plain versions.
``ops.spec_match_merge``/``spec_match_merge_lanes`` must return the JAX
Pallas kernels' finals or lanes, ``skipped`` block counts and ``l_blk``
exactly, ``ops.token_mask`` the JAX op's bits; ``ops.flash_attn`` agrees with
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
from repro_torch.kernels import dfa_match, flash_attn, lvec_compose, ops
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


def test_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): the CUDA kernels against their plain
    versions, both table and both lane-carry placements, early exit on and
    off, r = 1 and 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    for make in (lambda: _random_case(1, 21, (5, 8, 200)),
                 lambda: _random_case(2, 22, (5, 8, 200)),
                 lambda: _hit_case(23, (3, 8, 160))):
        packed, dev, docs, rng, (b, c, lc) = make()
        for lanes in (False, True):
            chunks, la, init = _batch(packed, dev, docs, c, lc, rng, lanes)
            args = _operands(dev, chunks, la, init, device="cuda")
            tfn = ops.spec_match_merge_lanes if lanes else ops.spec_match_merge
            pfn = (dfa_match.spec_match_merge_lanes_torch if lanes
                   else dfa_match.spec_match_merge_torch)
            for early_exit in (False, True):
                chunks_p, blk = ops._pad_merge_chunks(args[1], dev.pad_cls, 16)
                want, wskip = pfn(args[0], chunks_p, *args[2:],
                                  pad_key=dev.pad_key, l_blk=blk,
                                  early_exit=early_exit)
                for smem, carry in ((True, True), (False, True),
                                    (True, False), (False, False)):
                    got, skip, _ = tfn(*args, pad_cls=dev.pad_cls,
                                       pad_key=dev.pad_key,
                                       early_exit=early_exit, l_blk=16,
                                       table_in_smem=smem,
                                       carry_in_smem=carry)
                    torch.cuda.synchronize()
                    assert torch.equal(got.reshape(b, -1), want.reshape(b, -1))
                    assert torch.equal(skip, wskip)


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
    on every lane, the tree staged in shared memory and in its global
    scratch copy, r = 1 and 2, ragged runs."""
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
            want = lvec_compose.spec_compose_lanes_tree_torch(
                *args, pad_key=dev.pad_key)
            for in_smem in (True, False):
                got = lvec_compose.spec_compose_lanes_tree_cuda(
                    *args, pad_key=dev.pad_key, in_smem=in_smem)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (r, lens, in_smem)


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


def test_flash_attn_kernel_equals_plain_on_card():
    """Needs an NVIDIA card (sm_90a): B9 against its plain version within
    atol = rtol = 3e-2, every head dim, causal, windowed, cross-shaped and
    grouped kv heads, ragged T and S."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    cases = FLASH_CASES + [(8, 100, 100, 64, True, 0, 4),
                           (4, 77, 130, 32, False, 0, 2)]
    for case in cases:
        bh, t, s, d, causal, window = case[:6]
        group = case[6] if len(case) > 6 else 1
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in _qkv(bh, t, s, d, t + s, bkv=bh // group))
        kw = dict(causal=causal, window=window, group=group)
        want = flash_attn.flash_attn_torch(q, k, v, **kw)
        got = flash_attn.flash_attn_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=3e-2, msg=str(case))
