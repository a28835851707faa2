#!/usr/bin/env python3
"""Drive the PyTorch port of the matcher on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any mismatch raises, so the exit code is non-zero):
  1. print the card (nvidia-smi name and power limit), build every CUDA
     kernel from ``src/repro_torch/kernels/csrc`` and print the build time;
  2. hold kernels B1 (``spec_match_merge``) and B2 (``spec_match_merge_lanes``)
     against their plain PyTorch versions at the PCRE-14 shapes (B=64, C=8,
     L=8192): table and lane carry each in shared or global memory, early
     exit on and off, r=1 and r=2 — bit for bit — and time both;
  3. the main path: ``Matcher(PCRE-14).membership_batch`` over 256 ragged
     documents of 32-64 KiB, against ``backend="local"`` on the same card and
     the host sequential oracle on small documents;
  4. ``advance_segments`` over each document split in two;
  5. ``advance_cursors`` (B2) over the second halves;
  6. the in-kernel early exit on a K=1 matcher with documents full of hits;
  7. the bounds of B1 and B2;
  8. hold kernels B3 (``spec_compose_lanes``, the carry fold) and B4
     (``spec_compose_lanes_tree``) against their plain versions on real
     PCRE-14 lane maps (r=2, ragged runs): B=1024 runs of N=32 (the tree in
     shared memory) and B=8 runs of N=2048 (the tree in its global scratch
     copy) — bit for bit, the tree also against the sequential oracle on
     real lanes — and time them;
  9. the out-of-order path: ``OooStreamMatcher`` over 1024 streams of
     64 KiB in 16 segments at shuffle fractions 0, 0.25 and 1 (and 1 again
     on the tree compose, 0.25 again on ``backend="local"``), every stream's
     decision against whole-document ``membership_batch``, zero host merges,
     throughput and the device idle share; the default ``num_chunks=1``
     matcher timed beside ``num_chunks=8`` on 64 streams of 16 KiB;
 10. hold kernel B5 (``token_mask``) against its plain version bit for bit:
     B=8, V=32,000 bf16 with the phase-12 grammar's mask table, and B=128,
     V=128,256 (the llama3 vocabulary) in bf16 and f32; time it beside the
     plain version and the two-call ``torch.where`` gather-and-select;
 11. hold kernel B9 (``flash_attn``) against its plain version within
     atol = rtol = 3e-2, max |err| <= 1e-2 and RMS error <= 1e-3 of the
     plain output's RMS, at the tinyllama prefill shape (128 query heads over
     16 kv heads, T = S = 2,048, D = 64, causal), at D = 128 and with a
     window of 512; time it beside the plain version and
     ``scaled_dot_product_attention``;
 12. the serving path at full tinyllama-1.1b width, random weights from a
     seeded generator on the card: ``api.prefill`` at B=4, T=2,048 (B9 once
     per layer) against the same call on the blockwise attention path;
     ``ServingEngine.generate`` for 8 grammar-constrained prompts of 512
     bytes, 32 new tokens, greedy, no EOS (every row runs all 32 decode
     steps, B5 once per step): every row a
     live prefix of the grammar, the tokens equal to a run without the
     kernel and to a run from a chunked ``DecodeStream`` prefill, wall time,
     tokens/s and the device idle share; then ``launch.serve`` once;
 13. hold kernels B6 (``spec_match``), B7 (``lvec_compose``) and B8
     (``onehot_block_maps``) against their plain versions bit for bit and
     time them: B6 at the holub shape (Q = 256, 16 classes, C = 40,
     S = 256, L = 26,214), at the lookahead shape of phase 14(a) (C = 4,096,
     S = I_max, L = 16,384), with the PS00028 search table in global memory
     and at a prime L and C through ``ops.spec_match``; B7 on 4,096 maps and
     on [40, 103, 256]; B8 at Q = 16, 64, 128, 256 (Q = 257 refused); and
     ``ops.spec_match`` on both routes at those Q (the crossover);
 14. the paper's per-document engine, ``SpecDFAEngine(dfa,
     matcher=ops.spec_match)``, on seeded residue data with planted PROSITE
     occurrences: (a) 64 MiB through the 17 PROSITE search DFAs with
     I_max <= 128, lookahead, uniform, P = 4,096 (B6, or B8 then B7 where
     ``mxu_profitable`` picks them); (b) the paper's
     layout on the same DFAs: balanced, P = 40, Eq. 1 weights of
     ``synthetic_capacities(40)``, 8 MiB (chunk 0 on B6 with one lane), and
     r = 2 on the 4 smallest; (c) the three large PROSITE search DFAs,
     lookahead, uniform, P = 40, 1 MiB (B6, table in global memory); (d)
     basic and holub modes, P = 40, uniform and balanced, 1 MiB, on the
     PCRE-14 and PROSITE membership DFAs and random DFAs of Q = 16, 64,
     128, 256 (B8 then B7; B6 where Q < 9).  Every route's final state
     equals ``membership_sequential``'s; on the first MiB (64 KiB for (c))
     also the default torch matcher's and the host oracle ``dfa.run``'s;
     the decision equals ``Matcher.membership_batch``'s; wall time and
     bytes/s per route, ``profile_capacity`` on the card, the device idle
     share of one call of (a) and of (d), a warm repeat of (c), and the
     launches of B6, B7 and B8 inside each route's own ``membership`` call
     (each must launch the kernels ``mxu_profitable`` routes it to);
  then print the kernels line and the result line.

Only ``repro_torch``, torch and numpy are imported.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# A lane-step is one int32 add and one dependent table load from shared memory
# (or L1, the same hardware).  The H100 SXM's 67 TFLOP/s float32 rate is
# 132 SMs x 128 lanes x 2 (an FMA) per clock; per SM and clock the card issues
# 64 int32 operations and serves 32 four-byte shared-memory words, so the
# shared-memory load rate binds a lane-step.
SM_CLOCKS_PER_S = 67e12 / (128 * 2)
SMEM_LOADS_PER_S = 32 * SM_CLOCKS_PER_S   # 8.375e12 four-byte loads/s
SEED = 0
DEVICE = "cuda"
B, C, LC = 64, 8, 8192               # kernel shapes of phase 2
N_DOCS, DOC_BYTES = 256, (32 * 1024, 64 * 1024)   # phase 3 corpus
RUNS8 = ((1024, 32), (8, 2048))      # phase 8 compose shapes (B, N)
SEG8 = 256                           # bytes per phase-8 segment
STREAMS9, DOC9, SEGS9 = 1024, 64 * 1024, 16   # phase 9 streams
FRACS9 = (0.0, 0.25, 1.0)            # phase 9 shuffle fractions
SMALL9 = (64, 16 * 1024)             # phase 9 num_chunks=1 timing: streams, bytes
BF16_FLOPS_PER_S = 989.4e12          # H100 SXM dense bf16 tensor cores
MASK10 = ((8, 32_000, "bfloat16"), (128, 128_256, "bfloat16"),
          (128, 128_256, "float32"))  # phase 10 B5 shapes (B, V, dtype)
ATTN11 = ((128, 16, 2048, 64, 0), (64, 64, 2048, 128, 0),
          (128, 16, 2048, 64, 512))   # phase 11 B9: BH, BH_kv, T=S, D, window
ARCH12 = "tinyllama-1.1b"
PREFILL12 = (4, 2048)                # phase 12 api.prefill batch, prompt
SERVE12 = (8, 512, 32, 64)           # prompts, bytes, new tokens, chunk bytes
GRAMMAR12 = r"([0-9]{1,6}[.,] )*[0-9]{0,6}"
HOLUB13 = (256, 16, 40, 26_214)      # phase 13 B6/B8: Q, classes, C, L
LOOK13 = ("PS00010_ASX_HYDROXYL", 4096, 16_384)  # B6 at 14(a)'s shape: C, L
BIG13 = ("PS00028_ZINC_FINGER_C2H2", 40, 4096)  # B6, global table: C, L
PRIME13 = (17, 5, 37, 10_007, 9)     # ops.spec_match: Q, classes, C, L, S
COMPOSE13 = ((1, 4096, 256), (40, 103, 256))   # B7: B, N, Q
ONEHOT13 = (16, 64, 128, 256)        # B8 and the route crossover: Q
SCAN14, BAL14, SMALL14 = 64 << 20, 8 << 20, 1 << 20   # 14(a), (b), (c)/(d)
HEAD14C = 64 << 10                   # 14(c): bytes of the cross-checks
P14A, P14 = 4096, 40                 # processors of 14(a) and of (b)-(d)
RANDOM14 = (16, 64, 128, 256)        # 14(d) random DFAs: Q (16 classes)
PROFILE14A = LOOK13[0]               # 14(a)'s profiled call (the B6 route)
PROFILE_MARGIN_S = 2.0               # idle seconds around phase 14's profiles
RESIDUES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)

# one planted occurrence of every PCRE-14 pattern (re.search-verified)
EXAMPLES = {
    "ipv4": b"192.168.10.1", "email": b"john.doe@example.com",
    "iso_date": b"2024-01-15", "hex_color": b"#1a2B3c", "float": b"3.14e10",
    "uri_scheme": b"https://example.org/a_b", "c_ident": b"my_var1",
    "quoted": b'"hello world"', "html_tag": b"<a href=x1>",
    "uuid_like": b"deadbeef-12ab-cd34", "phone": b"+1 555 123456",
    "keyword_alt": b"while", "base64ish": b"QUJDREVGR0hJSktM==",
    "repeat_ab": b"abab",
}
# filler bytes on which no PCRE-14 pattern matches
FILLER = np.frombuffer(b" \n\t.,;:!?()[]{}*&%$'|~^", np.uint8)


def make_docs(rng, lengths, *, plant_p=0.3, dense=False):
    """Documents of filler with planted pattern occurrences: each pattern is
    planted in a doc with probability ``plant_p``, a few times; ``dense``
    docs repeat every example throughout (every block of every chunk sees
    every pattern, so all lanes absorb early)."""
    names = list(EXAMPLES)
    docs = []
    for n in lengths:
        n = int(n)
        if dense:
            unit = b" ".join(EXAMPLES.values()) + b" "
            docs.append((unit * (n // len(unit) + 1))[:n])
            continue
        buf = rng.choice(FILLER, size=n)
        for name in names:
            if rng.random() < plant_p:
                ex = np.frombuffer(EXAMPLES[name], np.uint8)
                for pos in rng.integers(0, n - len(ex), size=3):
                    buf[pos:pos + len(ex)] = ex
        docs.append(buf.tobytes())
    return docs


def cuda_ms(fn, iters):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_busy(fn, tag, margin=0.0):
    """Run ``fn`` once under torch.profiler; print its wall time, the device
    busy time (device-side events only: kernels and copies — an aten op's
    own device time repeats its kernels', and the profiler's buffer
    requests are its own overhead), the device idle share of the wall time
    and the largest kernels.  Returns the idle share (None when the
    profiler recorded no device time).  The device is idle when the
    profile opens.  ``margin`` idle seconds inside the profile before and
    after the call, outside the timed wall: late in a long process (phase
    14) the profiler can otherwise drop the device records of a call that
    starts or ends close to the profile's own start or stop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(margin)
    dev = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if (us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.key.startswith("Activity Buffer")):
            dev[ev.key] = dev.get(ev.key, 0.0) + us
    busy = sum(dev.values()) / 1e6
    if busy == 0:
        print(f"{tag} profiler: no device time recorded (not measured)")
        return None
    print(f"{tag} profiled call: wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"device idle share {1 - busy / wall:.3f}")
    for key, us in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"{tag}   device {us / 1e3:9.3f} ms  {key[:90]}")
    return 1 - busy / wall


def profile_main_path(m, docs, n_bytes):
    """A warm repeat of the main-path call on the host clock, then one call
    under torch.profiler."""
    t0 = time.perf_counter()
    m.membership_batch(docs)
    warm = time.perf_counter() - t0
    print(f"[3] warm repeat: {warm:.4f} s: {len(docs) / warm:.1f} docs/s, "
          f"{n_bytes / warm / 1e6:.1f} MB/s")
    device_busy(lambda: m.membership_batch(docs), "[3]")


def lane_runs(mg, rng, b, n, seg_len):
    """``b`` runs of up to ``n`` real lane maps: each run chains segments of
    ``seg_len`` random bytes, every map matched by ``advance_cursors`` at
    the run's true boundary key; a quarter of the runs stop early and pad
    with zero maps under ``pad_key``.  Returns numpy maps [b, n, K, S] and
    keys [b, n]."""
    dev = mg.dev
    lens = np.full(b, n)
    short = rng.random(b) < 0.25
    lens[short] = rng.integers(1, n + 1, size=int(short.sum()))
    data = rng.integers(0, 256, size=(b, 2 + n * seg_len), dtype=np.uint8)
    keys = np.full((b, n), dev.pad_key, np.int32)
    segs, where = [], []
    for i in range(b):
        key = dev.advance_key(-1, data[i, :2])
        for j in range(lens[i]):
            seg = data[i, 2 + j * seg_len:2 + (j + 1) * seg_len]
            keys[i, j] = key
            segs.append(seg)
            where.append((i, j))
            key = dev.advance_key(key, seg)
    flat = np.array([keys[i, j] for i, j in where], np.int32)
    cands = dev.tables.candidates.astype(np.int32)
    res = mg.advance_cursors(segs, np.ascontiguousarray(cands[flat]), flat)
    maps = np.zeros((b, n, mg.packed.n_patterns, dev.i_max), np.int32)
    rows, cols = np.array(where).T
    maps[rows, cols] = res.lane_states
    return maps, keys


def real_lane_mask(tables, keys0):
    """[B, K, S] mask of the real candidate lanes of each run's first key:
    the only lanes a consumer addresses through ``cand_index``."""
    cands = tables.candidates[keys0]
    b, k, s = cands.shape
    lane = np.take_along_axis(tables.cand_index[keys0],
                              cands.reshape(b, -1), axis=1)
    return lane.reshape(b, k, s) == np.arange(s)


def arrival_plans(rng, n_streams, n_segs, frac):
    """Per stream, the last round(frac * n_segs) arrivals are displaced
    segments, shuffled among themselves; the rest arrive in order."""
    plans = []
    k = int(round(frac * n_segs))
    for _ in range(n_streams):
        displaced = (sorted(rng.choice(n_segs, size=k, replace=False)
                            .tolist()) if k else [])
        kept = [i for i in range(n_segs) if i not in set(displaced)]
        rng.shuffle(displaced)
        plans.append(kept + displaced)
    return plans


def run_streams(ooo, docs, plans, seg_len):
    """Deliver every stream's segments round-robin in its arrival order,
    each with its ``prev_tail`` hint, flushing after every round; returns
    the closed streams' results."""
    streams = [ooo.open() for _ in docs]
    for r in range(len(plans[0])):
        for s, d, order in zip(streams, docs, plans):
            i = order[r]
            s.feed(i, d[i * seg_len:(i + 1) * seg_len],
                   prev_tail=d[max(0, i * seg_len - 2):i * seg_len])
        ooo.flush()
    return [s.close() for s in streams]


def kernel_device_ms(fn, name, iters):
    """Mean device time of one launch of the kernels whose name contains
    ``name``, over ``iters`` calls of ``fn`` under torch.profiler (None if
    the profiler recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key and ev.device_type == torch.autograd.DeviceType.CUDA:
            us += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
            n += ev.count
    return us / n / 1e3 if n and us > 0 else None


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def grammar_prompts(rng, b, t):
    """[b, t] byte prompts made of ``GRAMMAR12``'s groups, cut at t: every
    row is a live prefix of the grammar."""
    rows = []
    for _ in range(b):
        s = b""
        while len(s) < t:
            digits = rng.choice(np.frombuffer(b"0123456789", np.uint8),
                                size=int(rng.integers(1, 7)))
            sep = rng.choice(np.frombuffer(b".,", np.uint8), size=1)
            s += digits.tobytes() + sep.tobytes() + b" "
        rows.append(np.frombuffer(s[:t], np.uint8).astype(np.int32))
    return np.stack(rows)


def live_prefix(dfa, prompt, row, eos):
    """Whether prompt + the row's tokens up to EOS keep the DFA out of its
    sink, with byte tokens only before EOS."""
    gen = row[:np.argmax(row == eos)] if (row == eos).any() else row
    if not (gen < 256).all():
        return False
    state = dfa.start
    for c in dfa.classes_of(np.concatenate([prompt, gen]).astype(np.uint8)):
        state = int(dfa.table[state, int(c)])
    return state != dfa.sink


def numel(tree):
    """Elements of a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    return tree.numel()


def decode_steps(out, eos):
    """Decode steps ``generate`` ran for its output: it stops after the step
    at which every row has emitted EOS."""
    done = np.cumsum(out == eos, axis=1) > 0
    full = np.flatnonzero(done.all(axis=0))
    return int(full[0]) + 1 if full.size else out.shape[1]


def phase10_token_mask(gc, rng, kernels):
    """B5 against its plain version, bit for bit, and its times."""
    import torch
    from repro_torch.kernels import token_mask

    for b, v, dtype in MASK10:
        dt = getattr(torch, dtype)
        if v == gc.allowed.shape[1]:
            allowed = gc.allowed
        else:  # the grammar's mask rows over a larger vocabulary
            allowed = torch.nn.functional.pad(
                gc.allowed, (0, v - gc.allowed.shape[1]))
            allowed[:, gc.allowed.shape[1]:] = torch.from_numpy(
                rng.integers(0, 2, size=(allowed.shape[0],
                                         v - gc.allowed.shape[1]),
                             dtype=np.uint8)).to(DEVICE)
        states = torch.from_numpy(rng.integers(
            0, allowed.shape[0], size=b).astype(np.int32)).to(DEVICE)
        logits = torch.randn(b, v, device=DEVICE).to(dt)
        args = (states, allowed, logits)
        want = token_mask.token_mask_torch(*args)
        got = token_mask.token_mask_cuda(*args)
        torch.cuda.synchronize()
        bits = torch.int32 if dt == torch.float32 else torch.int16
        check(torch.equal(got.view(bits), want.view(bits)),
              f"token_mask B={b} V={v} {dtype}: kernel differs from its "
              "plain version")
        neg = torch.tensor(-1e30, dtype=dt, device=DEVICE)
        library = lambda: torch.where(allowed[states.long()] > 0, logits, neg)
        for _ in range(3):
            token_mask.token_mask_cuda(*args)
        ms = cuda_ms(lambda: token_mask.token_mask_cuda(*args), 50)
        dev_ms = kernel_device_ms(lambda: token_mask.token_mask_cuda(*args),
                                  "token_mask", 20)
        plain_ms = cuda_ms(lambda: token_mask.token_mask_torch(*args), 20)
        lib_ms = cuda_ms(library, 20)
        # each input read once (the mask rows of the distinct states, the
        # logits, the states), the output written once
        rows = int(torch.unique(states).numel())
        n_bytes = (rows * v + 2 * logits.numel() * logits.element_size()
                   + 4 * b)
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"[10] token_mask B={b} V={v} {dtype} Q={allowed.shape[0]} "
              f"({rows} distinct states): "
              f"kernel {ms:.5f} ms per call (device time "
              f"{'n/a' if dev_ms is None else f'{dev_ms:.5f} ms'})  "
              f"plain {plain_ms:.5f} ms  library "
              f"{lib_ms:.5f} ms  bound {bound:.5f} ms (bytes, "
              f"{n_bytes} B)  equal bit for bit")
        if (b, v, dtype) == MASK10[0]:
            kernels["token_mask"] = dict(
                name="token_mask", route="cuda",
                source="src/repro_torch/kernels/csrc/token_mask.cu",
                replaces="src/repro/kernels/token_mask.py:28",
                launches=None, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=lib_ms)


def attn_bound(bh, bh_kv, t, s, d, window):
    """(ms, "bytes"/"operations") bound of one causal attention call: the
    unmasked (q, k) pairs at 4*D flops each over the bf16 tensor-core rate,
    against Q, K, V and O moved once."""
    q = np.arange(t)
    live = np.minimum(q + 1, window) if window > 0 else q + 1
    flops = 4.0 * bh * float(live.sum()) * d
    n_bytes = 2 * d * (2 * bh * t + 2 * bh_kv * s)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops


def phase11_flash_attn(kernels):
    """B9 against its plain version within 3e-2, and its times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    worst = 0.0
    for bh, bh_kv, t, d, window in ATTN11:
        group = bh // bh_kv
        q = torch.randn(bh, t, d, device=DEVICE, generator=gen).bfloat16()
        k = torch.randn(bh_kv, t, d, device=DEVICE, generator=gen).bfloat16()
        v = torch.randn(bh_kv, t, d, device=DEVICE, generator=gen).bfloat16()
        kw = dict(causal=True, window=window, group=group)
        want = flash_attn.flash_attn_torch(q, k, v, **kw).float()
        got = flash_attn.flash_attn_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        # at T = 2,048 a typical output is ~0.04, so 3e-2 alone would pass a
        # dropped kv tile: the error is also held to 1e-2 and its RMS to
        # 1e-3 of the plain output's RMS (on an H100: 0.0039 and under 1e-4)
        rms = float(want.pow(2).mean().sqrt())
        rel_rms = float(err.pow(2).mean().sqrt()) / rms
        check(bool((err <= 3e-2 + 3e-2 * want.abs()).all())
              and float(err.max()) <= 1e-2 and rel_rms <= 1e-3,
              f"flash_attn BH={bh} T={t} D={d} window={window}: kernel "
              f"differs from its plain version (max |err| "
              f"{float(err.max())}, RMS err / RMS out {rel_rms})")
        worst = max(worst, float(err.max()))
        for _ in range(2):
            flash_attn.flash_attn_cuda(q, k, v, **kw)
        ms = cuda_ms(lambda: flash_attn.flash_attn_cuda(q, k, v, **kw), 10)
        plain_ms = cuda_ms(lambda: flash_attn.flash_attn_torch(q, k, v, **kw),
                           1)
        lib_ms = None
        if window == 0:
            b = bh // 32 if bh % 32 == 0 else 1
            q4 = q.view(b, bh // b, t, d)
            k4, v4 = k.view(b, bh_kv // b, t, d), v.view(b, bh_kv // b, t, d)
            sdpa = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=group > 1)
            sdpa()
            lib_ms = cuda_ms(sdpa, 10)
        bound, by, flops = attn_bound(bh, bh_kv, t, t, d, window)
        print(f"[11] flash_attn BH={bh} (kv {bh_kv}) T=S={t} D={d} causal "
              f"window={window}: max |err| {float(err.max()):.6f}, RMS out "
              f"{rms:.6f}, RMS err / RMS out {rel_rms:.6f}  kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)  plain "
              f"{plain_ms:.3f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
              f"{bound:.5f} ms ({by})")
        if (bh, bh_kv, t, d, window) == ATTN11[0]:
            kernels["flash_attn"] = dict(
                name="flash_attn", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attn.cu",
                replaces="src/repro/kernels/flash_attn.py:39",
                launches=None, max_abs_err=None, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)
    kernels["flash_attn"]["max_abs_err"] = worst
    print(f"[11] flash_attn within 3e-2 and 1e-2 of its plain version (max "
          f"|err| {worst:.6f})")


def phase12_serving(rng, counts):
    """The serving path at full width: api.prefill on B9, generate on B5."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import compile_regex
    from repro_torch.kernels import flash_attn, token_mask
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serving import (GrammarConstraint, ServeConfig,
                                     ServingEngine)

    cfg = get_config(ARCH12)
    t0 = time.perf_counter()
    params = api.init(cfg, SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = numel(params)
    print(f"[12] {ARCH12}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads, head_dim "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params} random f32 parameters in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- api.prefill: B9 on the card vs the blockwise attention path
    b, t = PREFILL12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, t))
                              .astype(np.int32)).to(DEVICE)
    batch = {"tokens": tokens}
    runs = {}
    for route in ("auto", "0"):
        os.environ["REPRO_PALLAS_ATTN"] = route
        api.prefill(params, cfg, batch)          # warm
        torch.cuda.synchronize()
        flash_attn.reset_launches()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, cfg, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[route] = (logits[:, -1].float(), wall,
                       flash_attn.launches["flash_attn"])
        del cache
    os.environ.pop("REPRO_PALLAS_ATTN")
    (lk, wk, nk), (lx, wx, nx) = runs["auto"], runs["0"]
    counts["flash_attn"] = nk
    check(nk == cfg.n_layers and nx == 0,
          f"api.prefill launched B9 {nk} times (blockwise route {nx}); "
          f"expected once per layer ({cfg.n_layers})")
    check(bool(torch.isfinite(lk).all()) and lk.shape == (b, cfg.padded_vocab),
          "prefill logits not finite or of the wrong shape")
    err = float((lk - lx).abs().max())
    scale = float(lx.abs().max())
    print(f"[12] api.prefill B={b} T={t}: B9 route {wk:.4f} s "
          f"({b * t / wk:.0f} tokens/s, B9 launches {nk}); blockwise route "
          f"{wx:.4f} s ({b * t / wx:.0f} tokens/s); last-position logits "
          f"max |err| {err:.5f} of max |logit| {scale:.4f} "
          f"({err / scale:.5f})")
    check(err <= 5e-2 * scale, "prefill logits on B9 and on the blockwise "
          "path differ by more than 5e-2 of the largest logit")
    ak, ax = lk.argmax(-1), lx.argmax(-1)
    if torch.equal(ak, ax):
        print(f"[12] greedy argmax of every row agrees: {ak.tolist()}")
    for r in torch.nonzero(ak != ax).flatten().tolist():
        top2 = lx[r].topk(2).values
        print(f"[12] row {r}: argmax {int(ak[r])} vs {int(ax[r])}; "
              f"blockwise top-2 margin {float(top2[0] - top2[1]):.5f}")
    device_busy(lambda: api.prefill(params, cfg, batch), "[12] prefill")

    # -- ServingEngine.generate, grammar-constrained, greedy
    n, width, max_new, chunk = SERVE12
    dfa = compile_regex(GRAMMAR12)
    prompts = grammar_prompts(rng, n, width)
    # no EOS: every state of GRAMMAR12 has a byte continuation, so each row
    # runs all max_new decode steps
    gc = GrammarConstraint(dfa, cfg.padded_vocab, eos_id=None, device=DEVICE)
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=max_new),
                        constraint=gc)
    eng.generate(prompts[:, :64])                # warm
    torch.cuda.synchronize()
    token_mask.reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    wall = time.perf_counter() - t0
    launched = token_mask.launches["token_mask"]
    counts["token_mask"] = launched
    steps = decode_steps(out, eng.serve.eos_id)
    check(steps == max_new and launched == steps, f"generate launched B5 "
          f"{launched} times over {steps} decode steps (of {max_new})")
    check(out.shape == (n, max_new) and all(
        live_prefix(dfa, p, row, eng.serve.eos_id)
        for p, row in zip(prompts, out)),
        "a generated row leaves the grammar")
    n_tok = int(sum(np.argmax(r == eng.serve.eos_id) + 1
                    if (r == eng.serve.eos_id).any() else len(r)
                    for r in out))
    print(f"[12] generate: {n} prompts x {width} bytes, {steps} decode "
          f"steps, {n_tok} tokens (EOS included) in {wall:.4f} s: "
          f"{n_tok / wall:.1f} tokens/s, {n * steps / wall:.1f} row-steps/s;"
          f" B5 launches {launched}; every row a live prefix of the grammar")
    for p, row in list(zip(prompts, out))[:2]:
        text = bytes(int(x) for x in row if x < 256).decode(errors="replace")
        print(f"[12]   ...{bytes(p[-24:].astype(np.uint8)).decode()!r} -> "
              f"{text!r}")
    plain = GrammarConstraint(dfa, cfg.padded_vocab, use_kernel=False,
                              eos_id=None, device=DEVICE)
    out_plain = ServingEngine(cfg, params, ServeConfig(max_new_tokens=max_new),
                              constraint=plain).generate(prompts)
    check(np.array_equal(out, out_plain),
          "generate with B5 differs from generate with use_kernel=False")
    t0 = time.perf_counter()
    ds = gc.open_decode(n)
    for lo in range(0, width, chunk):
        ds.feed_tokens(prompts[:, lo:lo + chunk])
    stream_wall = time.perf_counter() - t0
    one_shot = gc.advance_tokens(gc.init_states(n), prompts)
    check(torch.equal(ds.states, one_shot),
          "chunked DecodeStream states differ from the one-shot prefill")
    out_stream = eng.generate(prompts, decode_stream=ds)
    check(np.array_equal(out, out_stream),
          "generate from a chunked DecodeStream differs")
    print(f"[12] --stream prefill: {width // chunk} chunk rounds of {chunk} "
          f"bytes x {n} rows in {stream_wall:.4f} s ({ds.stream.stats.ticks}"
          f" ticks, the seq lowering); states equal the one-shot prefill; "
          f"tokens equal with use_kernel=False and from the stream")
    device_busy(lambda: eng.generate(prompts), "[12] generate")
    # one eager decode step at the generate batch, on the host clock
    from repro_torch.models import transformer as TF
    cache = TF.init_cache(cfg, n, width + max_new, device=DEVICE)
    tok = torch.full((n, 1), ord("1"), dtype=torch.int32, device=DEVICE)
    TF.decode_step(params, cfg, cache, tok, width)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, 9):
        TF.decode_step(params, cfg, cache, tok, width + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    print(f"[12] decode_step (eager, B={n}, cache {width + max_new}): "
          f"{step_ms:.2f} ms per step on the host clock")
    device_busy(lambda: TF.decode_step(params, cfg, cache, tok, width + 9),
                "[12] decode_step")
    del cache
    del params, eng
    torch.cuda.empty_cache()
    serve.main(["--arch", ARCH12, "--max-new", "8", "--prompts", "12. 34",
                "7, 891", "--grammar", GRAMMAR12])


def spec_bound(c, s, l, q, n_cls):
    """(ms, by, lane-steps) of a B6 call: one dependent shared-memory load
    per lane-step, against the symbols, lanes and table moved once."""
    steps = c * s * l
    t_ops = steps / SMEM_LOADS_PER_S * 1e3
    t_bytes = 4 * (c * l + 2 * c * s + q * n_cls) / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops
            else "operations", steps)


def onehot_bound(q, n_cls, c, l, l_blk):
    """(ms, by, flops) of a B8 call: 2 * Q_pad^3 flops per symbol at the
    dense bf16 rate, against the symbols, table and maps moved once."""
    qp = -(-q // 16) * 16
    flops = 2.0 * qp ** 3 * c * l
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = 4 * (c * l + c * (l // l_blk) * q + q * n_cls) \
        / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops
            else "operations", flops)


def prosite_example(dfa, rng):
    """A shortest residue string the membership DFA accepts, a random one
    among the shortest."""
    cls = dfa.byte_to_class[RESIDUES]
    nxt = dfa.table[:, cls]                          # [Q, 20]
    dist = np.where(dfa.accepting, 0, -1)
    for d in range(dfa.n_states):
        reach = (dist < 0) & (dist[nxt] == d).any(axis=1)
        if not reach.any():
            break
        dist[reach] = d + 1
    s, out = dfa.start, []
    while dist[s] > 0:
        ok = np.flatnonzero(dist[nxt[s]] == dist[s] - 1)
        r = int(rng.choice(ok))
        out.append(RESIDUES[r])
        s = int(nxt[s, r])
    return np.array(out, np.uint8)


def residue_data(rng, n, members):
    """n seeded residues; every PROSITE pattern planted at a random place in
    a random half of the data's eighths."""
    data = rng.choice(RESIDUES, size=n)
    eighth = n // 8
    for dfa in members.values():
        for part in rng.choice(8, size=4, replace=False):
            ex = prosite_example(dfa, rng)
            pos = part * eighth + int(rng.integers(0, eighth - len(ex)))
            data[pos:pos + len(ex)] = ex
    return data


def phase13_paper_kernels(rng, kernels, search):
    """B6, B7 and B8 against their plain versions, bit for bit, their times
    and bounds, and the gather/product crossover of ``ops.spec_match``."""
    import torch
    from repro_torch.core import build_lookahead_tables, random_dfa
    from repro_torch.kernels import dfa_match, lvec_compose, onehot_match, ops

    put = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(
        DEVICE)
    errs = {"spec_match": 0, "lvec_compose": 0, "onehot_block_maps": 0}

    def held(name, got, want, what):
        """The kernel's max |err| against its plain version; must be 0."""
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs[name] = max(errs[name], err)
        check(err == 0 and got.shape == want.shape,
              f"{what}: kernel differs from its plain version")

    q, n_cls, c, l = HOLUB13
    holub = random_dfa(q, n_cls, rng=rng, with_sink=False)
    chunks = rng.integers(0, n_cls, size=(c, l))

    def b6(tag, table, chunks_t, init, n_iter, row=False):
        want = dfa_match.spec_match_torch(table, chunks_t, init)
        plain_ms = cuda_ms(lambda: dfa_match.spec_match_torch(
            table, chunks_t, init), 1)
        got = dfa_match.spec_match_cuda(table, chunks_t, init)
        torch.cuda.synchronize()
        held("spec_match", got, want, f"spec_match {tag}")
        dfa_match.spec_match_cuda(table, chunks_t, init)
        ms = cuda_ms(lambda: dfa_match.spec_match_cuda(table, chunks_t, init),
                     n_iter)
        (cc, ll), ss = chunks_t.shape, init.shape[1]
        bound, by, steps = spec_bound(cc, ss, ll, *table.shape)
        smem = dfa_match.spec_table_in_smem(*table.shape, cc, ss)
        print(f"[13] spec_match {tag}: C={cc} S={ss} L={ll} Q={table.shape[0]}"
              f" table {'smem' if smem else 'global'}: kernel {ms:.4f} ms "
              f"({steps / ms / 1e9:.3f} T lane-steps/s)  plain "
              f"{plain_ms:.2f} ms  bound {bound:.5f} ms ({by})  equal")
        if row:
            kernels["spec_match"] = dict(
                name="spec_match", route="cuda",
                source="src/repro_torch/kernels/csrc/dfa_match.cu",
                replaces="src/repro/kernels/dfa_match.py:39", launches=None,
                max_abs_err=None, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)

    allq = np.broadcast_to(np.arange(q), (c, q))
    b6("holub shape", put(holub.table), put(chunks), put(allq), 5)
    name, cl, ll = LOOK13
    look = search[name]
    s_look = build_lookahead_tables(look).i_max
    b6(f"lookahead shape ({name})", put(look.table),
       put(rng.integers(0, look.n_classes, size=(cl, ll))),
       put(rng.integers(0, look.n_states, size=(cl, s_look))), 5, row=True)
    name, cg, lg = BIG13
    big = search[name]
    s_big = build_lookahead_tables(big).i_max
    b6(f"global table ({name})", put(big.table),
       put(rng.integers(0, big.n_classes, size=(cg, lg))),
       put(rng.integers(0, big.n_states, size=(cg, s_big))), 2)
    qp, cp_, cp, lp, sp = PRIME13
    prime = random_dfa(qp, cp_, rng=rng)
    args = (put(prime.table), put(rng.integers(0, cp_, size=(cp, lp))),
            put(rng.integers(0, qp, size=(cp, sp))))
    want = ops.spec_match(*[a.cpu() for a in args], use_mxu=False)
    for use_mxu in (False, True):
        got = ops.spec_match(*args, use_mxu=use_mxu)
        check(torch.equal(got.cpu(), want), f"ops.spec_match at prime L={lp},"
              f" C={cp} (use_mxu={use_mxu}) differs from the CPU run")
    print(f"[13] ops.spec_match at prime L={lp}, C={cp}, S={sp}: both routes "
          "equal the plain version run on the CPU")

    # -- B7
    for b, n, qq in COMPOSE13:
        maps = put(rng.integers(0, qq, size=(b, n, qq)))
        want = lvec_compose.lvec_compose_torch(maps)
        plain_ms = cuda_ms(lambda: lvec_compose.lvec_compose_torch(maps), 1)
        got = lvec_compose.lvec_compose_cuda(maps)
        torch.cuda.synchronize()
        held("lvec_compose", got, want, f"lvec_compose [{b}, {n}, {qq}]")
        ms = cuda_ms(lambda: lvec_compose.lvec_compose_cuda(maps), 20)
        loads = b * n * qq
        t_ops = loads / SMEM_LOADS_PER_S * 1e3
        t_bytes = 4 * (b * n * qq + b * qq) / HBM_BYTES_PER_S * 1e3
        bound, by = max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                          else "operations")
        print(f"[13] lvec_compose [{b}, {n}, {qq}]: kernel {ms:.4f} ms "
              f"({loads / ms / 1e9:.3f} G map-steps/s)  plain {plain_ms:.3f} "
              f"ms  bound {bound:.6f} ms ({by})  equal")
        if (b, n, qq) == COMPOSE13[1]:
            kernels["lvec_compose"] = dict(
                name="lvec_compose", route="cuda",
                source="src/repro_torch/kernels/csrc/lvec_compose.cu",
                replaces="src/repro/kernels/lvec_compose.py:47",
                launches=None, max_abs_err=None, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)

    # -- B8, and the two routes of ops.spec_match at S = Q
    l_blk, l_pad = ops._pad_to_block(l, 256)
    for qq in ONEHOT13:
        dfa = random_dfa(qq, n_cls, rng=rng, with_sink=False)
        table, id_cls = ops._identity_padded_table(put(dfa.table))
        syms = torch.nn.functional.pad(put(chunks), (0, l_pad - l),
                                       value=id_cls).contiguous()
        want = onehot_match.onehot_block_maps_torch(table, syms, l_blk=l_blk)
        plain_ms = cuda_ms(lambda: onehot_match.onehot_block_maps_torch(
            table, syms, l_blk=l_blk), 1)
        got = onehot_match.onehot_block_maps_cuda(table, syms, l_blk=l_blk)
        torch.cuda.synchronize()
        held("onehot_block_maps", got, want, f"onehot_block_maps Q={qq}")
        ms = cuda_ms(lambda: onehot_match.onehot_block_maps_cuda(
            table, syms, l_blk=l_blk), 2)
        bound, by, flops = onehot_bound(qq, n_cls + 1, c, l_pad, l_blk)
        print(f"[13] onehot_block_maps Q={qq} C={c} L={l_pad} l_blk={l_blk}:"
              f" kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)  plain "
              f"{plain_ms:.1f} ms  bound {bound:.4f} ms ({by})  equal")
        if qq == ONEHOT13[-1]:
            kernels["onehot_block_maps"] = dict(
                name="onehot_block_maps", route="cuda",
                source="src/repro_torch/kernels/csrc/onehot_match.cu",
                replaces="src/repro/kernels/onehot_match.py:43",
                launches=None, max_abs_err=None, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)
        args = (put(dfa.table), put(chunks),
                put(np.broadcast_to(np.arange(qq), (c, qq))))
        routes = {}
        for use_mxu in (False, True):
            call = lambda: ops.spec_match(*args, use_mxu=use_mxu)
            routes[use_mxu] = call()
            routes[use_mxu, "ms"] = cuda_ms(call, 2)
        check(torch.equal(routes[False], routes[True]),
              f"ops.spec_match Q={qq}: the two routes differ")
        print(f"[13] crossover Q=S={qq}, C={c}, L={l}: gather route (B6) "
              f"{routes[False, 'ms']:.4f} ms, product route (B8 + B7) "
              f"{routes[True, 'ms']:.3f} ms; mxu_profitable -> "
              f"{'product' if ops.mxu_profitable(qq, qq) else 'gather'}")
    try:
        onehot_match.onehot_block_maps_cuda(
            put(np.zeros((257, 2))), put(np.zeros((1, 16))), l_blk=16)
    except ValueError as err:
        print(f"[13] Q=257 refused: mxu_profitable(257, 257) = "
              f"{ops.mxu_profitable(257, 257)}; the kernel: {err}")
    else:
        raise AssertionError("onehot_block_maps_cuda took Q = 257")
    check(not ops.mxu_profitable(257, 257), "mxu_profitable took Q = 257")
    for name, err in errs.items():
        kernels[name]["max_abs_err"] = err
    print(f"[13] B6, B7 and B8 equal their plain versions (max |err| {errs})")


def phase14_paper_engine(rng, counts, search):
    """The paper engine on the card: routes against each other, the
    sequential matcher, the default matcher, ``dfa.run`` and ``Matcher``."""
    import torch
    from repro_torch.core import (Matcher, SpecDFAEngine,
                                  build_lookahead_tables,
                                  compile_pattern_suite, profile_capacity,
                                  profile_workers, random_dfa,
                                  synthetic_capacities)
    from repro_torch.kernels import dfa_match, lvec_compose, onehot_match, ops

    cap = profile_capacity(device=DEVICE)
    print(f"[14] profile_capacity on the card: {cap:.2f} symbols/us "
          "(sequential_state, B6 with one lane, random Q=64 DFA, 200,000 "
          "symbols, median of 5)")
    members = compile_pattern_suite("prosite", search=False)
    pcre = compile_pattern_suite("pcre", search=False)
    i_max = {k: build_lookahead_tables(d).i_max for k, d in search.items()}
    small = sorted((k for k in search if i_max[k] <= 128),
                   key=lambda k: search[k].n_states)
    big = [k for k in search if i_max[k] > 128]
    t0 = time.perf_counter()
    data = residue_data(rng, SCAN14, members)
    print(f"[14] {SCAN14} residues (seed {SEED}, every PROSITE pattern "
          f"planted in 4 of 8 eighths) in {time.perf_counter() - t0:.2f} s; "
          f"{len(small)} search DFAs with I_max <= 128, {len(big)} large")
    weights = profile_workers(synthetic_capacities(P14))
    names = ("spec_match", "lvec_compose", "onehot_block_maps")
    launched = {f"[14{p}]": dict.fromkeys(names, 0) for p in "abcd"}

    def path_kernels(eng):
        """The kernels one ``eng.membership`` call must launch: B8 and B7
        where ``ops.spec_match`` takes the product route, else B6; B6 also
        for the balanced partition's sequential chunk 0."""
        want = ({"onehot_block_maps", "lvec_compose"} if ops.mxu_profitable(
            eng.dfa.n_states, eng.lanes_per_chunk) else {"spec_match"})
        return want | ({"spec_match"} if eng.partition == "balanced"
                       else set())

    def main_path(tag, what, eng, doc):
        """One main-path call, timed, with its own launch counts: every
        count is 0 just before it and read just after it."""
        for mod in (dfa_match, lvec_compose, onehot_match):
            mod.reset_launches()
        t0 = time.perf_counter()
        res = eng.membership(doc)
        wall = time.perf_counter() - t0
        n = {"spec_match": dfa_match.launches["spec_match"],
             "lvec_compose": lvec_compose.launches["lvec_compose"],
             "onehot_block_maps": onehot_match.launches["onehot_block_maps"]}
        want = path_kernels(eng)
        check(all(n[k] > 0 for k in want), f"{tag} {what}: the call "
              f"launched {n}, not every kernel of {sorted(want)}")
        for k, v in n.items():
            counts[k] = counts.get(k, 0) + v
            launched[tag][k] += v
        return res, wall

    def timed(fn, doc):
        t0 = time.perf_counter()
        res = fn(doc)
        return res, time.perf_counter() - t0

    def check_dfa(tag, name, dfa, doc, routes, head_bytes, walls):
        """Every route against membership_sequential; the head against the
        default matcher and dfa.run; the decision against Matcher.  Only
        the routes' ``membership(doc)`` calls count launches."""
        def add(route, w):
            t, n = walls.get(route, (0.0, 0))
            walls[route] = (t + w, n + len(doc))

        seq, w = timed(routes[0][1].membership_sequential, doc)
        add("sequential", w)
        finals = {}
        for route, eng in routes:
            res, w = main_path(tag, f"{name} {route}", eng, doc)
            add(route, w)
            finals[route] = res.final_state
            check(res.final_state == seq.final_state, f"{tag} {name} {route}"
                  f": final {res.final_state} != sequential "
                  f"{seq.final_state}")
        head = doc[:head_bytes]
        route0, eng0 = routes[0]
        default = SpecDFAEngine(dfa, num_chunks=eng0.num_chunks,
                                mode=eng0.mode, partition=eng0.partition,
                                weights=eng0.weights,
                                lookahead_r=eng0.lookahead_r, device=DEVICE)
        oracle = dfa.run(head)
        got = (eng0.membership(head).final_state,
               default.membership(head).final_state)
        check(got == (oracle, oracle), f"{tag} {name}: on the first "
              f"{head_bytes} bytes {route0} / the default matcher {got} != "
              f"dfa.run {oracle}")
        doc_m = doc if tag != "[14c]" else head
        acc = bool(Matcher(dfa, device=DEVICE).membership_batch(
            [doc_m]).accepted[0, 0])
        want = seq.accepted if tag != "[14c]" else bool(dfa.accepting[oracle])
        check(acc == want, f"{tag} {name}: Matcher decides {acc}")
        print(f"{tag} {name}: Q={dfa.n_states} classes={dfa.n_classes} "
              f"I_max={eng0.i_max} final {seq.final_state} "
              f"accepted {seq.accepted}; routes {sorted(finals)} equal "
              f"sequential, the default matcher, dfa.run and Matcher")

    def report(tag, walls):
        for route, (w, n_bytes) in walls.items():
            print(f"{tag} {route}: {w:.3f} s over {n_bytes} bytes, "
                  f"{n_bytes / w / 1e6:.1f} MB/s")

    # -- (a) the PROSITE scan: lookahead, uniform, P = 4,096 ------------------
    walls = {}
    for name in small:
        eng = SpecDFAEngine(search[name], num_chunks=P14A, mode="lookahead",
                            partition="uniform", matcher=ops.spec_match,
                            device=DEVICE)
        check_dfa("[14a]", name, search[name], data,
                  [("lookahead/uniform", eng)], SMALL14, walls)
    n = launched["[14a]"]
    check(n["spec_match"] > 0, f"(a) launched no B6 kernel: {n}")
    report("[14a]", walls)
    print(f"[14a] launches {n}")
    name = PROFILE14A
    eng = SpecDFAEngine(search[name], num_chunks=P14A, mode="lookahead",
                        partition="uniform", matcher=ops.spec_match,
                        device=DEVICE)
    device_busy(lambda: eng.membership(data), f"[14a] {name}",
                PROFILE_MARGIN_S)

    # -- (b) the paper's layout: balanced, P = 40, Eq. 1 weights -------------
    walls = {}
    doc = data[:BAL14]
    for i, name in enumerate(small):
        routes = [("lookahead/balanced", SpecDFAEngine(
            search[name], num_chunks=P14, mode="lookahead",
            partition="balanced", weights=weights, matcher=ops.spec_match,
            device=DEVICE))]
        if i < 4:
            routes.append(("lookahead/balanced/r2", SpecDFAEngine(
                search[name], num_chunks=P14, mode="lookahead",
                partition="balanced", weights=weights, lookahead_r=2,
                matcher=ops.spec_match, device=DEVICE)))
        check_dfa("[14b]", name, search[name], doc, routes, SMALL14, walls)
    n = launched["[14b]"]
    check(n["spec_match"] > 0, f"(b) launched no B6 kernel: {n}")
    report("[14b]", walls)
    print(f"[14b] launches {n}; weights {weights[0]:.4f} x "
          f"{int((weights == weights[0]).sum())}, {weights[-1]:.4f} x "
          f"{int((weights == weights[-1]).sum())}")

    # -- (c) the large search DFAs: lookahead, uniform, P = 40 ----------------
    walls = {}
    doc = data[:SMALL14]
    engines = []
    for name in big:
        eng = SpecDFAEngine(search[name], num_chunks=P14, mode="lookahead",
                            partition="uniform", matcher=ops.spec_match,
                            device=DEVICE)
        check_dfa("[14c]", name, search[name], doc,
                  [("lookahead/uniform", eng)], HEAD14C, walls)
        engines.append((name, eng))
    n = launched["[14c]"]
    check(n["spec_match"] > 0, f"(c) launched no B6 kernel: {n}")
    report("[14c]", walls)
    print(f"[14c] launches {n}")
    # each DFA above ran its main path once, cold: a warm repeat beside it
    warm = {name: timed(eng.membership, doc)[1] for name, eng in engines}
    print(f"[14c] warm repeat: {sum(warm.values()):.4f} s over "
          f"{len(doc) * len(warm)} bytes ("
          + ", ".join(f"{k} {w * 1e3:.2f} ms" for k, w in warm.items()) + ")")

    # -- (d) basic and holub: the Fig. 10/11 regimes -------------------------
    walls = {}
    pcre_doc = np.frombuffer(make_docs(rng, [SMALL14])[0], np.uint8)
    cases = ([(k, d, pcre_doc) for k, d in pcre.items()]
             + [(k, d, data[:SMALL14]) for k, d in members.items()]
             + [(f"random Q={q}", random_dfa(q, 16, rng=rng, with_sink=False),
                 rng.integers(0, 256, size=SMALL14, dtype=np.uint8))
                for q in RANDOM14])
    name, dfa, doc = cases[-2]
    eng = SpecDFAEngine(dfa, num_chunks=P14, mode="holub",
                        matcher=ops.spec_match, device=DEVICE)
    eng.membership(doc)
    device_busy(lambda: eng.membership(doc), f"[14d] holub {name}",
                PROFILE_MARGIN_S)
    for name, dfa, doc in cases:
        routes = [(f"{mode}/{part}", SpecDFAEngine(
            dfa, num_chunks=P14, mode=mode, partition=part,
            weights=weights if part == "balanced" else None,
            matcher=ops.spec_match, device=DEVICE))
            for mode, part in (("lookahead", "uniform"), ("basic", "uniform"),
                               ("basic", "balanced"), ("holub", "uniform"))]
        check_dfa("[14d]", name, dfa, doc, routes, SMALL14, walls)
    n = launched["[14d]"]
    check(n["onehot_block_maps"] > 0 and n["lvec_compose"] > 0,
          f"(d) launched no B8 or no B7 kernel: {n}")
    report("[14d]", walls)
    print(f"[14d] launches {n}")
    print(f"[14] launches of B6/B7/B8 by the main-path calls of (a)-(d): "
          f"{ {k: counts[k] for k in names} }")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core import PCRE_PATTERNS, PatternSet
    from repro_torch.core.engine import (ENTRY_LANES, ENTRY_STARTS, LanePlan,
                                         LocalExecutor, Matcher)
    from repro_torch.core.engine.plan import DeviceTables
    from repro_torch.kernels import _build, dfa_match, lvec_compose, ops, ref
    from repro_torch.streaming import (OooPolicy, OooStreamMatcher,
                                       merge_calls)

    rng = np.random.default_rng(SEED)
    dev_name = torch.cuda.get_device_name(0)
    # float32 products in full float32 (no TF32), as the references assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {dev_name}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[1] built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for stem, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {stem}: {line.strip()}")

    ps = PatternSet(PCRE_PATTERNS, k_blk=64)
    packed = ps.blocks[0]

    # -- phase 2: kernels against their plain versions, PCRE-14 shapes -------
    b, c, lc = B, C, LC
    width = c * lc
    docs2 = (make_docs(rng, [width] * (b // 2), dense=True)
             + make_docs(rng, [width] * (b // 2)))
    buf = np.stack([np.frombuffer(d, np.uint8) for d in docs2])
    lens = np.full(b, width, np.int32)
    max_err, main_inputs = 0, {}
    for r in (1, 2):
        dt = DeviceTables.build(packed, lookahead_r=r, device=DEVICE)
        ex = LocalExecutor(dt, num_chunks=c, use_kernel=True)
        keys = rng.integers(0, dt.n_keys, size=b).astype(np.int32)
        for lanes in (False, True):
            plan = LanePlan("spec", width, lc,
                            ENTRY_LANES if lanes else ENTRY_STARTS, spec_r=r)
            body, la, init = ex._spec_stages(
                plan, torch.from_numpy(buf).to(DEVICE),
                torch.from_numpy(lens).to(DEVICE), None,
                torch.from_numpy(keys).to(DEVICE) if lanes else None)
            args = (dt.table_pad_t, body, init, la, dt.cidx_pad_t,
                    dt.sinks_t, dt.absorbing_t)
            name = "spec_match_merge_lanes" if lanes else "spec_match_merge"
            fn = ops.spec_match_merge_lanes if lanes else ops.spec_match_merge
            plain = (dfa_match.spec_match_merge_lanes_torch if lanes
                     else dfa_match.spec_match_merge_torch)
            for early in (True, False):
                kw = dict(pad_key=dt.pad_key, l_blk=512, early_exit=early)
                want, wskip = plain(*args, **kw)
                plain_ms = cuda_ms(lambda: plain(*args, **kw), 1)
                for smem, carry in ((True, True), (False, True),
                                    (True, False), (False, False)):
                    call = lambda: fn(*args, pad_cls=dt.pad_cls,
                                      pad_key=dt.pad_key, early_exit=early,
                                      l_blk=512, table_in_smem=smem,
                                      carry_in_smem=carry)
                    got, skip, _ = call()
                    torch.cuda.synchronize()
                    err = int((got.reshape(b, -1).long()
                               - want.reshape(b, -1).long()).abs().max())
                    max_err = max(max_err, err)
                    check(err == 0 and torch.equal(skip, wskip),
                          f"{name} r={r} table_in_smem={smem} "
                          f"carry_in_smem={carry} early={early}: kernel "
                          "differs from its plain version")
                    for _ in range(2):
                        call()
                    ms = cuda_ms(call, 10)
                    print(f"[2] {name:24s} r={r} S={dt.i_max} "
                          f"table={'smem' if smem else 'global'} "
                          f"carry={'smem' if carry else 'global'} "
                          f"early_exit={early!s:5s} kernel {ms:.4f} ms  "
                          f"plain {plain_ms:.2f} ms  skipped blocks "
                          f"{int(skip.sum())}  equal")
                    if r == 2 and smem and carry and early:
                        main_inputs[name] = (args, skip, ms, plain_ms)
    print(f"[2] kernels equal their plain versions (max |err| {max_err})")

    # -- phase 3: the main path at full width ---------------------------------
    lengths = rng.integers(DOC_BYTES[0], DOC_BYTES[1] + 1, size=N_DOCS)
    docs = make_docs(rng, lengths)
    m = Matcher(ps, num_chunks=8, batch_tile=64, device=DEVICE)
    ml = Matcher(ps, num_chunks=8, batch_tile=64, backend="local",
                 device=DEVICE)
    dfa_match.reset_launches()
    t0 = time.perf_counter()
    res = m.membership_batch(docs)
    dt_main = time.perf_counter() - t0
    b1_launches = dfa_match.launches["spec_match_merge"]
    check(b1_launches > 0, "membership_batch launched no B1 kernel")
    n_bytes = int(lengths.sum())
    print(f"[3] membership_batch: {len(docs)} docs, {n_bytes} bytes in "
          f"{dt_main:.3f} s: {len(docs) / dt_main:.1f} docs/s, "
          f"{n_bytes / dt_main / 1e6:.1f} MB/s; {res.bucket_calls} tiles, "
          f"B1 launches {b1_launches}, accepted "
          f"{int(res.accepted.sum())}/{res.accepted.size}")
    res_l = ml.membership_batch(docs)
    check(np.array_equal(res.final_states, res_l.final_states),
          "cuda backend differs from the local backend")
    check(res.final_states.shape == (N_DOCS, packed.n_patterns)
          and (res.final_states >= 0).all()
          and (res.final_states < packed.n_states).all(),
          "finals out of range")
    small = make_docs(rng, rng.integers(1, 4097, size=16), plant_p=0.5)
    got_small = m.membership_batch(small).final_states
    want_small = np.stack([packed.run_all(d) for d in small])
    check(np.array_equal(got_small, want_small),
          "membership_batch differs from the sequential oracle")
    kinds = set(m.perf_report()["lowerings"].values())
    check(kinds <= {"spec-kernel", "seq-torch"} and "spec-kernel" in kinds,
          f"unexpected lowerings {kinds}")
    print(f"[3] equal to backend='local' and to the sequential oracle; "
          f"lowerings {sorted(kinds)}")
    profile_main_path(m, docs, n_bytes)

    # -- phase 4: advance_segments ---------------------------------------------
    cuts = [len(d) // 2 + int(rng.integers(-999, 1000)) for d in docs]
    heads = [d[:k] for d, k in zip(docs, cuts)]
    tails = [d[k:] for d, k in zip(docs, cuts)]
    entry = np.tile(packed.starts, (len(docs), 1))
    h = m.advance_segments(heads, entry)
    t_ = m.advance_segments(tails, h.final_states)
    check(np.array_equal(t_.final_states, res.final_states),
          "advance_segments differs from whole-document matching")
    print(f"[4] advance_segments: halves compose to the whole-document "
          f"finals ({h.bucket_calls + t_.bucket_calls} tiles)")

    # -- phase 5: advance_cursors (B2) -----------------------------------------
    s = m.dev.i_max
    keys = np.array([m.dev.advance_key(-1, hd) for hd in heads], np.int32)
    keep = keys >= 0  # heads of fewer than r bytes have no boundary key
    lanes = np.repeat(h.final_states[keep][:, :, None], s, axis=2)
    segs = [tl for tl, k in zip(tails, keep) if k]
    dfa_match.reset_launches()
    cur = m.advance_cursors(segs, lanes, keys[keep])
    b2_launches = dfa_match.launches["spec_match_merge_lanes"]
    check(b2_launches > 0, "advance_cursors launched no B2 kernel")
    want = np.repeat(res.final_states[keep][:, :, None], s, axis=2)
    check(np.array_equal(cur.lane_states, want),
          "advance_cursors differs from whole-document matching")
    cur_l = ml.advance_cursors(segs, lanes, keys[keep])
    check(np.array_equal(cur.lane_states, cur_l.lane_states),
          "advance_cursors differs from the local backend")
    print(f"[5] advance_cursors: {int(keep.sum())} cursors, every lane equals "
          f"the whole-document finals; B2 launches {b2_launches}")

    # -- phase 6: the in-kernel early exit -------------------------------------
    one = PatternSet({"repeat_ab": PCRE_PATTERNS["repeat_ab"]})
    m1 = Matcher(one, num_chunks=8, batch_tile=64, device=DEVICE)
    m1.executor.spec_l_blk[0] = 64
    # documents that fill all 8 chunks (a chunk of pure padding keeps its
    # pad-key lanes live, so it would pin its document to the full scan)
    hits = [(b"xy abab ba " * 1500)[:16384], (b"(abab)" * 2700)[:16000],
            b"." * 16384]
    r1 = m1.membership_batch(hits)
    skipped = m1.executor.kernel_skipped_steps()
    r1l = Matcher(one, num_chunks=8, batch_tile=64, backend="local",
                  device=DEVICE).membership_batch(hits)
    check(skipped > 0, "the in-kernel early exit skipped no block")
    check(np.array_equal(r1.final_states, r1l.final_states),
          "early-exit finals differ from the local backend")
    print(f"[6] early exit: {skipped} symbol blocks skipped, "
          f"{r1.early_exits} docs exited early, finals equal")

    # -- phase 7: the bounds of B1 and B2 ------------------------------------
    kernels = {}
    for name, line in (("spec_match_merge", 159),
                       ("spec_match_merge_lanes", 218)):
        args, skip, ms, plain_ms = main_inputs[name]
        table, _, init, la, cidx, sinks, absorbing = args
        n_out = init.shape[-1] if name.endswith("lanes") else packed.n_patterns
        scanned = 512 * int((lc // 512 - skip.long()).sum())  # symbols/chunk
        # bytes the kernel must move: the symbols of the blocks it scanned,
        # every other input once (cand_index: at most one entry per fold
        # step), the outputs once
        n_bytes = 4 * (c * scanned + init.numel() + la.numel()
                       + table.numel() + sinks.numel() + absorbing.numel()
                       + min(cidx.numel(), b * n_out * (c - 1))
                       + b * n_out + b)
        lane_steps = init.shape[1] * init.shape[2] * scanned
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = lane_steps / SMEM_LOADS_PER_S * 1e3
        kernels[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/dfa_match.cu",
            replaces=f"src/repro/kernels/dfa_match.py:{line}",
            launches=None, max_abs_err=max_err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        print(f"[7] {name}: {lane_steps / (ms * 1e-3) / 1e12:.3f} T "
              f"lane-steps/s; bound {max(t_bytes, t_ops):.4f} ms (bytes "
              f"{t_bytes:.4f} ms; operations {t_ops:.4f} ms: one "
              f"shared-memory load per lane-step at "
              f"{SMEM_LOADS_PER_S / 1e12:.3f} T/s)")

    # -- phase 8: B3/B4 against their plain versions, real lane maps ---------
    mg = Matcher(ps, num_chunks=8, batch_tile=1024, device=DEVICE)
    dt = mg.dev
    check(dt.spec_r == 2, f"PCRE-14 resolved r={dt.spec_r}, expected 2")
    cidx, sinks = dt.cidx_pad_t, dt.sinks_t
    k, s = packed.n_patterns, dt.i_max
    err8 = 0
    for nb, nn in RUNS8:
        maps, keys = lane_runs(mg, rng, nb, nn, SEG8)
        lanes = torch.from_numpy(maps).to(DEVICE)
        kt = torch.from_numpy(keys).to(DEVICE)
        args8 = (lanes, kt, cidx, sinks)
        kw = dict(pad_key=dt.pad_key)
        oracle = ref.spec_compose_lanes_ref(maps, keys, cidx.cpu().numpy(),
                                            packed.sinks, pad_cls=dt.pad_key)
        mask = real_lane_mask(dt.tables, keys[:, 0])
        placements = [("carry", lvec_compose.spec_compose_lanes_cuda,
                       lvec_compose.spec_compose_lanes_torch, {})]
        for smem in (True, False):
            if lvec_compose.tree_in_smem(nn, k, s) or not smem:
                placements.append((
                    f"tree/{'smem' if smem else 'global'}",
                    lvec_compose.spec_compose_lanes_tree_cuda,
                    lvec_compose.spec_compose_lanes_tree_torch,
                    dict(in_smem=smem)))
        # bytes the function must move: the real maps and the keys once, the
        # outputs once, at most one cand_index entry per lane-combine; the
        # work: two dependent loads (cand_index, then the map) per combine
        real = int((keys[:, 1:] != dt.pad_key).sum())
        combines = real * k * s
        n_bytes = 4 * ((nb + real) * k * s + keys.size + nb * k * s
                       + min(cidx.numel(), combines))
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * combines / SMEM_LOADS_PER_S * 1e3
        bound = dict(bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
        for mode, kern, plain, extra in placements:
            want = plain(*args8, **kw)
            plain_ms = cuda_ms(lambda: plain(*args8, **kw), 1)
            call = lambda: kern(*args8, **kw, **extra)
            got = call()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            err8 = max(err8, err)
            check(err == 0, f"{mode} compose B={nb} N={nn}: kernel differs "
                  "from its plain version")
            g = got.cpu().numpy()
            check(np.array_equal(np.where(mask, g, -1),
                                 np.where(mask, oracle, -1)),
                  f"{mode} compose B={nb} N={nn}: real lanes differ from "
                  "the sequential oracle")
            if mode == "carry":
                check(np.array_equal(g, oracle),
                      f"carry compose B={nb} N={nn} differs from the oracle")
            for _ in range(2):
                call()
            ms = cuda_ms(call, 20)
            print(f"[8] compose {mode:11s} B={nb} N={nn} ({real} real "
                  f"combines) kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
                  f"bytes {t_bytes:.4f}, operations {t_ops:.4f})  equal")
            if (nb, nn) == RUNS8[0] and mode in ("carry", "tree/smem"):
                name = ("spec_compose_lanes" if mode == "carry"
                        else "spec_compose_lanes_tree")
                kernels[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/lvec_compose.cu",
                    replaces="src/repro/kernels/lvec_compose.py:"
                             f"{95 if mode == 'carry' else 171}",
                    launches=None, max_abs_err=None, ms=ms, plain_ms=plain_ms,
                    **bound, library_ms=None)
    for name in ("spec_compose_lanes", "spec_compose_lanes_tree"):
        kernels[name]["max_abs_err"] = err8
    print(f"[8] compose kernels equal their plain versions (max |err| "
          f"{err8}); the tree equals the oracle on real lanes")

    # -- phase 9: the out-of-order path at full width -------------------------
    docs9 = make_docs(rng, [DOC9] * STREAMS9)
    seg9 = DOC9 // SEGS9
    want9 = m.membership_batch(docs9).final_states
    m9 = Matcher(ps, num_chunks=8, device=DEVICE)
    policy = OooPolicy(match_batch=STREAMS9)
    merges = merge_calls()
    counts = {}

    def ooo_run(matcher, plans, tag):
        ooo = OooStreamMatcher(matcher, policy=policy)
        dfa_match.reset_launches()
        lvec_compose.reset_launches()
        res = run_streams(ooo, docs9, plans, seg9)
        launched = {**dfa_match.launches, **lvec_compose.launches}
        got = np.stack([r.final_states for r in res])
        check(np.array_equal(got, want9), f"{tag}: stream decisions differ "
              "from whole-document membership_batch")
        check(all(r.byte_count == DOC9 for r in res), f"{tag}: byte counts")
        check(merge_calls() == merges, f"{tag}: host-side merges")
        return ooo.stats, launched

    def timed_run(matcher, plans, tag):
        ooo = OooStreamMatcher(matcher, policy=policy)
        t0 = time.perf_counter()
        run_streams(ooo, docs9, plans, seg9)
        wall = time.perf_counter() - t0
        n_segs = STREAMS9 * SEGS9
        print(f"{tag} timed run: {wall:.3f} s: {n_segs / wall:.1f} "
              f"segments/s, {STREAMS9 * DOC9 / wall / 1e6:.1f} MB/s")
        device_busy(lambda: run_streams(OooStreamMatcher(
            matcher, policy=policy), docs9, plans, seg9), tag)

    for frac in FRACS9:
        tag = f"[9] shuffle {frac:g}:"
        plans = arrival_plans(np.random.default_rng(41), STREAMS9, SEGS9,
                              frac)
        st, launched = ooo_run(m9, plans, tag)
        print(f"{tag} {STREAMS9} streams equal whole-document matching; "
              f"scan_folds {st.scan_folds}, scan_batch {st.scan_batch:.2f}, "
              f"gap_closes {st.gap_closes}, peak_buffered_segments "
              f"{st.peak_buffered_segments}, spec_matched {st.spec_matched}, "
              f"launches {launched}")
        if frac == 0.0:
            check(st.spec_matched == 0 and st.scan_folds == 0
                  and launched["spec_compose_lanes"] == 0,
                  "in-order streams parked or composed")
        else:
            check(launched["spec_compose_lanes"] > 0,
                  f"{tag} launched no B3 kernel")
        timed_run(m9, plans, tag)
        if frac == 1.0:
            counts = launched
            check(all(counts[n] > 0 for n in ("spec_match_merge",
                                              "spec_match_merge_lanes")),
                  f"{tag} did not launch B1 and B2: {counts}")
    check(m9.perf_report()["compose_lowering"] == "compose-kernel-carry",
          f"compose lowering {m9.perf_report()['compose_lowering']}")
    plans = arrival_plans(np.random.default_rng(41), STREAMS9, SEGS9, 1.0)
    mt = Matcher(ps, num_chunks=8, device=DEVICE)
    mt.executor.compose_mode = "tree"
    st, launched = ooo_run(mt, plans, "[9] tree compose, shuffle 1:")
    check(launched["spec_compose_lanes_tree"] > 0
          and launched["spec_compose_lanes"] == 0
          and mt.perf_report()["compose_lowering"] == "compose-kernel-tree",
          f"the tree run did not ride B4: {launched}")
    counts["spec_compose_lanes_tree"] = launched["spec_compose_lanes_tree"]
    print(f"[9] tree compose, shuffle 1: equal; scan_folds {st.scan_folds}, "
          f"B4 launches {launched['spec_compose_lanes_tree']}")
    plans = arrival_plans(np.random.default_rng(41), STREAMS9, SEGS9, 0.25)
    ml9 = Matcher(ps, num_chunks=8, backend="local", device=DEVICE)
    st, launched = ooo_run(ml9, plans, "[9] backend='local', shuffle 0.25:")
    check(sum(launched.values()) == 0
          and ml9.perf_report()["compose_lowering"] == "compose-scan",
          f"backend='local' launched kernels: {launched}")
    print(f"[9] backend='local', shuffle 0.25: decisions equal; scan_folds "
          f"{st.scan_folds}")
    # the default OooStreamMatcher (num_chunks=1) rides the seq lowering, a
    # per-symbol torch loop: timed once at a small size beside num_chunks=8
    small = docs9[:SMALL9[0]]
    small = [d[:SMALL9[1]] for d in small]
    plans = arrival_plans(np.random.default_rng(41), len(small), SEGS9, 1.0)
    for nc in (1, 8):
        mc = Matcher(ps, num_chunks=nc, device=DEVICE)
        ooo = OooStreamMatcher(mc, policy=policy)
        t0 = time.perf_counter()
        res = run_streams(ooo, small, plans, SMALL9[1] // SEGS9)
        wall = time.perf_counter() - t0
        check(np.array_equal(np.stack([r.final_states for r in res]),
                             m.membership_batch(small).final_states),
              f"num_chunks={nc}: decisions differ")
        print(f"[9] num_chunks={nc}: {len(small)} streams x {SMALL9[1]} "
              f"bytes, shuffle 1: {wall:.3f} s, "
              f"{len(small) * SMALL9[1] / wall / 1e6:.2f} MB/s; lowerings "
              f"{sorted(set(mc.perf_report()['lowerings'].values()))}")

    # -- phases 10-12: the serving kernels and the serving path ---------------
    from repro_torch.configs import get_config
    from repro_torch.core import compile_regex
    from repro_torch.serving import GrammarConstraint

    gc10 = GrammarConstraint(compile_regex(GRAMMAR12),
                             get_config(ARCH12).padded_vocab, eos_id=None,
                             device=DEVICE)
    phase10_token_mask(gc10, rng, kernels)
    phase11_flash_attn(kernels)
    phase12_serving(rng, counts)

    # -- phases 13-14: the paper engine's kernels and the paper engine --------
    from repro_torch.core import compile_pattern_suite
    t0 = time.perf_counter()
    search = compile_pattern_suite("prosite", search=True)
    print(f"[13] compiled the {len(search)} PROSITE search DFAs in "
          f"{time.perf_counter() - t0:.2f} s")
    phase13_paper_kernels(rng, kernels, search)
    phase14_paper_engine(rng, counts, search)
    for name in kernels:
        kernels[name]["launches"] = counts[name]

    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
