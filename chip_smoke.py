#!/usr/bin/env python3
"""Drive the PyTorch port of the matcher on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any mismatch raises, so the exit code is non-zero):
  1. print the card (nvidia-smi name and power limit), build every CUDA
     kernel from ``src/repro_torch/kernels/csrc`` and print the build time
     and the registers and spills of each instance of ``flash_attn``,
     ``onehot_match``, ``dfa_match`` and ``lvec_compose``;
  2. hold kernels B1 (``spec_match_merge``) and B2 (``spec_match_merge_lanes``)
     against their plain PyTorch versions at the PCRE-14 shapes (B=64, C=8,
     L=8192): table and lane carry each in shared or global memory, early
     exit on and off, r=1 and r=2 — bit for bit — and time both; print
     their cluster launch (CTAs per document, lanes per thread);
  3. the main path: ``Matcher(PCRE-14).membership_batch`` over 256 ragged
     documents of 32-64 KiB, against ``backend="local"`` on the same card and
     the host sequential oracle on small documents;
  4. ``advance_segments`` over each document split in two;
  5. ``advance_cursors`` (B2) over the second halves;
  6. the in-kernel early exit on a K=1 matcher with documents full of hits;
  7. the bounds of B1 and B2;
  8. hold kernels B3 (``spec_compose_lanes``, the carry fold) and B4
     (``spec_compose_lanes_tree``) against their plain versions on real
     PCRE-14 lane maps (r=2, ragged runs) at the (B, N) of three of phase
     9's calls, B=1024 runs of N=32 and B=8 runs of N=2048 (the tree split
     past one cluster) — bit for bit, the tree also against the sequential
     oracle on real lanes — and time them per call and on the device, with
     each plan (B3: runs a CTA, elements a ring tile; B4: segments,
     clusters, runs a CTA, row slots); both wide instances (an element or a
     unit past shared memory) on random operands at PS00028's Q = 43,125 and
     S = 22,857;
  9. the out-of-order path: ``OooStreamMatcher`` over 1024 streams of
     64 KiB in 16 segments at shuffle fractions 0, 0.25 and 1 (and 1 again
     on the tree compose, 0.25 again on ``backend="local"``), every stream's
     decision against whole-document ``membership_batch``, zero host merges,
     the (B, N) of each B3 call, throughput and the device idle share; the
     default ``num_chunks=1`` matcher timed beside ``num_chunks=8`` on 64
     streams of 16 KiB;
 10. hold kernel B5 (``token_mask``) against its plain version bit for bit:
     B=8, V=32,000 bf16 with the phase-12 grammar's mask table, and B=128,
     V=128,256 (the llama3 vocabulary) in bf16 and f32; time it beside the
     plain version and the two-call ``torch.where`` gather-and-select;
 11. hold kernel B9 (``flash_attn``) against its plain version within
     atol = rtol = 3e-2, max |err| <= 1e-2 and RMS error <= 1e-3 of the
     plain output's RMS, at the tinyllama prefill shape (128 query heads over
     16 kv heads, T = S = 2,048, D = 64, causal), at D = 128 and with a
     window of 512; time it beside the plain version and
     ``scaled_dot_product_attention`` and print its share of its bound and
     its ratio to that call;
 12. the serving path at full tinyllama-1.1b width, random weights from a
     seeded generator on the card: ``api.prefill`` at B=4, T=2,048 (B9 once
     per layer) against the same call on the blockwise attention path;
     ``ServingEngine.generate`` for 8 grammar-constrained prompts of 512
     bytes, 32 new tokens, greedy, no EOS (every row runs all 32 decode
     steps, B5 once per step): every row a
     live prefix of the grammar, the tokens equal to a run without the
     kernel and to a run from a chunked ``DecodeStream`` prefill, wall time,
     tokens/s and the device idle share; then ``swap_grammar`` to a second
     grammar (a signature-equal one first: a no-op) and ``generate`` again:
     every row a live prefix of the new grammar, B5 once per step, tokens
     equal to an engine built fresh with it; then ``launch.serve`` once;
 13. hold kernels B6 (``spec_match``), B7 (``lvec_compose``) and B8
     (``onehot_block_maps``) against their plain versions bit for bit and
     time them: B6 at the holub shape (Q = 256, 16 classes, C = 40,
     S = 256, L = 26,214), at the lookahead shape of phase 14(a) (C = 4,096,
     S = I_max, L = 16,384) for PS00010 and for EF-hand (16 classes), with
     one chunk and one lane over 4 Mi symbols (the sequential matcher; held
     against its plain version over 4,096 sub-chunks x every state, folded
     by B7's), with the PS00028 search table in
     global memory and at a prime L and C through ``ops.spec_match``; B7 on
     one composition of 4,096 maps, on (d)'s [40, 103, 256] and
     [40, 103, 16], on (a)'s product-route shape [4,096, 64, Q] for
     EF-hand and on 256 maps of PS00028's 43,125 states (the wide instance),
     per call and on the device, with its segment and cluster plan; B8 at Q = 16, 64, 128, 256 (Q = 257 refused) with
     its share of its bound; and
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
     also the torch gather loop's (``match_chunks_lanes``) and the host
     oracle ``dfa.run``'s;
     the decision equals ``Matcher.membership_batch``'s; wall time and
     bytes/s per route, ``profile_capacity`` on the card, the device idle
     share of one call of (a) and of (d), a warm repeat of (c), and the
     launches of B6, B7 and B8 inside each route's own ``membership`` call
     (each must launch the kernels ``mxu_profitable`` routes it to);
 15. hot swap and the pattern-set scale tier over phase 3's corpus: (a)
     ``Matcher(PCRE-14).swap_patterns`` to an equal set (False, lowerings
     kept), to PCRE-14 with two patterns replaced (planted in a quarter of
     the documents), to the 3 large PROSITE search DFAs (table in global
     memory; the first MiB) and back — each step bit for bit equal to a
     fresh matcher (the first also to ``backend="local"``), with the swap,
     the first (re-lowering) call and a warm call timed; (b)
     ``BlockedMatcher`` over literal patterns, K = 16, 128, 512, 2,048 in
     blocks of 32, prefilter on and off (bytes/s, gated equal to ungated,
     the skipped blocks the plants imply), K = 2,048 against
     ``backend="local"`` and an unblocked K = 32 pack, K = 256 in 8 blocks
     against one pack, the device idle share of a profiled K = 2,048 call,
     then block swaps (one pattern of block 5: only it re-lowers; a block
     appended; the last dropped), each equal to a fresh ``BlockedMatcher``;
     (c) ``BlockedStreamMatcher`` at K = 256 over 256 streams fed in two
     halves with block 3 swapped between them (unchanged blocks' cursors
     bit-identical and equal whole-document matching, block 3 equal to the
     new set over the second halves), and ``StreamMatcher(lane_ticks=True)``
     refusing a swap while ``open_at`` sessions live (B2 ticks them) and
     accepting it after ``close_map``;
 16. stream failover, every comparison bit for bit, each part in a
     temporary directory it removes: (a) ``StreamMatcher(PCRE-14,
     lane_ticks=True)`` over phase 3's documents, 192 exact and 64
     candidate-keyed (``open_at`` after 4 KiB) sessions fed in four ragged
     parts, snapshot after the second with a third still pending, restored
     on the card on ``backend="cuda"`` (B1, B2) and ``"local"`` and on the
     CPU, each equal to the uninterrupted run and to ``membership_batch``
     (``close``, ``close_map``, byte counts, ``segments_fed``), the first
     tick after a restore timed beside the uninterrupted run's; a crashed
     writer's ``.tmp`` step, a foreign set and a colliding session refused;
     (b) ``OooStreamMatcher`` at phase 9's scale, odd segments first (a
     quarter with ``prev_tail``: parked maps and raw payloads), snapshot
     after ``flush``, restored on the carry (B3) and tree (B4) compose, the
     ``backend="local"`` snapshot against the kernels' key by key and
     restored too, MB/s beside phase 9's at f = 0.25; (c)
     ``BlockedStreamMatcher`` at K = 256 fed in halves, snapshot between
     them, restored fresh; a swapped block 5 and the prefilter off refused;
     (d) ``CheckpointManager(use_async=True, keep=2)`` of tinyllama's
     embedding and first two layers on the card in f32 and bf16, updated in
     place right after ``submit``, restored equal to the values before the
     update, then ``launch.serve --stream --snapshot-dir`` (B5 a decode
     step) and a fresh ``open_decode`` restored from its last round;
 17. autotuning and the corpus-filter data path: (a) ``Matcher(PCRE-14,
     autotune=True)`` with ``$REPRO_AUTOTUNE_CACHE`` in a temporary
     directory: the cold-start tune's wall time, every candidate's score
     and the block and B1 ring tile it resolves to, the ``TunedShape``, a
     second tune read from the in-process cache and a third from disk; then
     phase 3's documents as observed traffic, ``maybe_retune()`` (the
     kernel lowerings of the old block dropped), B1 after it, finals equal
     before and after, an untuned matcher's and ``backend="local"``'s, and
     the warm call before and after; (b) ``CorpusFilter`` with 7 secret and
     PII rules over 8,192 generated documents of 2,048 bytes: ``filter()``
     at batch sizes 64 and 1,024, ``data_stream`` into packed batches,
     ``scan_stream`` over 256 concurrent downloads in 1,024-byte chunks and
     ``document_ok`` over 256 documents (B6, or B8 + B7), each keep-mask
     equal to Python's ``re``, ``backend="local"`` on the card with equal
     ``FilterStats``, docs/s and MB/s of each, the launches of each and the
     device idle share of one ``filter()`` pass; (c) the rules and 15(b)'s
     literals up to K = 512 in blocks of 32, prefilter on and off, over
     2,048 documents with planted literals, equal to ``re``;
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
CALLS8 = ((959, 16), (205, 16), (21, 4))   # phase 9's B3/B4 calls (B, N)
WIDE8 = (4, 8, 43_125, 1, 22_857, 22)   # B3 past the ring: B, N, Q, K, S, keys
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
GRAMMAR12B = r"[a-z]{1,8}(, [a-z]{1,8})*"   # the grammar phase 12 swaps to
HOLUB13 = (256, 16, 40, 26_214)      # phase 13 B6/B8: Q, classes, C, L
LOOK13 = ("PS00010_ASX_HYDROXYL", 4096, 16_384)  # B6 at 14(a)'s shape: C, L
LOOK13B = ("PS00018_EF_HAND_1", 4096, 16_384)    # B6, 16 classes: C, L
SINGLE13 = (64, 16, 4 << 20)         # B6, one chunk, one lane: Q, classes, L
BIG13 = ("PS00028_ZINC_FINGER_C2H2", 40, 4096)  # B6, global table: C, L
PRIME13 = (17, 5, 37, 10_007, 9)     # ops.spec_match: Q, classes, C, L, S
COMPOSE13 = ((1, 4096, 256), (40, 103, 256), (40, 103, 16),
             (4096, 64, LOOK13B[0]),
             (1, 256, BIG13[0]))      # B7: B, N, Q (or the DFA of Q)
ONEHOT13 = (16, 64, 128, 256)        # B8 and the route crossover: Q
SCAN14, BAL14, SMALL14 = 64 << 20, 8 << 20, 1 << 20   # 14(a), (b), (c)/(d)
HEAD14C = 64 << 10                   # 14(c): bytes of the cross-checks
P14A, P14 = 4096, 40                 # processors of 14(a) and of (b)-(d)
RANDOM14 = (16, 64, 128, 256)        # 14(d) random DFAs: Q (16 classes)
PROFILE14A = LOOK13[0]               # 14(a)'s profiled call (the B6 route)
PROFILE_MARGIN_S = 2.0               # idle seconds around phase 14's profiles
KW15 = dict(num_chunks=8, batch_tile=64, lookahead_r=1)  # phase 15 matchers
BIG15 = ("PS00028_ZINC_FINGER_C2H2", "PS00029_LEUCINE_ZIPPER",
         "PS00027_HOMEOBOX_1")       # 15(a): the 3 large search DFAs
HEAD15 = 1 << 20                     # 15(a): bytes of the large set's corpus
SWAP15 = {0: "zz[0-9]+zz", 9: "(qu)+x"}   # 15(a): PCRE-14 patterns replaced
PLANT15 = (b"zz123zz", b"ququx")     # ... and what they match
KSWEEP15, KBLK15 = (16, 128, 512, 2048), 32   # 15(b): K sweep, block size
K15C = 256                           # 15(c): streamed pattern count
DATE15 = r"[0-9]{4}-[0-9]{2}-[0-9]{2}"    # 15(b)/(c): a swapped-in pattern
KEYED16, HEAD16 = 64, 4096            # 16(a): open_at sessions, bytes before
CHUNK16 = 4                          # 16(d): serve --chunk-bytes
PROMPTS16 = ("12. 345, 6789. 1", "7, 891. 2345, 67", "31. 4, 15. 92, 6",
             "65, 358. 979, 32")     # 16(d): serve --prompts, 16 bytes each
RULES17 = (r"SECRET-[0-9]+", r"key=[A-Za-z0-9]{8}",
           r"[a-z0-9._]+@[a-z0-9]+\.(com|org|net)",
           r"[0-9]{3}-[0-9]{2}-[0-9]{4}", r"-----BEGIN [A-Z]+ PRIVATE KEY-----",
           r"(password|passwd)=[^ ]+",
           r"[0-9]{4} [0-9]{4} [0-9]{4} [0-9]{4}")   # 17: secret/PII rules
CORPUS17 = (8192, 2048)              # 17(b): documents, bytes each (16 MiB)
BATCH17 = (64, 1024)                 # 17(b): filter() batch sizes
LOADER17 = (8, 2048)                 # 17(b): data_stream batch, seq_len
STREAM17 = (256, 1024, 64, 8)        # 17(b): open downloads, chunk bytes,
                                     # max_batch, max_delay
DOCOK17 = 256                        # 17(b): document_ok documents
BLOCKED17 = (512, 32, 2048)          # 17(c): K, k_blk, documents
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


def device_share(dev_ms, bound):
    """"device time X ms, share of bound Y" (n/a where the profiler
    recorded none)."""
    if dev_ms is None:
        return "device time n/a"
    return f"device time {dev_ms:.4f} ms, share of bound {bound / dev_ms:.3f}"


def kernel_resources(log):
    """[(kernel, template arguments, registers, spill-store bytes)] of each
    kernel instance in an ``nvcc -Xptxas -v`` log; the arguments joined by
    '/'."""
    import re
    out, inst, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*?)I((?:L[a-z]+\d+E)+)E",
                      line)
        if m:   # the name is the length-prefixed component before the 'I'
            pre = m.group(1)
            name = next((pre[-n:] for n in range(1, len(pre))
                         if pre[:-n].endswith(str(n))), pre)
            inst = (name, "/".join(re.findall(r"L[a-z]+(\d+)E", m.group(2))))
        else:   # not a template: the name after the source's 8-digit hash
            m = re.search(r"Compiling entry function '_ZN\S*?_cu_[0-9a-f]{8}"
                          r"(\d+)(\w+)", line)
            if m:
                inst = (m.group(2)[:int(m.group(1))], "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and inst is not None:
            out.append((*inst, int(m.group(1)), spill))
            inst, spill = None, 0
    return out


def tree_how(plan):
    """A B4 plan (``lvec_compose.tree_plan``) in words."""
    if plan["wide"]:
        return "wide, the levels in global memory"
    return (f"{plan['segments']} segments of {plan['seg']} a run, clusters "
            f"of {plan['cluster']}, {plan['folds']} cluster partials (a "
            f"second launch when > 1), {plan['runs']} runs a CTA, "
            f"{plan['threads']} threads a unit ({plan['hp']} pair groups), "
            f"{plan['slots']} row slots")


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


def word_prompts(rng, b, t):
    """[b, t] byte prompts of ``GRAMMAR12B``'s words, cut at t: every row
    is a live prefix of that grammar."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    rows = []
    for _ in range(b):
        s = b""
        while len(s) < t:
            s += (b", " if s else b"") + rng.choice(
                letters, size=int(rng.integers(1, 9))).tobytes()
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
        print(f"[11]   share of bound {bound / ms:.3f}"
              + ("" if lib_ms is None else
                 f"; kernel / scaled_dot_product_attention "
                 f"{ms / lib_ms:.3f}"))
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
    for route in ("auto", "blockwise"):
        api.prefill(params, cfg, batch, attn_route=route)          # warm
        torch.cuda.synchronize()
        flash_attn.reset_launches()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, cfg, batch, attn_route=route)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[route] = (logits[:, -1].float(), wall,
                       flash_attn.launches["flash_attn"])
        del cache
    (lk, wk, nk), (lx, wx, nx) = runs["auto"], runs["blockwise"]
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
    # -- the grammar swap: the same engine, a new grammar, B5 on its table
    check(gc.swap_grammar(compile_regex(GRAMMAR12)) is False,
          "swap_grammar to a signature-equal grammar did not return False")
    dfa_b = compile_regex(GRAMMAR12B)
    t0 = time.perf_counter()
    swapped = gc.swap_grammar(dfa_b)
    swap_wall = time.perf_counter() - t0
    check(swapped and gc.matcher.planner.table_epoch == 1,
          "swap_grammar to a new grammar did not swap")
    # a generator of its own: later phases draw the data they drew before
    prompts_b = word_prompts(np.random.default_rng(SEED + 12), n, width)
    token_mask.reset_launches()
    t0 = time.perf_counter()
    out_b = eng.generate(prompts_b)
    wall_b = time.perf_counter() - t0
    launched_b = token_mask.launches["token_mask"]
    steps_b = decode_steps(out_b, eng.serve.eos_id)
    check(steps_b == max_new and launched_b == steps_b, f"generate after "
          f"the swap launched B5 {launched_b} times over {steps_b} steps")
    check(all(live_prefix(dfa_b, p, row, eng.serve.eos_id)
              for p, row in zip(prompts_b, out_b)),
          "a row generated after the swap leaves the new grammar")
    fresh = GrammarConstraint(dfa_b, cfg.padded_vocab, eos_id=None,
                              device=DEVICE)
    out_fresh = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=max_new), constraint=fresh).generate(prompts_b)
    check(np.array_equal(out_b, out_fresh), "generate after swap_grammar "
          "differs from an engine built fresh with the new grammar")
    print(f"[12] swap_grammar to {GRAMMAR12B!r}: {swap_wall * 1e3:.2f} ms "
          f"(a signature-equal grammar: no-op); generate {n} x {width} "
          f"bytes, {steps_b} steps in {wall_b:.4f} s, B5 launches "
          f"{launched_b}; every row a live prefix of the new grammar, tokens "
          f"equal a fresh engine's")
    for p, row in list(zip(prompts_b, out_b))[:2]:
        text = bytes(int(x) for x in row if x < 256).decode(errors="replace")
        print(f"[12]   ...{bytes(p[-24:].astype(np.uint8)).decode()!r} -> "
              f"{text!r}")
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

    def b6(tag, table, chunks_t, init, n_iter, row=False, split=0):
        """One B6 row.  ``split`` > 0 (one lane over millions of symbols,
        where the plain version would launch four small kernels a symbol)
        holds the kernel against the plain versions composed: plain B6 over
        ``split`` sub-chunks x every state, then plain B7 folding their
        maps, read at the lane's entry state -- the same function."""
        if split:
            q = table.shape[0]
            every = torch.arange(q, dtype=torch.int32, device=DEVICE)

            def plain_fn():
                maps = dfa_match.spec_match_torch(
                    table, chunks_t.reshape(split, -1).contiguous(),
                    every.expand(split, q).contiguous())
                full = lvec_compose.lvec_compose_torch(maps[None])[0]
                return full[init.long()]
            want = plain_fn()
            plain_ms = cuda_ms(plain_fn, 1)
            plain = (f"plain {plain_ms:.2f} ms (B6 over {split} sub-chunks x "
                     f"{q} states, then B7)")
        else:
            want = dfa_match.spec_match_torch(table, chunks_t, init)
            plain_ms = cuda_ms(lambda: dfa_match.spec_match_torch(
                table, chunks_t, init), 1)
            plain = f"plain {plain_ms:.2f} ms"
        got = dfa_match.spec_match_cuda(table, chunks_t, init)
        torch.cuda.synchronize()
        held("spec_match", got, want, f"spec_match {tag}")
        dfa_match.spec_match_cuda(table, chunks_t, init)
        ms = cuda_ms(lambda: dfa_match.spec_match_cuda(table, chunks_t, init),
                     n_iter)
        (cc, ll), ss = chunks_t.shape, init.shape[1]
        bound, by, steps = spec_bound(cc, ss, ll, *table.shape)
        sp = dfa_match.spec_launch_plan(cc, ss, ll, *table.shape)
        print(f"[13] spec_match {tag}: C={cc} S={ss} L={ll} Q={table.shape[0]}"
              f" classes={table.shape[1]} table "
              f"{'smem' if sp['table_in_smem'] else 'global'}: kernel "
              f"{ms:.4f} ms ({steps / ms / 1e9:.3f} T lane-steps/s, "
              f"{ms * 1e6 / ll:.2f} ns a symbol)  {plain}  bound "
              f"{bound:.5f} ms ({by}), share of bound {bound / ms:.3f}; "
              f"grid {sp['grid']} of {sp['c_blk']} chunks x {sp['s_blk']} "
              f"lanes, {dfa_match.LPT} lanes per thread, {sp['cons']} "
              f"consumer threads, ring tile {sp['tile']}  equal")
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
    name, cl, ll = LOOK13B
    look = search[name]
    s_look = build_lookahead_tables(look).i_max
    b6(f"lookahead shape ({name})", put(look.table),
       put(rng.integers(0, look.n_classes, size=(cl, ll))),
       put(rng.integers(0, look.n_states, size=(cl, s_look))), 3)
    qs, ns, ls = SINGLE13
    single = random_dfa(qs, ns, rng=rng)
    b6("single lane", put(single.table),
       put(rng.integers(0, ns, size=(1, ls))), put([[single.start]]), 3,
       split=4096)
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
        qq = qq if isinstance(qq, int) else search[qq].n_states
        maps = put(rng.integers(0, qq, size=(b, n, qq)))
        want = lvec_compose.lvec_compose_torch(maps)
        plain_ms = cuda_ms(lambda: lvec_compose.lvec_compose_torch(maps), 1)
        got = lvec_compose.lvec_compose_cuda(maps)
        torch.cuda.synchronize()
        held("lvec_compose", got, want, f"lvec_compose [{b}, {n}, {qq}]")
        ms = cuda_ms(lambda: lvec_compose.lvec_compose_cuda(maps), 20)
        dev_ms = kernel_device_ms(lambda: lvec_compose.lvec_compose_cuda(maps),
                                  "lvec_compose", 20)
        lp = lvec_compose.lvec_plan(b, n, qq)
        if dev_ms is not None and lp["folds"] > 1:
            # a call past one cluster (or one wide segment) launches twice;
            # the mean launch of a call, times two, does not undercount a
            # call whose device records the profiler dropped
            dev_ms *= 2
        loads = b * n * qq
        t_ops = loads / SMEM_LOADS_PER_S * 1e3
        t_bytes = 4 * (b * n * qq + b * qq) / HBM_BYTES_PER_S * 1e3
        bound, by = max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                          else "operations")
        print(f"[13] lvec_compose [{b}, {n}, {qq}]: kernel {ms:.4f} ms per "
              f"call ({loads / ms / 1e6:.3f} G map-steps/s; "
              f"{device_share(dev_ms, bound)})  plain {plain_ms:.3f} ms  "
              f"bound {bound:.6f} ms ({by})  equal; plan: "
              f"{'wide, ' if lp['wide'] else ''}{lp['segments']} "
              f"segments a composition, clusters of {lp['cluster']}, "
              f"{lp['folds']} cluster partials (a second launch when > 1), "
              f"{lp['pack']} compositions a CTA, {lp['cons']} consumer "
              f"threads, {lp['ctas']} CTAs, tile {lp['tile']} maps")
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
              f"{plain_ms:.1f} ms  bound {bound:.4f} ms ({by}), share of "
              f"bound {bound / ms:.3f}  equal")
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
    sequential matcher, the torch gather loop, ``dfa.run`` and
    ``Matcher``."""
    import torch
    from repro_torch.core import (Matcher, SpecDFAEngine,
                                  build_lookahead_tables,
                                  compile_pattern_suite, match_chunks_lanes,
                                  profile_capacity, profile_workers,
                                  random_dfa, synthetic_capacities)
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
        torch gather loop and dfa.run; the decision against Matcher.  Only
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
        # the torch gather loop, the default matcher on the CPU only (on a
        # card an engine given no matcher runs ops.spec_match)
        default = SpecDFAEngine(dfa, num_chunks=eng0.num_chunks,
                                mode=eng0.mode, partition=eng0.partition,
                                weights=eng0.weights,
                                lookahead_r=eng0.lookahead_r,
                                matcher=match_chunks_lanes, device=DEVICE)
        oracle = dfa.run(head)
        got = (eng0.membership(head).final_state,
               default.membership(head).final_state)
        check(got == (oracle, oracle), f"{tag} {name}: on the first "
              f"{head_bytes} bytes {route0} / the torch gather loop {got} != "
              f"dfa.run {oracle}")
        doc_m = doc if tag != "[14c]" else head
        acc = bool(Matcher(dfa, device=DEVICE).membership_batch(
            [doc_m]).accepted[0, 0])
        want = seq.accepted if tag != "[14c]" else bool(dfa.accepting[oracle])
        check(acc == want, f"{tag} {name}: Matcher decides {acc}")
        print(f"{tag} {name}: Q={dfa.n_states} classes={dfa.n_classes} "
              f"I_max={eng0.i_max} final {seq.final_state} "
              f"accepted {seq.accepted}; routes {sorted(finals)} equal "
              f"sequential, the torch gather loop, dfa.run and Matcher")

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


def plant(docs, every, lits, rng):
    """Copies of ``docs`` with one of ``lits`` planted mid-document in every
    ``every``-th one."""
    out = list(docs)
    for i in range(0, len(out), every):
        lit = lits[int(rng.integers(0, len(lits)))]
        d, mid = out[i], len(out[i]) // 2
        out[i] = d[:mid] + lit + d[mid + len(lit):]
    return out


def smem_table(m):
    """Whether B1 reads matcher ``m``'s table from shared memory (the
    placement ``dfa_match.merge_plan`` picks from the table's size)."""
    from repro_torch.kernels import dfa_match
    dev = m.dev
    q, n_cls_pad = dev.table_pad_t.shape
    return dfa_match.merge_plan(m.batch_tile, m.num_chunks,
                                m.n_patterns * dev.i_max, q, n_cls_pad,
                                4096, 512)["table_in_smem"]


def phase15_swap_and_scale(rng, ps, docs, search):
    """Hot swap and the pattern-set scale tier on the card: (a) Matcher
    swaps, (b) BlockedMatcher over K, its prefilter and block swaps, (c)
    BlockedStreamMatcher across a swap, and StreamMatcher's refusal."""
    import torch
    from repro_torch.core import (BlockedMatcher, Matcher, PCRE_PATTERNS,
                                  PatternSet)
    from repro_torch.kernels import dfa_match
    from repro_torch.streaming import (BlockedStreamMatcher, StreamMatcher,
                                       TickPolicy)

    def same(got, want, what):
        check(np.array_equal(got.accepted, want.accepted)
              and np.array_equal(got.final_states, want.final_states),
              f"{what}: accepted or finals differ")

    def b1_call(m, batch, tag):
        """One membership_batch with the launch counts read around it;
        returns (result, wall s)."""
        dfa_match.reset_launches()
        t0 = time.perf_counter()
        res = m.membership_batch(batch)
        wall = time.perf_counter() - t0
        n = dfa_match.launches["spec_match_merge"]
        check(n > 0, f"{tag}: launched no B1 kernel")
        return res, wall, n

    n_bytes = sum(len(d) for d in docs)
    # -- (a) Matcher swaps ---------------------------------------------------
    names = list(PCRE_PATTERNS)
    ps_mod = PatternSet({**PCRE_PATTERNS, **{names[i]: p for i, p in
                                             SWAP15.items()}}, k_blk=64)
    docs_mod = plant(docs, 4, PLANT15, rng)
    head = []
    for d in docs:
        if sum(map(len, head)) + len(d) > HEAD15:
            break
        head.append(d)
    big = [search[k] for k in BIG15]
    m = Matcher(ps, device=DEVICE, num_chunks=8, batch_tile=64)
    want_a, _, _ = b1_call(m, docs, "[15a] PCRE-14")
    lowered, traces = dict(m.perf_report()["lowerings"]), m.trace_count
    t0 = time.perf_counter()
    check(m.swap_patterns(ps) is False, "a signature-equal swap returned "
          "True")
    noop = time.perf_counter() - t0
    check(m.perf_report()["lowerings"] == lowered and m.trace_count == traces
          and m.planner.table_epoch == 0, "a no-op swap touched lowerings")
    print(f"[15a] Matcher(PCRE-14) on {len(docs)} docs ({n_bytes} bytes); "
          f"swap to a signature-equal set: False in {noop * 1e3:.3f} ms, "
          f"lowerings and traces unchanged")
    steps = (("PCRE-14 with patterns 0, 9 replaced", ps_mod, docs_mod),
             ("the 3 large PROSITE search DFAs", big, head),
             ("PCRE-14 again", ps, docs))
    for epoch, (what, src, batch) in enumerate(steps, start=1):
        t0 = time.perf_counter()
        check(m.swap_patterns(src) is True, f"swap to {what} returned False")
        swap_s = time.perf_counter() - t0
        check(m.planner.table_epoch == epoch
              and m.perf_report()["lowerings"] == {},
              f"swap to {what}: epoch {m.planner.table_epoch}, lowerings "
              f"kept")
        got, first, n1 = b1_call(m, batch, f"[15a] {what}")
        _, warm, _ = b1_call(m, batch, f"[15a] {what}")
        kinds = set(m.perf_report()["lowerings"].values())
        check("spec-kernel" in kinds and kinds <= {"spec-kernel",
                                                   "seq-torch"}
              and all(k.endswith(f"|{epoch}")
                      for k in m.perf_report()["lowerings"]),
              f"swap to {what}: lowerings {m.perf_report()['lowerings']}")
        fresh = Matcher(src, device=DEVICE, num_chunks=8, batch_tile=64)
        same(got, fresh.membership_batch(batch), f"[15a] {what} vs fresh")
        if epoch == 1:
            same(got, Matcher(src, device=DEVICE, num_chunks=8,
                              batch_tile=64, backend="local")
                 .membership_batch(batch), f"[15a] {what} vs local")
            check(got.accepted[:, list(SWAP15)].any(axis=0).all(),
                  "the swapped-in patterns matched nothing")
        if epoch == 3:
            same(got, want_a, "[15a] back to PCRE-14 vs the first run")
        nb = sum(len(d) for d in batch)
        print(f"[15a] swap to {what}: {swap_s * 1e3:.2f} ms (epoch "
              f"{epoch}, K={m.n_patterns}, Q={m.packed.n_states}, S="
              f"{m.dev.i_max}, table in "
              f"{'shared' if smem_table(m) else 'global'} memory); first "
              f"call {first:.4f} s (re-lowers; B1 launches {n1}), warm "
              f"{warm:.4f} s, {nb / warm / 1e6:.1f} MB/s over {len(batch)} "
              f"docs; equal a fresh matcher"
              + (" and backend='local'" if epoch == 1 else "")
              + (" and the first run" if epoch == 3 else ""))
    check(smem_table(m), "PCRE-14's table left shared memory")

    # -- (b) BlockedMatcher over K -------------------------------------------
    pats = [f"P{i:04x}e" for i in range(max(KSWEEP15))]
    # literals of block 0 at every K of the sweep
    firsts = [p.encode() for p in pats[:min(KBLK15, *KSWEEP15)]]
    docs_b = plant(docs, 4, firsts, rng)
    n_live = len(range(0, len(docs_b), 4))
    sets = {k: PatternSet(pats[:k], k_blk=KBLK15) for k in KSWEEP15}
    kept = {}
    for k in KSWEEP15:
        runs = {}
        for gate in (True, False):
            bm = BlockedMatcher(sets[k], prefilter=gate, device=DEVICE,
                                **KW15)
            res, _, _ = b1_call(bm, docs_b, f"[15b] K={k}")
            skipped0 = bm.prefilter_skipped_blocks
            gated0 = bm.prefilter_gated_docs
            res2, wall, n1 = b1_call(bm, docs_b, f"[15b] K={k}")
            same(res2, res, f"[15b] K={k} repeat")
            nblk = bm.n_blocks
            if gate:
                check(bm.prefilter_skipped_blocks - skipped0 == nblk - 1
                      and bm.prefilter_gated_docs - gated0
                      == (len(docs_b) - n_live) + (nblk - 1) * len(docs_b),
                      f"[15b] K={k}: skipped "
                      f"{bm.prefilter_skipped_blocks - skipped0} blocks, "
                      f"gated {bm.prefilter_gated_docs - gated0} (doc, block)"
                      " pairs; the plants imply otherwise")
            runs[gate] = res
            kept[(k, gate)] = bm
            print(f"[15b] K={k} ({nblk} blocks of {KBLK15}) prefilter "
                  f"{'on ' if gate else 'off'}: {wall:.4f} s, "
                  f"{n_bytes / wall / 1e6:.1f} MB/s; B1 launches {n1}; "
                  f"skipped blocks per call "
                  f"{bm.prefilter_skipped_blocks - skipped0 if gate else 0}")
        check(np.array_equal(runs[True].accepted, runs[False].accepted),
              f"[15b] K={k}: the prefilter changed a verdict")
        check(runs[True].accepted.any(), f"[15b] K={k}: no match")
    k = max(KSWEEP15)
    on, off = kept[(k, True)], kept[(k, False)]
    got = on.membership_batch(docs_b)
    same(got, BlockedMatcher(sets[k], prefilter=True, device=DEVICE,
                             backend="local", **KW15).membership_batch(docs_b),
         f"[15b] K={k} vs backend='local'")
    same_32 = Matcher(PatternSet(pats[:KBLK15], k_blk=1 << 30),
                      device=DEVICE, **KW15).membership_batch(docs_b)
    full = off.membership_batch(docs_b)
    check(np.array_equal(full.accepted[:, :KBLK15], same_32.accepted)
          and np.array_equal(full.final_states[:, :KBLK15],
                             same_32.final_states),
          f"[15b] K={k}: the first {KBLK15} columns differ from an unblocked"
          f" K={KBLK15} Matcher")
    k8 = 8 * KBLK15
    blk8 = BlockedMatcher(PatternSet(pats[:k8], k_blk=KBLK15),
                          prefilter=False, device=DEVICE, **KW15)
    one = Matcher(PatternSet(pats[:k8], k_blk=1 << 30), device=DEVICE, **KW15)
    same(blk8.membership_batch(docs_b), one.membership_batch(docs_b),
         f"[15b] K={k8}: 8 blocks vs one pack")
    print(f"[15b] K={k} equals backend='local' on the card (gated) and, on "
          f"its first {KBLK15} columns, an unblocked K={KBLK15} Matcher; "
          f"K={k8} in 8 blocks equals one pack of {k8} (Q="
          f"{one.packed.n_states}, table in "
          f"{'shared' if smem_table(one) else 'global'} memory)")
    for bm, tag in ((off, "off"), (on, "on")):
        device_busy(lambda: bm.membership_batch(docs_b),
                    f"[15b] K={k} prefilter {tag}")
    # block swaps on the ungated matcher: every block runs every document
    traces0 = [mm.executor.traces for mm in off.matchers]
    idx = 5 * KBLK15 + 3
    t0 = time.perf_counter()
    new_ps = off.pattern_set.with_patterns({idx: DATE15})
    info = off.swap_patterns(new_ps)
    swap_s = time.perf_counter() - t0
    check(info == {"reused": [i for i in range(off.n_blocks) if i != 5],
                   "rebuilt": [5], "dropped": 0}, f"[15b] swap report {info}")
    got, wall, _ = b1_call(off, docs_b, "[15b] after the block swap")
    traces1 = [mm.executor.traces for mm in off.matchers]
    check(all(a == b for i, (a, b) in enumerate(zip(traces0, traces1))
              if i != 5) and traces1[5] > traces0[5],
          "[15b] the reused blocks re-lowered or block 5 did not")
    same(got, BlockedMatcher(new_ps, prefilter=False, device=DEVICE, **KW15)
         .membership_batch(docs_b), "[15b] after the block swap vs fresh")
    check(got.accepted[:, idx].any(), "[15b] the swapped-in pattern matched "
          "nothing")
    print(f"[15b] swap of pattern {idx} (block 5) to {DATE15!r}: "
          f"{swap_s:.3f} s (with_patterns recompiles the set), report "
          f"reused {len(info['reused'])} blocks, rebuilt {info['rebuilt']}; "
          f"rerun {wall:.4f} s; only block 5 re-lowered; equal a fresh "
          f"BlockedMatcher")
    head_b = docs_b[:len(head)]
    grown = list(off.pattern_set.regexes) + [f"P{i:04x}e" for i in
                                             range(k, k + KBLK15)]
    for what, new in (("appends a block", grown),
                      ("drops the last block", grown[:-KBLK15])):
        new_ps = PatternSet(new, k_blk=KBLK15)
        nblk = off.n_blocks
        info = off.swap_patterns(new_ps)
        grow = new_ps.n_blocks > nblk
        want_info = {"reused": list(range(min(nblk, new_ps.n_blocks))),
                     "rebuilt": [nblk] if grow else [],
                     "dropped": 0 if grow else nblk - new_ps.n_blocks}
        check(info == want_info, f"[15b] a swap that {what}: {info}")
        got, _, _ = b1_call(off, head_b, f"[15b] a swap that {what}")
        same(got, BlockedMatcher(new_ps, prefilter=False, device=DEVICE,
                                 **KW15).membership_batch(head_b),
             f"[15b] a swap that {what} vs fresh")
        print(f"[15b] a swap that {what}: {off.n_blocks} blocks, rebuilt "
              f"{info['rebuilt']}, dropped {info['dropped']}; equal a fresh "
              f"BlockedMatcher on {len(head_b)} docs")

    # -- (c) BlockedStreamMatcher across a swap, K = 256 ---------------------
    lazy = TickPolicy(max_batch=1 << 30, max_delay=1 << 30)
    ps_c = PatternSet(pats[:K15C], k_blk=KBLK15)
    swap_c = 3 * KBLK15
    ps_c2 = ps_c.with_patterns({swap_c: DATE15})
    heads = [d[:len(d) // 2] for d in docs_b]
    tails = [d[len(d) // 2:] for d in docs_b]
    whole_old = BlockedMatcher(ps_c, prefilter=False, device=DEVICE,
                               **KW15).membership_batch(docs_b)
    tail_new = BlockedMatcher(ps_c2, prefilter=False, device=DEVICE,
                              **KW15).membership_batch(tails)
    bsm = BlockedStreamMatcher(ps_c, policy=lazy, device=DEVICE, **KW15)
    sessions = [bsm.open() for _ in docs_b]
    dfa_match.reset_launches()
    t0 = time.perf_counter()
    for sess, h in zip(sessions, heads):
        sess.feed(h)
    bsm.flush()
    first_half = time.perf_counter() - t0
    keep = [[p.cursor.lane_states.copy() for p in sess.parts]
            for sess in sessions]
    t0 = time.perf_counter()
    info = bsm.swap_patterns(ps_c2)
    swap_s = time.perf_counter() - t0
    check(info == {"reused": [i for i in range(ps_c.n_blocks) if i != 3],
                   "rebuilt": [3], "dropped": 0}, f"[15c] swap report {info}")
    check(all(np.array_equal(p.cursor.lane_states, kp[bi])
              for sess, kp in zip(sessions, keep)
              for bi, p in enumerate(sess.parts) if bi != 3),
          "[15c] an unchanged block's cursor moved across the swap")
    t0 = time.perf_counter()
    for sess, tl in zip(sessions, tails):
        sess.feed(tl)
    results = [sess.close() for sess in sessions]
    second_half = time.perf_counter() - t0
    n_b1 = dfa_match.launches["spec_match_merge"]
    check(n_b1 > 0, "[15c] the exact ticks launched no B1 kernel")
    acc = np.stack([r.accepted for r in results])
    fin = np.stack([r.final_states for r in results])
    for bi in range(ps_c.n_blocks):
        # block-local finals: the swap re-bases the blocks after block 3
        sl = ps_c.block_slice(bi)
        want = whole_old if bi != 3 else tail_new
        base = (ps_c if bi != 3 else ps_c2).state_bases[bi]
        check(np.array_equal(acc[:, sl], want.accepted[:, sl])
              and np.array_equal(fin[:, sl] - ps_c2.state_bases[bi],
                                 want.final_states[:, sl] - base),
              f"[15c] block {bi} differs from "
              + ("whole-document matching" if bi != 3 else
                 "the new set over the second halves"))
    check(all(r.byte_count == len(d) for r, d in zip(results, docs_b)),
          "[15c] byte counts")
    check(acc[:, swap_c].any(), "[15c] the swapped-in pattern matched "
          "nothing")
    rate = n_bytes / (first_half + second_half) / 1e6
    print(f"[15c] BlockedStreamMatcher K={K15C} ({ps_c.n_blocks} blocks), "
          f"{len(docs_b)} streams in two halves: first halves {first_half:.4f}"
          f" s, swap of block 3 {swap_s * 1e3:.2f} ms, second halves + close "
          f"{second_half:.4f} s ({rate:.1f} MB/s); B1 launches {n_b1}; "
          f"{bsm.stats.ticks} ticks; unchanged"
          f" blocks' cursors bit-identical across the swap and equal "
          f"whole-document matching, block 3 equals the new set over the "
          f"second halves, byte counts whole")
    # StreamMatcher on PCRE-14: candidate-keyed sessions refuse the swap
    ml = Matcher(ps, device=DEVICE, num_chunks=8, batch_tile=64)
    sm = StreamMatcher(ml, policy=lazy, lane_ticks=True)
    sub = [d for d in docs[:64]]
    keys = np.array([ml.dev.advance_key(-1, d[:len(d) // 2]) for d in sub],
                    np.int32)
    lane_sessions = [sm.open_at(int(kk)) for kk in keys]
    for sess, d in zip(lane_sessions, sub):
        sess.feed(d[len(d) // 2:])
    dfa_match.reset_launches()
    sm.flush()
    n_b2 = dfa_match.launches["spec_match_merge_lanes"]
    check(n_b2 > 0, "[15c] the candidate-keyed ticks launched no B2 kernel")
    try:
        sm.swap_patterns(ps_mod)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "candidate-keyed" in refused
          and ml.planner.table_epoch == 0,
          "[15c] StreamMatcher swapped with candidate-keyed sessions open")
    maps = np.stack([sm.close_map(sess).lane_states
                     for sess in lane_sessions])
    cands = ml.dev.tables.candidates.astype(np.int32)
    want = Matcher(ps, device=DEVICE, num_chunks=8, batch_tile=64
                   ).advance_cursors([d[len(d) // 2:] for d in sub],
                                     cands[keys], keys).lane_states
    check(np.array_equal(maps, want), "[15c] close_map differs from "
          "advance_cursors")
    check(sm.swap_patterns(ps_mod) is True and ml.planner.table_epoch == 1,
          "[15c] StreamMatcher refused the swap after close_map")
    print(f"[15c] StreamMatcher(PCRE-14, lane_ticks=True): {len(sub)} "
          f"open_at sessions ticked on B2 ({n_b2} launches); swap refused "
          f"({refused[:40]!r}...); after close_map the swap returns True")
    torch.cuda.synchronize()


def parts4(rng, n):
    """Cut points of an ``n``-byte body into four ragged parts: each cut
    within 999 bytes (and an eighth of ``n``) of a quarter."""
    j = min(999, n // 8)
    return [0, *(n * q // 4 + int(rng.integers(-j, j + 1))
                 for q in (1, 2, 3)), n]


def npz_bytes(path):
    """Bytes of every ``arrays.npz`` under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files
               if f == "arrays.npz")


def refusal(fn):
    """The ValueError text ``fn`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def phase16a_sessions(rng, ps, docs, m3, tmp):
    """In-order sessions: 192 exact + 64 candidate-keyed streams in four
    ragged parts, snapshot after the second with a third still pending,
    restored on the card (both backends) and on the CPU."""
    import torch
    from repro_torch.core import PatternSet
    from repro_torch.kernels import dfa_match
    from repro_torch.streaming import StreamMatcher, TickPolicy
    from repro_torch.training.checkpoint import latest_step

    lazy = TickPolicy(max_batch=1 << 30, max_delay=1 << 30)
    kw = dict(num_chunks=8, batch_tile=64, lane_ticks=True, policy=lazy)
    n_exact = N_DOCS - KEYED16
    sm = StreamMatcher(ps, device=DEVICE, **kw)
    keys = [sm.matcher.dev.advance_key(-1, d[:HEAD16])
            for d in docs[n_exact:]]
    bodies = docs[:n_exact] + [d[HEAD16:] for d in docs[n_exact:]]
    pieces = []
    for body in bodies:
        c = parts4(rng, len(body))
        pieces.append([body[c[j]:c[j + 1]] for j in range(4)])
    late = [i % 3 == 2 for i in range(N_DOCS)]   # part 2 pending at snapshot

    def second_half(m_sm, sessions):
        """The first tick (the pending parts), parts 3 and 4, close."""
        t0 = time.perf_counter()
        m_sm.flush()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for j in (2, 3):
            for sess, p in zip(sessions, pieces):
                sess.feed(p[j])
            m_sm.flush()
        res = [sess.close() for sess in sessions[:n_exact]]
        maps = [m_sm.close_map(sess) for sess in sessions[n_exact:]]
        return first, time.perf_counter() - t0, res, maps, sessions

    sessions = ([sm.open() for _ in range(n_exact)]
                + [sm.open_at(k) for k in keys])
    for sess, p in zip(sessions, pieces):
        sess.feed(p[0])
    sm.flush()
    for sess, p, lt in zip(sessions, pieces, late):
        if not lt:
            sess.feed(p[1])
    sm.flush()
    for sess, p, lt in zip(sessions, pieces, late):
        if lt:
            sess.feed(p[1])
    n_pend = sum(sess.pending_bytes > 0 for sess in sessions)
    at_snap = [(sess.byte_count, sess.pending_bytes, sess.segments_fed)
               for sess in sessions]
    t0 = time.perf_counter()
    path = sm.snapshot(tmp)
    snap_s = time.perf_counter() - t0
    # a writer killed mid-publish leaves step_<N>.tmp: every restore below
    # must skip it
    os.makedirs(os.path.join(tmp, "step_00000099.tmp"))
    with open(os.path.join(tmp, "step_00000099.tmp", "arrays.npz"),
              "wb") as f:
        f.write(b"garbage")
    check(latest_step(tmp) == 0, "[16a] latest_step took the .tmp writer")
    warm, _, want_res, want_maps, _ = second_half(sm, sessions)
    whole = m3.membership_batch(docs)
    fin = np.stack([r.final_states for r in want_res])
    check(np.array_equal(fin, whole.final_states[:n_exact])
          and np.array_equal(np.stack([r.accepted for r in want_res]),
                             whole.accepted[:n_exact]),
          "[16a] the uninterrupted streams differ from membership_batch")
    n_bytes = sum(len(d) for d in docs)
    print(f"[16a] StreamMatcher(PCRE-14, num_chunks=8, batch_tile=64, "
          f"lane_ticks=True): {n_exact} exact + {KEYED16} candidate-keyed "
          f"sessions (open_at after {HEAD16} bytes), {n_bytes} bytes in four "
          f"ragged parts; snapshot after part 2 with {n_pend} sessions "
          f"pending: {snap_s:.4f} s, arrays.npz {npz_bytes(path)} bytes")
    for backend, device in (("cuda", DEVICE), ("local", DEVICE),
                            ("cuda", "cpu")):
        tag = f"[16a] restored on backend={backend!r} device={device!r}"
        sm2 = StreamMatcher(ps, backend=backend, device=device, **kw)
        t0 = time.perf_counter()
        by_sid = {r.sid: r for r in sm2.restore(tmp)}
        rest_s = time.perf_counter() - t0
        got = [by_sid[sess.sid] for sess in sessions]
        check([(r.byte_count, r.pending_bytes, r.segments_fed)
               for r in got] == at_snap and sm2.stats.feeds == 0,
              f"{tag}: byte counts, pending bytes or segments_fed differ "
              "from the snapshot's")
        dfa_match.reset_launches()
        first, rest, res, maps, got = second_half(sm2, got)
        launched = dict(dfa_match.launches)
        if backend == "cuda" and device == DEVICE:
            check(launched["spec_match_merge"] > 0
                  and launched["spec_match_merge_lanes"] > 0,
                  f"{tag}: the restored ticks did not launch B1 and B2: "
                  f"{launched}")
        else:
            check(sum(launched.values()) == 0, f"{tag}: launched {launched}")
        check(all(np.array_equal(a.final_states, b.final_states)
                  and np.array_equal(a.accepted, b.accepted)
                  and a.byte_count == b.byte_count == len(d)
                  and a.segments_fed == b.segments_fed == 4
                  for a, b, d in zip(res, want_res, docs)),
              f"{tag}: close() differs from the uninterrupted run")
        check(all(np.array_equal(a.lane_states, b.lane_states)
                  and a.entry_class == b.entry_class
                  and a.n_bytes == b.n_bytes == len(d) - HEAD16
                  for a, b, d in zip(maps, want_maps, docs[n_exact:])),
              f"{tag}: close_map() differs from the uninterrupted run")
        check(all(sess.segments_fed == 4 for sess in got),
              f"{tag}: segments_fed")
        print(f"{tag}: restore {rest_s:.4f} s; first tick after restore "
              f"{first:.4f} s (the uninterrupted run's tick of the same "
              f"pending bytes: {warm:.4f} s); parts 3-4 + close "
              f"{rest:.4f} s; launches {launched}; close() and close_map() "
              "equal the uninterrupted run, byte counts and segments_fed "
              "carried")
    foreign = refusal(lambda: StreamMatcher(
        PatternSet({"zz": "zz[0-9]+"}), device=DEVICE, **kw).restore(tmp))
    busy = StreamMatcher(ps, device=DEVICE, **kw)
    busy.open()
    clash = refusal(lambda: busy.restore(tmp))
    check(foreign is not None and "different packed pattern set" in foreign,
          f"[16a] a foreign pattern set restored: {foreign}")
    check(clash is not None and "already open" in clash,
          f"[16a] a colliding session id restored: {clash}")
    print(f"[16a] refused: a foreign set ({foreign[:58]!r}...), a sid "
          f"collision ({clash[:40]!r}...); the crashed writer's .tmp step "
          "was skipped by every restore")


def phase16b_ooo(rng, ps, docs9, want9, rate9, tmp):
    """Out of order at phase 9's scale: odd segments first (a quarter with
    prev_tail hints), snapshot after flush, restored on the carry (B3) and
    the tree (B4) compose; the local backend's tree against the kernels'."""
    from repro_torch.core import Matcher
    from repro_torch.kernels import dfa_match, lvec_compose
    from repro_torch.streaming import OooPolicy, OooStreamMatcher
    from repro_torch.streaming.ooo.checkpoint import OOO_TREE_KEYS, ooo_tree

    seg = DOC9 // SEGS9
    policy = OooPolicy(match_batch=STREAMS9)
    hints = rng.random((STREAMS9, SEGS9)) < 0.25
    odd, even = range(1, SEGS9, 2), range(0, SEGS9, 2)

    def deliver(ooo, streams, idxs):
        for i in idxs:
            for j, (st, d) in enumerate(zip(streams, docs9)):
                tail = d[i * seg - 2:i * seg] if i % 2 and hints[j, i] \
                    else None
                st.feed(i, d[i * seg:(i + 1) * seg], prev_tail=tail)
            ooo.flush()

    def closed(streams, tag):
        res = [st.close() for st in streams]
        check(np.array_equal(np.stack([r.final_states for r in res]), want9)
              and all(r.byte_count == DOC9 for r in res),
              f"{tag}: decisions or byte counts differ")
        return res

    def first_half(backend, where):
        m = Matcher(ps, num_chunks=8, backend=backend, device=DEVICE)
        ooo = OooStreamMatcher(m, policy=policy)
        streams = [ooo.open() for _ in docs9]
        deliver(ooo, streams, odd)
        tree = ooo_tree(ooo)
        t0 = time.perf_counter()
        path = ooo.snapshot(where)
        return ooo, streams, tree, time.perf_counter() - t0, path

    dir_c, dir_l = os.path.join(tmp, "cuda"), os.path.join(tmp, "local")
    ooo, streams, tree_c, snap_s, path = first_half("cuda", dir_c)
    n_m = int(tree_c["bs_matched"].sum())
    n_raw = len(tree_c["bs_matched"]) - n_m
    print(f"[16b] OooStreamMatcher {STREAMS9} streams x {DOC9} bytes in "
          f"{SEGS9} segments, odd segments first ({int(hints[:, 1::2].sum())}"
          f" with prev_tail): snapshot {snap_s:.4f} s, arrays.npz "
          f"{npz_bytes(path)} bytes; parked bs_* {n_m} matched maps, "
          f"{n_raw} raw payloads ({int(tree_c['bs_data'].size)} bytes)")
    check(n_m > 0 and n_raw > 0, "[16b] the parks are not a mix")
    deliver(ooo, streams, even)
    closed(streams, "[16b] the uninterrupted run")
    _, _, tree_l, _, _ = first_half("local", dir_l)
    differ = [k for k in OOO_TREE_KEYS if k != "bs_lanes"
              and not np.array_equal(tree_c[k], tree_l[k])]
    check(not differ, f"[16b] backend='cuda' and 'local' trees differ on "
          f"{differ}")
    lanes_c, lanes_l = tree_c["bs_lanes"], tree_l["bs_lanes"]
    matched = tree_c["bs_matched"]
    real = np.zeros(lanes_c.shape, bool)
    real[matched] = real_lane_mask(ooo.matcher.dev.tables,
                                   tree_c["bs_entry"][matched])
    diff = lanes_c != lanes_l
    check(not (diff & real).any(), f"[16b] the trees' matched maps differ "
          f"on {int((diff & real).sum())} real lanes")
    print(f"[16b] backend='cuda' and 'local' snapshots: every key equal"
          + (" but bs_lanes on "f"{int(diff.sum())} pad lanes (no real "
             "lane)" if diff.any() else ", bs_lanes bit for bit") + f" "
          f"({int(real.sum())} real lanes)")
    half = STREAMS9 * DOC9 // 2
    for mode, where in (("carry", dir_c), ("tree", dir_c),
                        ("carry", dir_l)):
        tag = (f"[16b] restored on the {mode} compose"
               + (" (the local backend's snapshot)" if where == dir_l
                  else ""))
        m2 = Matcher(ps, num_chunks=8, device=DEVICE)
        m2.executor.compose_mode = mode
        ooo2 = OooStreamMatcher(m2, policy=policy)
        t0 = time.perf_counter()
        got = ooo2.restore(where)
        rest_s = time.perf_counter() - t0
        dfa_match.reset_launches()
        lvec_compose.reset_launches()
        t0 = time.perf_counter()
        deliver(ooo2, got, even)
        closed(got, tag)
        wall = time.perf_counter() - t0
        launched = {**dfa_match.launches, **lvec_compose.launches}
        fold = ("spec_compose_lanes" if mode == "carry"
                else "spec_compose_lanes_tree")
        other = ("spec_compose_lanes_tree" if mode == "carry"
                 else "spec_compose_lanes")
        check(launched[fold] > 0 and launched[other] == 0
              and launched["spec_match_merge"]
              + launched["spec_match_merge_lanes"] > 0,
              f"{tag}: launches {launched}")
        print(f"{tag}: restore {rest_s:.4f} s; even segments + close "
              f"{wall:.4f} s ({half / wall / 1e6:.1f} MB/s; phase 9 at "
              f"f = 0.25: {rate9:.1f} MB/s); decisions equal "
              f"membership_batch, byte counts {DOC9}; launches {launched}")


def phase16c_blocked(rng, docs, tmp):
    """BlockedStreamMatcher K = 256 (8 blocks) fed in halves, snapshot
    between them, restored fresh; a swapped block 5 and the prefilter off
    refuse the snapshot."""
    from repro_torch.core import PatternSet
    from repro_torch.kernels import dfa_match
    from repro_torch.streaming import BlockedStreamMatcher, TickPolicy

    lazy = TickPolicy(max_batch=1 << 30, max_delay=1 << 30)
    pats = [f"P{i:04x}e" for i in range(K15C)]
    ps_c = PatternSet(pats, k_blk=KBLK15)
    docs_b = plant(docs, 4, [p.encode() for p in pats[:KBLK15]], rng)
    bsm = BlockedStreamMatcher(ps_c, policy=lazy, device=DEVICE, **KW15)
    sessions = [bsm.open() for _ in docs_b]
    for sess, d in zip(sessions, docs_b):
        sess.feed(d[:len(d) // 2])
    bsm.flush()
    t0 = time.perf_counter()
    bsm.snapshot(tmp)
    snap_s = time.perf_counter() - t0
    fresh = BlockedStreamMatcher(ps_c, policy=lazy, device=DEVICE, **KW15)
    t0 = time.perf_counter()
    by_sid = {r.sid: r for r in fresh.restore(tmp)}
    rest_s = time.perf_counter() - t0
    got = [by_sid[sess.sid] for sess in sessions]
    dfa_match.reset_launches()
    t0 = time.perf_counter()
    for sess, d in zip(got, docs_b):
        sess.feed(d[len(d) // 2:])
    res2 = [sess.close() for sess in got]
    wall = time.perf_counter() - t0
    n_b1 = dfa_match.launches["spec_match_merge"]
    check(n_b1 > 0, "[16c] the restored ticks launched no B1 kernel")
    for sess, d in zip(sessions, docs_b):
        sess.feed(d[len(d) // 2:])
    res = [sess.close() for sess in sessions]
    check(all(np.array_equal(a.final_states, b.final_states)
              and np.array_equal(a.accepted, b.accepted)
              and a.byte_count == b.byte_count == len(d)
              for a, b, d in zip(res2, res, docs_b))
          and np.stack([r.accepted for r in res]).any(),
          "[16c] the restored streams differ from the uninterrupted run")
    swapped = refusal(lambda: BlockedStreamMatcher(
        ps_c.with_patterns({5 * KBLK15 + 3: DATE15}), policy=lazy,
        device=DEVICE, **KW15).restore(tmp))
    ungated = refusal(lambda: BlockedStreamMatcher(
        ps_c, policy=lazy, prefilter=False, device=DEVICE,
        **KW15).restore(tmp))
    check(swapped is not None and ungated is not None
          and "different packed pattern set" in swapped + ungated,
          f"[16c] refusals: {swapped}, {ungated}")
    print(f"[16c] BlockedStreamMatcher K={K15C} ({ps_c.n_blocks} blocks), "
          f"{len(docs_b)} streams in halves: snapshot {snap_s:.4f} s "
          f"({npz_bytes(tmp)} bytes in {ps_c.n_blocks} trees), restore "
          f"{rest_s:.4f} s, second halves + close {wall:.4f} s, B1 launches "
          f"{n_b1}; equal the uninterrupted run; a swapped block 5 and the "
          "prefilter off refuse the snapshot")


def tensors(tree):
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    return [tree]


def tree_map(fn, tree):
    """A nested dict with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase16d_checkpoint_and_serve(tmp):
    """CheckpointManager(use_async=True, keep=2) on the card: tinyllama's
    embedding and first two layers in f32 and bf16, updated in place right
    after submit; then launch.serve --stream --snapshot-dir (B5 a decode
    step) and a restore of its last round."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import compile_regex
    from repro_torch.kernels import flash_attn, token_mask
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serving import GrammarConstraint
    from repro_torch.training.checkpoint import (CheckpointManager,
                                                 restore_checkpoint)

    cfg = get_config(ARCH12)
    params = api.init(cfg, SEED, device=DEVICE)
    sub = {"embed": params["embed"],
           "layers": tree_map(lambda w: w[:2].clone(), params["layers"])}
    del params
    torch.cuda.empty_cache()
    bf = tree_map(lambda w: w.bfloat16(), sub)
    ck = os.path.join(tmp, "ckpt")
    mgr = CheckpointManager(ck, keep=2, use_async=True)
    for step, (what, tree) in enumerate((("f32", sub), ("bf16", bf),
                                         ("f32 again", sub))):
        leaves = tensors(tree)
        before = [t.clone() for t in leaves]
        n_b = sum(t.numel() * t.element_size() for t in leaves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(tree, step)
        blocked = time.perf_counter() - t0
        for t in leaves:
            t.add_(1)
        mgr.wait()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, got_step = restore_checkpoint(ck, tree, step=step)
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t0
        back = tensors(out)
        check(got_step == step and all(
            r.device == b.device and r.dtype == b.dtype
            and torch.equal(r, b) for r, b in zip(back, before)),
            f"[16d] step {step} ({what}): the restore differs from the "
            "values before the in-place add")
        print(f"[16d] CheckpointManager step {step} ({what}, {len(leaves)} "
              f"tensors, {n_b} bytes): submit blocked {blocked:.4f} s, "
              f"written in {write_s:.4f} s ({n_b / write_s / 1e6:.1f} MB/s),"
              f" restored onto the card in {rest_s:.4f} s "
              f"({n_b / rest_s / 1e6:.1f} MB/s); equal the pre-add values "
              "bit for bit")
        del out, back, before
    mgr._gc()
    kept = sorted(os.listdir(ck))
    check(kept == ["step_00000001", "step_00000002"], f"[16d] kept {kept}")
    del sub, bf
    torch.cuda.empty_cache()
    snap = os.path.join(tmp, "serve")
    argv = ["--arch", ARCH12, "--max-new", "8", "--stream", "--chunk-bytes",
            str(CHUNK16), "--snapshot-dir", snap, "--grammar", GRAMMAR12,
            "--prompts", *PROMPTS16]
    buf = io.StringIO()
    token_mask.reset_launches()
    flash_attn.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    wall = time.perf_counter() - t0
    # generate's prefill runs in a cache longer than the prompt, which takes
    # the blockwise attention path: B9 is counted, not required
    n5, n9 = token_mask.launches["token_mask"], flash_attn.launches[
        "flash_attn"]
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[16d] serve: {line}")
    width = max(len(p) for p in PROMPTS16)
    rounds = -(-width // CHUNK16)
    published = [ln for ln in lines if ln.startswith("[stream] snapshot")]
    check(len(published) == rounds and sorted(os.listdir(snap)) == [
        f"step_{c:08d}" for c in range(rounds)] and n5 > 0,
        f"[16d] serve published {len(published)} steps of {rounds} rounds;"
        f" B5 {n5}, B9 {n9} launches")
    gc = GrammarConstraint(compile_regex(GRAMMAR12), cfg.padded_vocab,
                           device=DEVICE)
    ds = gc.open_decode(len(PROMPTS16))
    for sess in ds.sessions:       # their sids are the snapshot's
        sess.close()
    ds.sessions = ds.stream.restore(snap)
    prompts = np.full((len(PROMPTS16), width), 32, np.int32)
    for i, p in enumerate(PROMPTS16):
        prompts[i, :len(p)] = np.frombuffer(p.encode(), np.uint8)
    check(torch.equal(ds.states, gc.advance_tokens(gc.init_states(
        len(PROMPTS16)), prompts)), "[16d] the restored serving cursors "
        "differ from the last round's prefill")
    print(f"[16d] launch.serve --stream --snapshot-dir: {rounds} rounds, "
          f"{rounds} steps published, {wall:.2f} s (B9 launches {n9}, B5 "
          f"{n5}); a fresh open_decode restored from the last step holds "
          "the whole prompts' prefill states")


def phase16_failover(rng, ps, docs, m3, docs9, want9, rate9):
    """Stream failover on the card, each part in a temporary directory of
    its own that the phase removes."""
    import shutil
    import tempfile

    for name, fn in (("a", lambda d: phase16a_sessions(rng, ps, docs, m3,
                                                       d)),
                     ("b", lambda d: phase16b_ooo(rng, ps, docs9, want9,
                                                  rate9, d)),
                     ("c", lambda d: phase16c_blocked(rng, docs, d)),
                     ("d", phase16d_checkpoint_and_serve)):
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke16{name}_")
        t0 = time.perf_counter()
        try:
            fn(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"[16{name}] in {time.perf_counter() - t0:.1f} s")


def kernel_launches():
    """Launches so far of the match and compose kernels (B1, B2, B6, B3,
    B4, B7, B8), by wrapper name."""
    from repro_torch.kernels import dfa_match, lvec_compose, onehot_match
    return {**dfa_match.launches, **lvec_compose.launches,
            **onehot_match.launches}


def reset_kernel_launches():
    from repro_torch.kernels import dfa_match, lvec_compose, onehot_match
    for mod in (dfa_match, lvec_compose, onehot_match):
        mod.reset_launches()


def launched(counts):
    """The nonzero launch counts, as text."""
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "none"


def synced(fn):
    """``fn()`` and its wall time, the device drained before and after."""
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase17a_autotune(ps, docs, want3, tmp):
    """The shape autotuner on the card: a cold-start tune with every
    candidate's score and resolved block and tile, the in-process and disk
    caches, and the retune over phase 3's traffic."""
    from repro_torch.core import Matcher, profiling
    from repro_torch.core.engine.plan import next_pow2
    from repro_torch.kernels import dfa_match

    scores = []
    measure = profiling._measure_config

    def recording(packed, probe, **kw):
        us = measure(packed, probe, **kw)
        scores.append((kw["num_chunks"], kw["l_blk"], kw["batch_tile"],
                       [len(p) for p in probe], us))
        return us

    def show(tag, m):
        """Each measured candidate: its score and, per chunk length of its
        probe, the block and B1 ring tile it resolves to."""
        q, n_cls_pad = m.dev.table_pad_t.shape
        ks = m.n_patterns * m.dev.i_max
        for nc, lb, bt, lens, us in scores:
            bt = next_pow2(bt or max(8, len(lens)))   # the Matcher's tile
            cls = sorted({next_pow2(-(-n // nc)) for n in lens
                          if n >= 4 * nc})
            how = []
            for cl in cls:
                blk = min(cl, lb)
                tile = dfa_match.merge_plan(bt, nc, ks, q, n_cls_pad, cl,
                                            blk)["tile"]
                how.append(f"chunk {cl}: block {blk}, tile {tile}")
            print(f"{tag} candidate num_chunks={nc} l_blk={lb}: {us:.1f} "
                  f"us per call ({len(lens)} probe docs, batch_tile {bt}); "
                  + "; ".join(how))
        scores.clear()

    def warm5(m):
        walls = [synced(lambda: m.membership_batch(docs))[1]
                 for _ in range(5)]
        return float(np.median(walls))

    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
    profiling.clear_autotune_cache()
    profiling._measure_config = recording
    try:
        m, cold = synced(lambda: Matcher(ps, autotune=True, device=DEVICE))
        tuned = m.perf_report()["autotune"]
        check(tuned["source"] == "measured", f"[17a] cold start: {tuned}")
        print(f"[17a] cold-start tune (PCRE-14, K={m.n_patterns}, S="
              f"{m.dev.i_max}): Matcher(autotune=True) in {cold:.3f} s, "
              f"{len(scores)} candidates measured; TunedShape {tuned}")
        show("[17a]", m)
        for want, clear in (("cache", False), ("disk", True)):
            if clear:
                profiling.clear_autotune_cache()
            again, wall = synced(lambda: Matcher(ps, autotune=True,
                                                 device=DEVICE))
            got = again.perf_report()["autotune"]
            check(got["source"] == want and not scores
                  and {k: v for k, v in got.items() if k != "source"}
                  == {k: v for k, v in tuned.items() if k != "source"},
                  f"[17a] the {want} read gave {got}, measured {scores}")
            print(f"[17a] another tune reads source={want!r} in "
                  f"{wall:.4f} s")

        # observed traffic: phase 3's corpus, then the retune
        lengths = np.array([len(d) for d in docs])
        res0 = m.membership_batch(docs)
        while m.traffic.n_docs < 64:
            m.membership_batch(docs)
        traffic = m.perf_report()["traffic"]
        spread = (DOC_BYTES[1] - DOC_BYTES[0]) / 7
        check(abs(traffic["median_len"] - float(np.median(lengths)))
              <= spread, f"[17a] traffic {traffic} against phase 3's median "
              f"length {np.median(lengths)}")
        drift = m._tuned_traffic.drift(m.traffic_profile())
        before = warm5(m)
        blk0 = m.executor.spec_l_blk.get(0, 512)
        stale = [k for k, kind in m.executor.lowering_kinds.items()
                 if kind.startswith("spec-kernel")]
        ran, retune = synced(m.maybe_retune)
        check(ran, f"[17a] maybe_retune did not run at drift {drift:.2f}")
        check(not any(k in m.executor._lowered
                      or k in m.executor.lowering_kinds for k in stale),
              "[17a] the lowerings of the old block survived the retune")
        blk1 = m.executor.spec_l_blk[0]
        print(f"[17a] traffic {traffic}, drift {drift:.2f} doublings from "
              f"the synthetic probe; maybe_retune() ran in {retune:.3f} s: "
              f"l_blk {blk0} -> {blk1}, TunedShape "
              f"{m.perf_report()['autotune']}; {len(stale)} kernel "
              "lowerings dropped")
        show("[17a] retune", m)
        reset_kernel_launches()
        res1 = m.membership_batch(docs)
        n1 = kernel_launches()
        check(n1["spec_match_merge"] > 0, "[17a] no B1 launch after the "
              "retune")
        check(np.array_equal(res1.final_states, res0.final_states)
              and np.array_equal(res1.accepted, res0.accepted)
              and np.array_equal(res1.final_states, want3),
              "[17a] finals after the retune differ from those before it, "
              "from an untuned Matcher and from backend='local'")
        after = warm5(m)
        print(f"[17] 17(a) launches after the retune: {launched(n1)}")
        print(f"[17a] warm membership_batch over phase 3's {len(docs)} docs "
              f"(median of 5): before the retune {before:.4f} s, after "
              f"{after:.4f} s ({lengths.sum() / after / 1e6:.1f} MB/s); "
              "finals equal before and after, an untuned Matcher and "
              "backend='local'")
    finally:
        profiling._measure_config = measure
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
        profiling.clear_autotune_cache()


def stream_events(docs, n_open, chunk):
    """(key, chunk) events of ``docs`` downloaded ``n_open`` at a time:
    within a wave, every document's next chunk in turn, then each one's
    end (``None``)."""
    events = []
    for lo in range(0, len(docs), n_open):
        wave = range(lo, min(lo + n_open, len(docs)))
        longest = max(len(docs[i]) for i in wave)
        for off in range(0, longest, chunk):
            events += [(i, docs[i][off:off + chunk]) for i in wave
                       if off < len(docs[i])]
        events += [(i, None) for i in wave]
    return events


def phase17b_filter(docs, keep):
    """The corpus filter over the generated shard: the batched path at two
    batch sizes, the loader, the streamed downloads and the per-document
    engines, each keep-mask against ``re``, and backend='local' on the card
    against the kernels' stats."""
    import dataclasses
    from repro_torch.data import (ByteTokenizer, CorpusFilter, FilterStats,
                                  LoaderConfig, data_stream)

    n_bytes = sum(len(d) for d in docs)
    n_drop = int((~keep).sum())

    def rate(n, wall, nb):
        return (f"{wall:.3f} s: {n / wall:.1f} docs/s, "
                f"{nb / wall / 1e6:.1f} MB/s")

    kept_want = [d for d, k in zip(docs, keep) if k]
    f = CorpusFilter(RULES17, device=DEVICE)
    check(f.batch.backend == "cuda", "[17b] the filter left the kernels")
    list(f.filter(docs[:BATCH17[-1]], batch_size=BATCH17[-1]))  # lowerings
    stats = {}
    for bs in BATCH17:
        f.stats = FilterStats()
        reset_kernel_launches()
        kept, wall = synced(lambda: list(f.filter(docs, batch_size=bs)))
        n = kernel_launches()
        check(kept == kept_want, f"[17b] filter(batch_size={bs}) keeps "
              f"{len(kept)} docs, re keeps {len(kept_want)}")
        check(n["spec_match_merge"] > 0, f"[17b] filter({bs}) launched no "
              "B1")
        stats[bs] = f.stats
        print(f"[17b] filter(batch_size={bs}): {rate(len(docs), wall, n_bytes)}"
              f"; kept {len(kept)}, dropped {f.stats.dropped}, "
              f"{f.stats.batch_calls} tiles")
        print(f"[17] 17(b) filter({bs}) launches: {launched(n)}")
    check(stats[BATCH17[0]].dropped == n_drop,
          f"[17b] dropped {stats[BATCH17[0]].dropped}, re finds {n_drop} "
          "contaminated docs")
    fl = CorpusFilter(RULES17, backend="local", device=DEVICE)
    bs = BATCH17[-1]
    kept_l, wall = synced(lambda: list(fl.filter(docs, batch_size=bs)))
    check(kept_l == kept_want, "[17b] backend='local' keeps other docs")
    got_s = {k: v for k, v in dataclasses.asdict(fl.stats).items()
             if k != "early_exits"}
    want_s = {k: v for k, v in dataclasses.asdict(stats[bs]).items()
              if k != "early_exits"}
    check(got_s == want_s, f"[17b] backend='local' stats {fl.stats} != the "
          f"kernels' {stats[bs]}")
    print(f"[17b] backend='local' on the card, filter(batch_size={bs}): "
          f"{rate(len(docs), wall, n_bytes)}; masks and FilterStats equal "
          f"(early_exits local {fl.stats.early_exits}, kernels "
          f"{stats[bs].early_exits})")
    device_busy(lambda: list(f.filter(docs, batch_size=bs)),
                f"[17b] filter(batch_size={bs})")

    # the loader: filtered, tokenized, packed
    cfg = LoaderConfig(batch_size=LOADER17[0], seq_len=LOADER17[1])
    f2 = CorpusFilter(RULES17, device=DEVICE)
    reset_kernel_launches()
    batches, wall = synced(lambda: list(data_stream(docs, cfg,
                                                    corpus_filter=f2)))
    n = kernel_launches()
    need = cfg.batch_size * (cfg.seq_len + 1)
    n_tokens = sum(len(d) + 2 for d in kept_want)
    check(len(batches) == n_tokens // need and n["spec_match_merge"] > 0,
          f"[17b] data_stream gave {len(batches)} batches, expected "
          f"{n_tokens // need}; launches {n}")
    check(all(b["tokens"].shape == (cfg.batch_size, cfg.seq_len)
              and np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
              for b in batches), "[17b] a packed batch's labels are not its "
          "tokens shifted")
    toks, n_tok = [], 0
    for d in kept_want:
        toks.append(ByteTokenizer().encode(d))
        n_tok += len(toks[-1])
        if n_tok >= need:
            break
    head = np.concatenate(toks)[:need]
    first = np.concatenate([batches[0]["tokens"], batches[0]["labels"][:, -1:]],
                           axis=1).reshape(-1)
    check(np.array_equal(first, head), "[17b] the first packed batch is not "
          "the kept documents' tokens")
    print(f"[17b] data_stream(LoaderConfig(batch_size={cfg.batch_size}, "
          f"seq_len={cfg.seq_len})): {len(batches)} packed batches in "
          f"{wall:.3f} s: {len(batches) / wall:.1f} batches/s, "
          f"{n_bytes / wall / 1e6:.1f} MB/s of raw documents")
    print(f"[17] 17(b) data_stream launches: {launched(n)}")

    # streamed downloads
    n_open, chunk, max_batch, max_delay = STREAM17
    events = stream_events(docs, n_open, chunk)
    f3 = CorpusFilter(RULES17, device=DEVICE)
    reset_kernel_launches()
    got, wall = synced(lambda: dict(f3.scan_stream(
        iter(events), max_batch=max_batch, max_delay=max_delay)))
    n = kernel_launches()
    check(got == {i: bool(k) for i, k in enumerate(keep)},
          "[17b] scan_stream decisions differ from re")
    check(n["spec_match_merge"] > 0, "[17b] scan_stream launched no B1")
    check(f3.stats.bytes_scanned == n_bytes and f3.stats.dropped == n_drop,
          f"[17b] scan_stream stats {f3.stats}")
    print(f"[17b] scan_stream: {len(docs)} docs as {n_open} concurrent "
          f"downloads in {chunk}-byte chunks ({len(events)} events, "
          f"max_batch={max_batch}, max_delay={max_delay}): "
          f"{rate(len(docs), wall, n_bytes)}; {f3.stats.batch_calls} tiles,"
          f" {f3.stats.early_exits} absorbed skips")
    print(f"[17] 17(b) scan_stream launches: {launched(n)} (B2 only where a "
          "tick takes the lane path)")

    # the per-document engines: B6, or B8 + B7 where mxu_profitable
    from repro_torch.kernels import ops
    sub = docs[:DOCOK17]
    f4 = CorpusFilter(RULES17, device=DEVICE)
    reset_kernel_launches()
    oks, wall = synced(lambda: [f4.document_ok(d) for d in sub])
    n = kernel_launches()
    check(oks == [bool(k) for k in keep[:DOCOK17]],
          "[17b] document_ok differs from re")
    product = [ops.mxu_profitable(e.dfa.n_states, e.i_max)
               for e in f4.engines]
    check(n["spec_match"] > 0 and n["spec_match_merge"] == 0,
          f"[17b] document_ok did not ride B6: {n}")
    check(not any(product) or (n["onehot_block_maps"] > 0
                               and n["lvec_compose"] > 0),
          f"[17b] the route rule picks the product route for "
          f"{sum(product)} rules, but B8 + B7 did not launch: {n}")
    print(f"[17b] document_ok over the first {len(sub)} docs: "
          f"{rate(len(sub), wall, sum(len(d) for d in sub))}; "
          f"{f4.stats.patterns_scanned} engines run, {f4.stats.early_exits} "
          f"early exits; product route for {sum(product)} of "
          f"{len(product)} rules (Q, I_max: "
          f"{[(e.dfa.n_states, e.i_max) for e in f4.engines]})")
    print(f"[17] 17(b) document_ok launches: {launched(n)}")


def phase17c_blocked(rng, docs, keep):
    """The blocked filter: the rules and 15(b)'s literals up to K in blocks,
    the prefilter on and off, against the unblocked rules and ``re``."""
    import re
    from repro_torch.data import CorpusFilter

    k, k_blk, n_docs = BLOCKED17
    lits = [f"P{i:04x}e" for i in range(k - len(RULES17))]
    pats = list(RULES17) + lits
    # literals of block 0 planted in every fourth document
    firsts = [p.encode() for p in lits[:k_blk - len(RULES17)]]
    sub = plant(docs[:n_docs], 4, firsts, rng)
    lit_re = re.compile("|".join(lits).encode())
    want = keep[:n_docs] & np.array([lit_re.search(d) is None for d in sub])
    n_bytes = sum(len(d) for d in sub)
    for gate in (True, False):
        f = CorpusFilter(pats, k_blk=k_blk, prefilter=gate, device=DEVICE)
        f.scan_batch(sub[:64])    # each block's lowerings
        skipped0 = f.batch.prefilter_skipped_blocks
        reset_kernel_launches()
        got, wall = synced(lambda: np.array(f.scan_batch(sub)))
        n = kernel_launches()
        check(np.array_equal(got, want), f"[17c] prefilter {gate}: masks "
              "differ from the 7 rules and the planted literals through re")
        print(f"[17c] K={k} in {f.batch.n_blocks} blocks of {k_blk}, "
              f"prefilter {'on ' if gate else 'off'}: {len(sub)} docs in "
              f"{wall:.3f} s, {n_bytes / wall / 1e6:.1f} MB/s; skipped "
              f"blocks {f.batch.prefilter_skipped_blocks - skipped0}; "
              f"dropped {int((~got).sum())}; launches: {launched(n)}")


def phase17_autotune_and_filter(rng, ps, docs, want3):
    """Autotuning (a) and the corpus-filter data path (b, c) on the card."""
    import re
    import shutil
    import tempfile
    from repro_torch.data import CorpusConfig, generate_documents

    tmp = tempfile.mkdtemp(prefix="chip_smoke17_")
    try:
        phase17a_autotune(ps, docs, want3, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_docs, doc_len = CORPUS17
    corpus, wall = synced(lambda: list(generate_documents(CorpusConfig(
        n_documents=n_docs, doc_len=doc_len, contaminant=b"SECRET-123",
        contaminant_rate=0.1, seed=SEED))))
    n_bytes = sum(len(d) for d in corpus)
    rules = [re.compile(r.encode()) for r in RULES17]
    hits, re_wall = synced(lambda: np.array(
        [[r.search(d) is not None for r in rules] for d in corpus]))
    keep = ~hits.any(axis=1)
    planted = np.array([b"SECRET-123" in d for d in corpus])
    print(f"[17b] generate_documents: {n_docs} x {doc_len} bytes "
          f"({n_bytes} bytes) in {wall:.2f} s on the host; re.search of "
          f"the {len(rules)} rules in {re_wall:.2f} s: hits per rule "
          f"{hits.sum(axis=0).tolist()}, {int((~keep).sum())} docs to drop "
          f"({int(planted.sum())} hold the planted SECRET-123)")
    phase17b_filter(corpus, keep)
    phase17c_blocked(rng, corpus, keep)


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
    for stem, args in (("flash_attn", ""), ("onehot_match", ""),
                       ("dfa_match", " (table in shared memory/B6 0, B1 1, "
                                     "B2 2)")):
        res = kernel_resources(_build.build_logs.get(stem, ""))
        print(f"[1] {stem} registers / spill-store bytes per template "
              f"instance{args}: " + ", ".join(f"{k}: {r} / {sp}"
                                             for _, k, r, sp in res))
    res = kernel_resources(_build.build_logs.get("lvec_compose", ""))
    print("[1] lvec_compose registers / spill-store bytes per kernel "
          "instance (B3 compose_carry<lanes a thread>, B4 compose_tree, B7 "
          "lvec_compose<states a thread>, and the instances past shared "
          "memory): "
          + ", ".join(f"{n}<{k}>: {r} / {sp}" if k else f"{n}: {r} / {sp}"
                      for n, k, r, sp in res))

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
            mp = dfa_match.merge_plan(b, c, init.shape[-1],
                                      *dt.table_pad_t.shape, body.shape[-1],
                                      512)
            print(f"[2] {name} r={r}: a cluster of {mp['cluster']} CTAs per "
                  f"document ({mp['rows']} chunks each, {mp['ctas']} CTAs), "
                  f"{dfa_match.LPT} lanes per thread, {mp['cons']} consumer "
                  f"threads + a producer warp, {mp['passes']} pass(es), "
                  f"ring tile {mp['tile']} symbols, {mp['smem']} B of shared "
                  "memory")
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
                        main_inputs[name] = (args, skip, ms, plain_ms, mp)
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
    want3 = res.final_states
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
        args, skip, ms, plain_ms, mp = main_inputs[name]
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
              f"{SMEM_LOADS_PER_S / 1e12:.3f} T/s), share of bound "
              f"{max(t_bytes, t_ops) / ms:.3f}; cluster {mp['cluster']}, "
              f"{dfa_match.LPT} lanes per thread")

    # -- phase 8: B3/B4 against their plain versions, real lane maps ---------
    mg = Matcher(ps, num_chunks=8, batch_tile=1024, device=DEVICE)
    dt = mg.dev
    check(dt.spec_r == 2, f"PCRE-14 resolved r={dt.spec_r}, expected 2")
    cidx, sinks = dt.cidx_pad_t, dt.sinks_t
    k, s = packed.n_patterns, dt.i_max
    err8 = 0
    for nb, nn in RUNS8 + CALLS8:
        maps, keys = lane_runs(mg, rng, nb, nn, SEG8)
        lanes = torch.from_numpy(maps).to(DEVICE)
        kt = torch.from_numpy(keys).to(DEVICE)
        args8 = (lanes, kt, cidx, sinks)
        kw = dict(pad_key=dt.pad_key)
        oracle = ref.spec_compose_lanes_ref(maps, keys, cidx.cpu().numpy(),
                                            packed.sinks, pad_cls=dt.pad_key)
        mask = real_lane_mask(dt.tables, keys[:, 0])
        placements = [("carry", lvec_compose.spec_compose_lanes_cuda,
                       lvec_compose.spec_compose_lanes_torch),
                      ("tree", lvec_compose.spec_compose_lanes_tree_cuda,
                       lvec_compose.spec_compose_lanes_tree_torch)]
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
        for mode, kern, plain in placements:
            want = plain(*args8, **kw)
            plain_ms = cuda_ms(lambda: plain(*args8, **kw), 1)
            call = lambda: kern(*args8, **kw)
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
            dev_ms = kernel_device_ms(call, "compose_carry" if mode == "carry"
                                      else "compose_tree", 20)
            if mode == "carry":
                plan = lvec_compose.carry_plan(nb, nn, cidx.shape[1], k, s)
                how = (f"{plan['runs']} runs x {plan['tile']} elements a "
                       f"tile, {plan['cons']} consumer threads")
            else:
                plan = lvec_compose.tree_plan(nb, nn, cidx.shape[1], k, s)
                how = tree_how(plan)
                if dev_ms is not None and plan["folds"] > 1:
                    dev_ms *= 2   # two launches a call (see phase 13's B7)
            print(f"[8] compose {mode:5s} B={nb} N={nn} ({real} real "
                  f"combines) kernel {ms:.4f} ms per call "
                  f"({device_share(dev_ms, bound['bound_ms'])})"
                  f"  plain {plain_ms:.3f} ms  bound {bound['bound_ms']:.4f} "
                  f"ms ({bound['bound_by']}; bytes {t_bytes:.4f}, operations "
                  f"{t_ops:.4f})  equal; plan: {how}, {plan['ctas']} CTAs, "
                  f"{plan['smem']} B of shared memory")
            # each kernel's line: the largest of phase 9's calls
            if (nb, nn) == CALLS8[0]:
                name = ("spec_compose_lanes" if mode == "carry"
                        else "spec_compose_lanes_tree")
                kernels[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/lvec_compose.cu",
                    replaces="src/repro/kernels/lvec_compose.py:"
                             f"{95 if mode == 'carry' else 171}",
                    launches=None, max_abs_err=None, ms=ms, plain_ms=plain_ms,
                    **bound, library_ms=None)
    # B3's wide instance: random operands at PS00028's shape (a key row and
    # a lane map past the ring), against its plain version
    nb, nn, qw, kw8, sw, nk = WIDE8
    check(lvec_compose.carry_plan(nb, nn, qw, kw8, sw)["wide"],
          "B3 at PS00028's shape did not take its wide instance")
    cw = rng.integers(-1, sw, size=(nk + 1, qw))
    cw[-1] = -1
    ops8 = [rng.integers(0, qw, size=(nb, nn, kw8, sw)),
            rng.integers(0, nk + 1, size=(nb, nn)), cw,
            rng.integers(0, qw, size=kw8)]
    args8 = tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32))
                  .to(DEVICE) for x in ops8)
    want = lvec_compose.spec_compose_lanes_torch(*args8, pad_key=nk)
    plain_ms = cuda_ms(
        lambda: lvec_compose.spec_compose_lanes_torch(*args8, pad_key=nk), 1)
    call = lambda: lvec_compose.spec_compose_lanes_cuda(*args8, pad_key=nk)
    got = call()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    err8 = max(err8, err)
    check(err == 0, f"wide carry compose B={nb} N={nn} Q={qw} S={sw}: kernel "
          "differs from its plain version")
    ms = cuda_ms(call, 20)
    dev_ms = kernel_device_ms(call, "compose_carry", 20)
    real = int((ops8[1][:, 1:] != nk).sum())
    combines = real * kw8 * sw
    t_bytes = 4 * ((nb + real) * kw8 * sw + nb * nn + nb * kw8 * sw
                   + min(cw.size, combines)) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * combines / SMEM_LOADS_PER_S * 1e3
    print(f"[8] compose carry/wide B={nb} N={nn} Q={qw} K={kw8} S={sw} "
          f"({real} real combines) kernel {ms:.4f} ms per call "
          f"({device_share(dev_ms, max(t_bytes, t_ops))})  plain "
          f"{plain_ms:.3f} ms  bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})  equal; plan: "
          f"wide, {lvec_compose.carry_plan(nb, nn, qw, kw8, sw)['ctas']} "
          "CTAs, rows and maps from global memory")
    # B4's wide instance on the same operands (N = 8, a power of two)
    check(lvec_compose.tree_plan(nb, nn, qw, kw8, sw)["wide"],
          "B4 at PS00028's shape did not take its wide instance")
    want = lvec_compose.spec_compose_lanes_tree_torch(*args8, pad_key=nk)
    plain_ms = cuda_ms(
        lambda: lvec_compose.spec_compose_lanes_tree_torch(*args8,
                                                           pad_key=nk), 1)
    call = lambda: lvec_compose.spec_compose_lanes_tree_cuda(*args8,
                                                             pad_key=nk)
    got = call()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    err8 = max(err8, err)
    check(err == 0, f"wide tree compose B={nb} N={nn} Q={qw} S={sw}: kernel "
          "differs from its plain version")
    ms = cuda_ms(call, 20)
    dev_ms = kernel_device_ms(call, "compose_tree", 20)
    print(f"[8] compose tree/wide B={nb} N={nn} Q={qw} K={kw8} S={sw} "
          f"({real} real combines) kernel {ms:.4f} ms per call "
          f"({device_share(dev_ms, max(t_bytes, t_ops))})  plain "
          f"{plain_ms:.3f} ms  bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})  equal; plan: "
          f"wide, {nb} CTAs, the levels in global memory")
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
    counts, rates9 = {}, {}

    def ooo_run(matcher, plans, tag, shapes=None):
        """``shapes`` collects the (B, N) of every B3 call."""
        ooo = OooStreamMatcher(matcher, policy=policy)
        dfa_match.reset_launches()
        lvec_compose.reset_launches()
        carry = lvec_compose.spec_compose_lanes_cuda
        if shapes is not None:
            def recording(lanes, *args, **kw):
                shapes.append(tuple(lanes.shape[:2]))
                return carry(lanes, *args, **kw)
            lvec_compose.spec_compose_lanes_cuda = recording
        try:
            res = run_streams(ooo, docs9, plans, seg9)
        finally:
            lvec_compose.spec_compose_lanes_cuda = carry
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
        return STREAMS9 * DOC9 / wall / 1e6

    for frac in FRACS9:
        tag = f"[9] shuffle {frac:g}:"
        plans = arrival_plans(np.random.default_rng(41), STREAMS9, SEGS9,
                              frac)
        shapes = []
        st, launched = ooo_run(m9, plans, tag, shapes)
        print(f"{tag} {STREAMS9} streams equal whole-document matching; "
              f"scan_folds {st.scan_folds}, scan_batch {st.scan_batch:.2f}, "
              f"gap_closes {st.gap_closes}, peak_buffered_segments "
              f"{st.peak_buffered_segments}, spec_matched {st.spec_matched}, "
              f"launches {launched}")
        if shapes:
            print(f"{tag} B3 calls (B, N): {shapes}")
        if frac == 0.0:
            check(st.spec_matched == 0 and st.scan_folds == 0
                  and launched["spec_compose_lanes"] == 0,
                  "in-order streams parked or composed")
        else:
            check(launched["spec_compose_lanes"] > 0,
                  f"{tag} launched no B3 kernel")
        rates9[frac] = timed_run(m9, plans, tag)
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
    calls = mt.perf_report()["compose_calls"]
    check(launched["spec_compose_lanes_tree"] > 0
          and launched["spec_compose_lanes"] == 0
          and mt.perf_report()["compose_lowering"] == "compose-kernel-tree",
          f"the tree run did not ride B4: {launched}")
    # its calls have N <= 16, which B4's plan never splits: one launch each
    check(launched["spec_compose_lanes_tree"] == calls,
          f"the tree run's {calls} compose calls launched B4 "
          f"{launched['spec_compose_lanes_tree']} times")
    counts["spec_compose_lanes_tree"] = launched["spec_compose_lanes_tree"]
    print(f"[9] tree compose, shuffle 1: equal; scan_folds {st.scan_folds}, "
          f"compose calls {calls}, B4 launches "
          f"{launched['spec_compose_lanes_tree']}")
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

    # -- phase 15: hot swap and the pattern-set scale tier --------------------
    t0 = time.perf_counter()
    phase15_swap_and_scale(rng, ps, docs, search)
    print(f"[15] phase 15 in {time.perf_counter() - t0:.1f} s")

    # -- phase 16: stream failover --------------------------------------------
    t0 = time.perf_counter()
    phase16_failover(np.random.default_rng(SEED + 16), ps, docs, m, docs9,
                     want9, rates9[0.25])
    print(f"[16] phase 16 in {time.perf_counter() - t0:.1f} s")

    # -- phase 17: autotuning and the corpus-filter data path -----------------
    t0 = time.perf_counter()
    phase17_autotune_and_filter(np.random.default_rng(SEED + 17), ps, docs,
                                want3)
    print(f"[17] phase 17 in {time.perf_counter() - t0:.1f} s")
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
