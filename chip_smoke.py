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
     plain version and the two-call ``torch.where`` gather-and-select, and
     an empty kernel's device time beside its own; time ``ops.token_mask``
     per call outside a census and with one recording, interleaved;
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
     PII rules over 4,096 generated documents of 2,048 bytes: ``filter()``
     at batch sizes 64 and 1,024, ``data_stream`` into packed batches,
     ``scan_stream`` over 256 concurrent downloads in 1,024-byte chunks and
     ``document_ok`` over 256 documents (B6, or B8 + B7), each keep-mask
     equal to Python's ``re``, ``backend="local"`` on the card with equal
     ``FilterStats``, docs/s and MB/s of each, the launches of each and the
     device idle share of one ``filter()`` pass; (c) the rules and 15(b)'s
     literals up to K = 512 in blocks of 32, prefilter on and off, over
     2,048 documents with planted literals, equal to ``re``;
 18. the sharded backend (``Matcher(backend="sharded")``, B6 scans, B3
     folds) over phase 3's corpus: (a) mesh (1, 1), a world of one on NCCL
     in this process: finals equal ``backend="cuda"``'s, B6 and B3 launched
     inside the call and held bit for bit against their plain versions at
     one tile's operands (CUDA-event and device ms, bound, share), warm
     calls in turns against ``backend="cuda"``, the device idle share; (b)
     mesh (2, 2) as four processes sharing the card over gloo (``python3
     chip_smoke.py --phase18-child ...``, each under a time limit; the
     kernels built here are only loaded there): uniform, then
     ``capacities=synthetic_capacities(4, ratio=1.41)``, then
     ``rebalance`` to a permuted profile, each first and warm call timed,
     finals equal ``backend="cuda"``'s, per rank the device work against
     the Eq. 1 weights and the bytes and ms of the lane-state gathers over
     "chunk" and the row collections over "doc"; (c) phase 16(a)'s 256
     sessions on the (2, 2) matcher snapshot mid-stream (one rank writes)
     and restored on (a)'s (1, 1) matcher and on ``backend="cuda"``, closed
     results equal the whole documents';
 19. every model family at full published width, random f32 weights from
     a seeded generator on the card, one model at a time (each freed
     before the next), with its parameter count, wall times and tokens/s,
     the device idle share of a profiled call, peak device memory and
     B9/B5 launches (added to the kernels line's counts): (a)
     granite-moe-1b-a400m: ``api.prefill`` B = 2, T = 2,048 (B9 once per
     layer) against the blockwise route, phase 12's constrained
     ``generate`` (B5 once a step; every row a live prefix; tokens equal
     with ``use_kernel=False``), the eager decode step and ``launch.serve
     --arch``; (b) internvl2-2b likewise, its prefill 256 patch embeddings
     + 1,792 tokens (B9 at D = 128); (c) seamless-m4t-medium: prefill of
     frames [4, 1,024, 1,024] and tokens [4, 1,024] (B9 on the decoder's
     self-attention) against the blockwise route, then 32 eager
     ``api.decode`` steps from that cache against the encoded memory; (d)
     recurrentgemma-2b: prefill B = 4, T = 2,048 (no kernel), 32 decode
     steps, and teacher-forced decode over 64 tokens against
     ``train_logits`` within the JAX package's envelope (rtol = atol =
     3e-2, argmax agreement > 0.9); (e) xlstm-1.3b likewise (atol 0.15),
     with the sLSTM blocks' share of the prefill;
 20. training on the card: (a) tinyllama-1.1b at full width, random f32
     weights (seed 0), ``training.make_train_step`` in this process on 16
     x 4,096 tokens a step in 4 microbatches, remat "nothing", AdamW at the
     launcher's settings, on batches of ``launch.train``'s data flow (the
     synthetic corpus through ``CorpusFilter``, B1): 4 stream steps, then
     2 more on the last batch (the loss must fall), each step's wall time,
     tokens/s and share of 989.4 TFLOP/s, peak device memory, the idle
     share of a profiled one-microbatch step, B1's launches (added to the
     kernels line's count) and the filter's decisions against
     ``backend="local"`` on the same documents; (b) ``python -m
     repro_torch.launch.train`` at (a)'s width cut to ``LAYERS_CLI``
     layers (``--layers``) for 1 step, checkpointed, then ``--resume``
     for 1 more, each line equal within ``LINE20_TOL`` to the same step
     of the launcher's stream, state and options run in this process;
     the saves' blocking and the restore times; a ``RestartManager`` run
     of the reduced model with a
     fault injected at step 3, recovered to the final step; (c) one AdamW
     step of granite-moe-1b-a400m, internvl2-2b, recurrentgemma-2b,
     xlstm-1.3b and seamless-m4t-medium at full width on ~4,096 tokens,
     one model at a time: step time, peak memory, finite loss, aux loss
     and gradients; (d) one step of the reduced tinyllama from one
     converted state on the card and on the CPU: loss within 1e-3 and
     grad_norm within 2e-2 relative, parameters within 2 lr;
 21. the LM mesh: eight ``--phase21-child`` ranks sharing the card over
     gloo on ("pod", "data", "model") = (2, 2, 2), each running its share
     of the partitioned program (its rows over the data axes, tensor and
     expert parallelism over "model"; see ``phase21_mesh``; 21(f) the
     hybrid, ssm and enc-dec families; 21(g) the same eight ranks on
     ("data", "model") = (1, 8), where recurrentgemma-2b's attention and
     xlstm-1.3b's mLSTM split head_dim; the train steps of (c), (d) and
     (f) reduce the loss over "model" and gather no logits there;
     ``python3 chip_smoke.py --phase21 g`` runs a part alone);
 22. the analysis tools (``repro_torch.launch.{census,dryrun,roofline}``),
     run where phases 12 and 20(a) hold their models, so none is
     initialised again: (a) after 20(a)'s steps, one more train step of
     its shape (8 x 4,096 tokens, 2 microbatches) under
     ``census.trace_census`` on the real state, its dot flops, op counts,
     collectives and kernels equal to the dry run's trace of the same
     one-card step (``dryrun.trace_one_card``: the card's program on fake
     CPU tensors, the dry run's one route; in a ``--phase22-traces``
     subprocess at the lowest priority with no card visible, started
     before phase 19, so its host work overlaps phases 19 and 20(a) and
     none of the kernel phases), the trace's predicted peak memory against
     ``max_memory_allocated`` within ``MEM22``, 20(a)'s measured step's
     share of the step's bound (its flops at the bf16 rate against its
     state and batch moved once) and the census's roofline row on H100
     constants (``roofline.analyze_record``); (b) after phase 12's prefill
     comparison, one of its ``api.prefill`` calls (B = 4, T = 2,048) under
     the census: 22 B9 launches, the counter moved by 22, flops and dot
     flops equal to the dry run's trace of the same call (in this process,
     launching nothing);
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
SCAN14, BAL14, SMALL14 = 32 << 20, 8 << 20, 1 << 20   # 14(a), (b), (c)/(d)
HEAD14C = 64 << 10                   # 14(c): bytes of the cross-checks
HEAD14 = 256 << 10                   # 14(a), (b), (d): bytes of the same
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
CORPUS17 = (4096, 2048)              # 17(b): documents, bytes each (8 MiB)
BATCH17 = (64, 1024)                 # 17(b): filter() batch sizes
LOADER17 = (8, 2048)                 # 17(b): data_stream batch, seq_len
STREAM17 = (256, 1024, 64, 8)        # 17(b): open downloads, chunk bytes,
                                     # max_batch, max_delay
DOCOK17 = 256                        # 17(b): document_ok documents
BLOCKED17 = (512, 32, 2048)          # 17(c): K, k_blk, documents
MESH18 = (2, 2)                      # 18(b): the spawned world's mesh
RATIO18 = 1.41                       # 18(b): the fast half's capacity
CHILD18_S = 240                      # 18(b): each rank's time limit, s
ARCH19 = (("moe", "granite-moe-1b-a400m"), ("vlm", "internvl2-2b"),
          ("encdec", "seamless-m4t-medium"), ("hybrid", "recurrentgemma-2b"),
          ("ssm", "xlstm-1.3b"))         # phase 19: one model a family
PREFILL19 = {"moe": (2, 2048), "vlm": (2, 2048),  # B, seq_len (vlm: 256
             "encdec": (4, 2048)}        # patches; encdec: 1,024 + 1,024)
PREFILL19R = (4, 2048)                # 19: hybrid and ssm prefill B, T
LAYERS19 = {"ssm": 24}                # 19: xlstm-1.3b's depth (of 48; its
#                                       widths and block pattern kept)
DECODE19 = 32                         # 19: eager decode steps
ARCH20 = "tinyllama-1.1b"             # phase 20: the trained model
TRAIN20 = (8, 4096, 2)                # 20(a), (b): sequences, tokens, microbatches
STEPS20 = (2, 2)                      # 20(a): stream steps, steps on the last batch
CLI20 = 1                             # 20(b): the first run's --steps and
                                      # --ckpt-every; --resume runs one more
RULES20 = [r"SECRET-[0-9]+"]          # the launcher's default block list
# 20(b): the launcher's printed loss (4 decimals), gnorm (3 decimals) and lr
# (3 significant digits) against (a)'s: half a printed unit of rounding, and
# for loss and gnorm as much again for the run-to-run drift of the
# embedding's backward (an atomic index_put accumulate; measured 2.8e-5 on
# the loss over four steps); lr is relative
LINE20_TOL = {"loss": 1e-4, "gnorm": 1e-3, "lr": 5e-3}
DISPATCH10 = (5, 200)                 # 10: rounds x calls of ops.token_mask
# 22(a): the dry run's predicted peak over the measured max_memory_allocated
MEM22 = (0.85, 1.10)
CHILD22_S = 900                       # 22: the fake traces' time limit, s
LEAF20_TOL = 0.1                      # 20(d): a moment leaf's relative L2
CLI20_S = 600                         # 20(b): each launcher run's time limit, s
LAYERS_CLI = 2                        # 20(b), 21(d): the launcher's depth
                                      # (published widths; --layers)
FAULT20 = (6, 3, 2)                   # 20(b): steps, the failing step, ckpt every
SMALL20 = (4, 256)                    # 20(b) fault run and (d): batch, seq_len
FAMILIES20 = (("moe", "granite-moe-1b-a400m"), ("vlm", "internvl2-2b"),
              ("hybrid", "recurrentgemma-2b"), ("ssm", "xlstm-1.3b"),
              ("encdec", "seamless-m4t-medium"))   # 20(c), one at a time
SHAPE20C = {"ssm": (4, 1024)}         # 20(c): B, seq_len (~4,096 tokens; the
SHAPE20 = (2, 2048)                   # xLSTM's sLSTM loop a step a token)
MESH21 = (2, 2, 2)                    # 21: ("pod", "data", "model"), gloo
PARTS21 = "abcdefg"                   # 21: every part (--phase21 PARTS: some)
CHILD21_S = 600                       # 21: each rank's time limit, s
BYTES21 = 64 << 20                    # 21(a): the class stream, bytes
NC21 = (4, 64)                        # 21(a): chunks a data-parallel rank
PCRE21 = "keyword_alt"                # 21(a): Q = 27 (B8 + B7)
RANDOM21 = (512, 16)                  # 21(a): Q, classes (B6)
PIPE21 = (4, 8, 1024)                 # 21(a): stages, microbatches, width
ARCH21 = "granite-moe-1b-a400m"       # 21(b), (c)
PREFILL21 = (8, 2048)                 # 21(b): prompts, tokens (B9)
LAYERS21 = 2                          # 21(b): granite-moe's depth (of 24)
PROMPT21 = 64                         # 21(b): generate's prompt bytes
DECODE21 = 16                         # 21(b): constrained decode steps (B5)
MISMATCH21 = (0.05, 3e-2)             # 21(b): the reference test's rule
#                                       (share of entries, atol)
ARCH21E = "tinyllama-1.1b"            # 21(e): full width
LAYERS21E = 3                         # 21(e): its depth (of 22; cut to make
#                                       room for 21(f) and (g))
PREFILL21E = (8, 2048)                # 21(e): prompts, tokens (B9, bf16)
DECODE21E = 8                         # 21(e): constrained steps (B5)
# 21(e): the prefill's logits against one process, max |gap| over the
# largest |logit|: float32 compute (tensor parallelism sums each block's
# heads and hidden columns in another order), and bf16 (each rank's
# partial sums round to bf16 before the sum, 2^-8 a rounding, over 22
# layers; the reference test's rule, share < 0.05 beyond 3e-2, is set for
# reduced configs: at this depth an H100 run read a share of 0.066)
F32_21E = 1e-4
BF16_21E = 5e-2
TRAIN21 = (8, 512, 2, 2)              # 21(c): rows, tokens, microbatches,
#                                       layers (depth cut from 24: 8 ranks'
#                                       expert shards, moments and
#                                       checkpoint on one card)
CLI21 = (4, 512, 2)                   # 21(d): batch, seq, steps
CLI21_S = 600                         # 21(d): each launcher's time limit, s
# 21(d): the mesh launcher against one process, bf16 compute (the bf16
# loss and norm tolerances of tests/test_torch_training.py; gnorm, lr
# relative: lr printed to 3 digits)
LINE21_TOL = {"loss": 2e-3, "gnorm": 5e-3, "lr": 5e-3}
# 21(c): the sharded step and the step after the restore against one
# process, both in float32 compute (bf16 compute rounds the embedding's
# gradient as it accumulates a token's rows: one process and a rank
# accumulate different rows, v of the table then differs by 0.1 relative
# L2 at reduced size on the CPU): loss, grad_norm relative, each moment
# leaf's relative L2 (a shard on the wrong rank gives ~1)
F32_21 = {"loss": 1e-4, "gnorm": 1e-4, "leaf": 1e-3}
# 21(f): the hybrid, ssm and enc-dec families at published widths on the
# partitioned program, one model at a time, depth cut: recurrentgemma-2b
# to one stacked (rglru, rglru, attn) group and a 1-block tail (both
# paths run; 5 layers before 21(g) took the room), xlstm-1.3b to one
# group (7 mLSTM and its sLSTM), seamless-m4t-medium to 4 encoder and 4
# decoder layers
FAMILIES21F = (("hybrid", "recurrentgemma-2b"), ("ssm", "xlstm-1.3b"),
               ("encdec", "seamless-m4t-medium"))
LAYERS21F = {"hybrid": 4, "ssm": 8, "encdec": 4}
PREFILL21F = {"hybrid": (8, 512), "ssm": (8, 512), "encdec": (8, 1024)}
DECODE21F = 2                         # 21(f): float32-compute decode steps
# 21(f): recurrentgemma-2b's tensor-parallel step (rows, tokens; one
# microbatch) on the same eight ranks as ("data", "model") = (2, 4), where
# its 10 query heads do not divide 4 and its attention splits head_dim:
# on (2, 2, 2) the pods would each hold a quarter of its 256k-vocab
# embedding and head with their moments (~10 GiB a rank with the step's
# gathers, an estimate: 8 ranks past one 80 GB card); (2, 4) holds an
# eighth (the (4, 2) layout, heads split, stays held on the CPU by
# tests/test_torch_tp.py)
TRAIN21F = (8, 256)
MESH21F = (2, 4)
# 21(g): recurrentgemma-2b and xlstm-1.3b at published widths on the same
# eight ranks as ("data", "model") = (1, 8): 10 and 4 heads do not divide
# 8, so the attention (and its ring) and the mLSTM (and its C, n) split
# head_dim; depth cut to one (rglru, rglru, attn) group and to one group
# of 7 mLSTM and an sLSTM; each rank all the rows (data = 1)
MESH21G = (1, 8)
LAYERS21G = {"hybrid": 3, "ssm": 8}
PREFILL21G = {"hybrid": (8, 512), "ssm": (8, 512)}
# 21(c): the sharded step's collectives over "model", [calls, MB, ms] of
# rank 0, as an earlier run of this script read them with the logits
# all-gathered over "model" for the loss (NVIDIA H100 80GB HBM3, 700.00
# W); the vocab-parallel loss reduces [rows, T] floats instead (21(f)'s
# step then ran on (4, 2): PERF.md keeps its numbers)
GATHERED21 = {
    "c": {"all_gather model": [14, 109.707, 503.647],
          "all_reduce model": [20, 33.554, 209.348],
          "all_to_all model": [24, 805.306, 1624.296]}}
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


def device_busy(fn, tag, margin=0.0, cpu=True):
    """Run ``fn`` once under torch.profiler; print its wall time, the device
    busy time (device-side events only: kernels and copies — an aten op's
    own device time repeats its kernels', and the profiler's buffer
    requests are its own overhead), the device idle share of the wall time
    and the largest kernels.  Returns the idle share (None when the
    profiler recorded no device time).  The device is idle when the
    profile opens.  ``margin`` idle seconds inside the profile before and
    after the call, outside the timed wall: late in a long process (phase
    14) the profiler can otherwise drop the device records of a call that
    starts or ends close to the profile's own start or stop.  ``cpu=False``
    traces the device alone (no host op events): a call of ~10^5 kernels
    then takes seconds, not a minute, to process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=([ProfilerActivity.CPU] if cpu else [])
                 + [ProfilerActivity.CUDA]) as prof:
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


def kernel_device_ms(fn, name, iters, margin=0.0):
    """Mean device time of one launch of the kernels whose name contains
    ``name``, over ``iters`` calls of ``fn`` under torch.profiler (None if
    the profiler recorded none); ``margin`` idle seconds inside the
    profile before and after, as ``device_busy`` takes them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin)
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
            first = (dev_ms, bound)
            kernels["token_mask"] = dict(
                name="token_mask", route="cuda",
                source="src/repro_torch/kernels/csrc/token_mask.cu",
                replaces="src/repro/kernels/token_mask.py:28",
                launches=None, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=lib_ms)
    # an empty kernel (torch's spin kernel for 0 cycles): the least device
    # time a launch takes, beside B5's at the main path's shape
    empty_ms = kernel_device_ms(lambda: torch.cuda._sleep(0), "spin_kernel",
                                20)
    dev_ms, bound = first
    print(f"[10] an empty kernel (torch.cuda._sleep(0)): device time "
          f"{'n/a' if empty_ms is None else f'{empty_ms:.5f} ms'} a launch; "
          f"B5 at B={MASK10[0][0]} V={MASK10[0][1]}: "
          f"{device_share(dev_ms, bound)} (bytes only)")
    phase10_dispatch_cost(gc, rng)


def phase10_dispatch_cost(gc, rng):
    """B5 through ``kernels.ops`` at the main path's shape, per call,
    outside a census and with one recording (what ``ops._dispatch`` then
    adds: the launch counted with its operands' bytes), interleaved."""
    import torch
    from repro_torch.kernels import census_hooks, ops
    from repro_torch.launch.census import Census

    b, v, dtype = MASK10[0]
    states = torch.from_numpy(rng.integers(
        0, gc.allowed.shape[0], size=b).astype(np.int32)).to(DEVICE)
    allowed = torch.nn.functional.pad(gc.allowed,
                                      (0, v - gc.allowed.shape[1]))
    logits = torch.randn(b, v, device=DEVICE).to(getattr(torch, dtype))
    call = lambda: ops.token_mask(states, allowed, logits)
    census = Census()

    def counted():
        with census_hooks.recording(census):
            return call()
    for _ in range(3):
        call()
        counted()
    times = {"outside": [], "recording": []}
    for _ in range(DISPATCH10[0]):
        times["outside"].append(cuda_ms(call, DISPATCH10[1]))
        times["recording"].append(cuda_ms(counted, DISPATCH10[1]))
    out, rec = (float(np.median(times[k])) for k in ("outside", "recording"))
    n = census.kernels["token_mask"]["launches"]
    check(n == DISPATCH10[0] * DISPATCH10[1] + 3,
          f"[10] the recording census counted {n} B5 launches")
    print(f"[10] ops.token_mask B={b} V={v} {dtype}: {out:.5f} ms per call "
          f"outside a census, {rec:.5f} ms with one recording (median of "
          f"{DISPATCH10[0]} x {DISPATCH10[1]} calls each, interleaved)")


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
    phase22b_prefill_census(params, cfg, batch)

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
    device_busy(lambda: eng.generate(prompts), "[12] generate", cpu=False)
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
                  [("lookahead/uniform", eng)], HEAD14, walls)
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
        check_dfa("[14b]", name, search[name], doc, routes, HEAD14, walls)
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
        check_dfa("[14d]", name, dfa, doc, routes, HEAD14, walls)
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


def stream_pieces(rng, docs):
    """Phase 16(a)'s sessions over ``docs`` (the last ``KEYED16`` keyed
    after ``HEAD16`` bytes): each body's cut points into four ragged parts
    ([N, 5]) and which sessions keep part 2 pending at the snapshot."""
    n_exact = len(docs) - KEYED16
    bodies = docs[:n_exact] + [d[HEAD16:] for d in docs[n_exact:]]
    cuts = np.array([parts4(rng, len(b)) for b in bodies], np.int64)
    late = np.array([i % 3 == 2 for i in range(len(docs))])
    return cuts, late


def sessions_first_half(sm, docs, cuts, late):
    """Open phase 16(a)'s sessions on ``sm``, feed parts 1 and 2 with
    part 2 of every third session still pending; returns the sessions."""
    n_exact = len(docs) - KEYED16
    keys = [sm.matcher.dev.advance_key(-1, d[:HEAD16])
            for d in docs[n_exact:]]
    bodies = docs[:n_exact] + [d[HEAD16:] for d in docs[n_exact:]]
    sessions = ([sm.open() for _ in range(n_exact)]
                + [sm.open_at(k) for k in keys])
    for sess, b, c in zip(sessions, bodies, cuts):
        sess.feed(b[c[0]:c[1]])
    sm.flush()
    for sess, b, c, lt in zip(sessions, bodies, cuts, late):
        if not lt:
            sess.feed(b[c[1]:c[2]])
    sm.flush()
    for sess, b, c, lt in zip(sessions, bodies, cuts, late):
        if lt:
            sess.feed(b[c[1]:c[2]])
    return sessions


def phase18_child(argv):
    """One rank of phase 18(b)'s (2, 2) world (``python3 chip_smoke.py
    --phase18-child rank world store data out snapshot_dir``): four
    processes share the card over gloo.  Writes its measurements as JSON."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.core import PCRE_PATTERNS, Matcher, PatternSet
    from repro_torch.core.profiling import (profile_workers,
                                            synthetic_capacities)
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as lmesh
    from repro_torch.streaming import StreamMatcher, TickPolicy

    rank, world = int(argv[0]), int(argv[1])
    store, data_path, out_path, snap_dir = argv[2:6]
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=CHILD18_S))
    try:
        _build.build_all()   # the parent's build: loaded, not compiled
        z = np.load(data_path)
        off = z["off"]
        docs = [bytes(z["docs"][a:b]) for a, b in zip(off[:-1], off[1:])]
        want = z["want"]
        ps = PatternSet(PCRE_PATTERNS, k_blk=64)
        dev = None if DEVICE == "cuda" else DEVICE   # None: LOCAL_RANK's card
        mesh = lmesh.make_matcher_mesh(shape=MESH18, device=dev)
        gathers = {}
        plain_gather = lmesh.all_gather_rows

        def timed_gather(mesh_, x, axis=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = plain_gather(mesh_, x, axis)
            torch.cuda.synchronize()
            g = gathers.setdefault(axis or "mesh", [0, 0, 0.0])
            g[0] += 1
            g[1] += x.numel() * x.element_size()
            g[2] += time.perf_counter() - t0
            return y

        def call(m, tag, out):
            res, wall = synced(lambda: m.membership_batch(docs))
            check(np.array_equal(res.final_states, want),
                  f"[18b] rank {rank} {tag}: finals differ from "
                  "backend='cuda'")
            out[tag] = wall
            return res

        def measured(m, caps):
            """First call, warm call, then a call with timed gathers and
            counted launches."""
            out = {}
            call(m, "first_s", out)
            call(m, "warm_s", out)
            gathers.clear()
            reset_kernel_launches()
            lmesh.all_gather_rows = timed_gather
            try:
                res = call(m, "timed_s", out)
            finally:
                lmesh.all_gather_rows = plain_gather
            out["launches"] = {k: v for k, v in kernel_launches().items()
                               if v}
            out["gathers"] = {k: list(v) for k, v in gathers.items()}
            out["tiles"] = res.bucket_calls
            out["device_work"] = res.device_work.tolist()
            out["weights"] = (profile_workers(caps).tolist()
                              if caps is not None else [1.0] * world)
            return out

        rep = {"rank": rank}
        kw = dict(backend="sharded", mesh=mesh, num_chunks=8, batch_tile=64,
                  device=dev)
        m = Matcher(ps, **kw)
        rep["mesh"] = m.perf_report()["mesh"]
        rep["uniform"] = measured(m, None)
        caps = synthetic_capacities(world, ratio=RATIO18)
        mw = Matcher(ps, capacities=caps, **kw)
        rep["weighted"] = measured(mw, caps)
        caps2 = np.roll(caps, 1)
        mw.rebalance(caps2)
        rep["rebalanced"] = measured(mw, caps2)
        # (c): phase 16(a)'s sessions, snapshot mid-stream, one writer
        sm = StreamMatcher(Matcher(ps, **kw), lane_ticks=True,
                           policy=TickPolicy(max_batch=1 << 30,
                                             max_delay=1 << 30))
        sessions = sessions_first_half(sm, docs, z["cuts"], z["late"])
        path, rep["snapshot_s"] = synced(lambda: sm.snapshot(snap_dir))
        rep["sids"] = [s.sid for s in sessions]
        rep["snapshot_seen"] = os.path.isdir(path)
        with open(out_path, "w") as fh:
            json.dump(rep, fh)
    finally:
        dist.destroy_process_group()
    return 0


def phase18a_mesh11(ps, docs, want3, m3):
    """(a) The sharded backend on a (1, 1) mesh: a world of one on NCCL in
    this process.  B6 and B3 launch inside the call and equal their plain
    versions at one tile's operands."""
    import torch
    from repro_torch.core import Matcher
    from repro_torch.kernels import dfa_match, lvec_compose

    n_bytes = sum(len(d) for d in docs)
    # device None: the card, and a world of one on NCCL
    ms = Matcher(ps, backend="sharded", num_chunks=8, batch_tile=64,
                 device=None if DEVICE == "cuda" else DEVICE)
    mesh = ms.perf_report()["mesh"]
    check(mesh["transport"] == ("nccl" if DEVICE == "cuda" else "gloo")
          and mesh["shape"] == [1, 1], f"[18a] mesh {mesh}")
    res, first = synced(lambda: ms.membership_batch(docs))
    check(np.array_equal(res.final_states, want3),
          "[18a] finals differ from backend='cuda'")
    # the counted call, recording the first tile's B6 and B3 operands
    seen = {}
    b6, b3 = dfa_match.spec_match_cuda, lvec_compose.spec_compose_lanes_cuda

    def rec6(*a, **kw):
        seen.setdefault("b6", tuple(x.clone() for x in a))
        return b6(*a, **kw)

    def rec3(*a, **kw):
        seen.setdefault("b3", (tuple(x.clone() for x in a), kw))
        return b3(*a, **kw)

    dfa_match.spec_match_cuda = rec6
    lvec_compose.spec_compose_lanes_cuda = rec3
    reset_kernel_launches()
    try:
        res, wall = synced(lambda: ms.membership_batch(docs))
    finally:
        dfa_match.spec_match_cuda = b6
        lvec_compose.spec_compose_lanes_cuda = b3
    counts = kernel_launches()
    check(np.array_equal(res.final_states, want3),
          "[18a] finals differ from backend='cuda'")
    check(counts["spec_match"] > 0 and counts["spec_compose_lanes"] > 0
          and counts["onehot_block_maps"] == 0
          and counts["spec_match_merge"] == 0,
          f"[18a] the sharded path did not ride B6 and B3 alone: {counts}")
    kinds = sorted(set(ms.perf_report()["lowerings"].values()))
    print(f"[18a] Matcher(PCRE-14, backend='sharded') on mesh (1, 1), "
          f"transport {mesh['transport']}, device {mesh['device']}: first "
          f"call {first:.4f} s, counted call {wall:.4f} s, {res.bucket_calls}"
          f" tiles; launches: {launched(counts)}; lowerings {kinds}; "
          f"collectives {ms.perf_report()['mesh']['collectives']}; finals "
          f"equal backend='cuda'")
    # warm calls, in turns: cuda, sharded, sharded, cuda
    times = {"cuda": [], "sharded": []}
    for name, m in (("cuda", m3), ("sharded", ms), ("sharded", ms),
                    ("cuda", m3)):
        _, t = synced(lambda: m.membership_batch(docs))
        times[name].append(t)
    tc, ts = min(times["cuda"]), min(times["sharded"])
    print(f"[18a] warm calls (cuda, sharded, sharded, cuda): "
          f"{times['cuda'][0]:.4f}, {times['sharded'][0]:.4f}, "
          f"{times['sharded'][1]:.4f}, {times['cuda'][1]:.4f} s; sharded "
          f"{len(docs) / ts:.1f} docs/s, {n_bytes / ts / 1e6:.1f} MB/s "
          f"against cuda {n_bytes / tc / 1e6:.1f} MB/s: ratio "
          f"{ts / tc:.2f}")
    device_busy(lambda: ms.membership_batch(docs), "[18a]",
                margin=PROFILE_MARGIN_S)
    # B6 and B3 against their plain versions at the tile's operands
    table, chunks, init = seen["b6"]
    want = dfa_match.spec_match_torch(table, chunks, init)
    got = b6(table, chunks, init)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "[18a] B6 differs from its plain version")
    ms6 = cuda_ms(lambda: b6(table, chunks, init), 20)
    plain6 = cuda_ms(lambda: dfa_match.spec_match_torch(table, chunks, init),
                     1)
    # late in a long process the profiler drops records without margins
    dev6 = kernel_device_ms(lambda: b6(table, chunks, init), "spec_scan", 20,
                            margin=PROFILE_MARGIN_S)
    (c, l), s = chunks.shape, init.shape[1]
    bound6, by6, steps = spec_bound(c, s, l, *table.shape)
    print(f"[18a] B6 spec_match at the tile's operands, C = {c} rows (8 "
          f"chunks x 64 docs) x S = {s} lanes x L = {l}: kernel "
          f"{ms6:.4f} ms ({device_share(dev6, bound6)}), plain "
          f"{plain6:.2f} ms, bound {bound6:.5f} ms ({by6}; {steps} "
          f"lane-steps), CUDA-event share {bound6 / ms6:.3f}; equal")
    (lanes, keys, cidx, sinks), kw = seen["b3"]
    want = lvec_compose.spec_compose_lanes_torch(lanes, keys, cidx, sinks,
                                                 **kw)
    got = b3(lanes, keys, cidx, sinks, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "[18a] B3 differs from its plain version")
    ms3 = cuda_ms(lambda: b3(lanes, keys, cidx, sinks, **kw), 20)
    plain3 = cuda_ms(lambda: lvec_compose.spec_compose_lanes_torch(
        lanes, keys, cidx, sinks, **kw), 1)
    dev3 = kernel_device_ms(lambda: b3(lanes, keys, cidx, sinks, **kw),
                            "compose_carry", 20, margin=PROFILE_MARGIN_S)
    nb, nn, k, s = lanes.shape
    real = int((keys[:, 1:] != kw["pad_key"]).sum())
    combines = real * k * s
    t_bytes = 4 * ((nb + real) * k * s + keys.numel() + nb * k * s
                   + min(cidx.numel(), combines)) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * combines / SMEM_LOADS_PER_S * 1e3
    bound3 = max(t_bytes, t_ops)
    print(f"[18a] B3 spec_compose_lanes at the tile's operands, B = {nb} "
          f"x N = {nn} x K = {k} x S = {s} ({real} real combines): kernel "
          f"{ms3:.4f} ms ({device_share(dev3, bound3)}), plain "
          f"{plain3:.3f} ms, bound {bound3:.5f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}), CUDA-event "
          f"share {bound3 / ms3:.3f}; equal")
    return ms


def phase18b_mesh22(ps, docs, want3, tmp):
    """(b) Mesh (2, 2): four processes share the card over gloo; (c)'s
    snapshot is taken in the same spawn."""
    n = MESH18[0] * MESH18[1]
    data = os.path.join(tmp, "want.npz")
    off = np.concatenate([[0], np.cumsum([len(d) for d in docs])])
    cuts, late = stream_pieces(np.random.default_rng(SEED + 18), docs)
    np.savez(data, docs=np.frombuffer(b"".join(docs), np.uint8), off=off,
             want=want3, cuts=cuts, late=late)
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    snap = os.path.join(tmp, "snapshot")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase18-child",
         str(r), str(n), os.path.join(tmp, "store"), data,
         os.path.join(tmp, f"rank{r}.json"), snap], env=env, cwd=ROOT,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
    try:
        for p in procs:
            p.wait(timeout=max(CHILD18_S - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        check(p.returncode == 0, f"[18b] rank {r} exited {p.returncode}:\n"
              + text[-4000:])
    reps = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            reps.append(json.load(fh))
    print(f"[18b] mesh {MESH18}: {n} processes sharing the card over gloo "
          f"(lane states staged through host memory), spawn to exit "
          f"{spawn_s:.1f} s; every call's finals equal backend='cuda'")
    for rep in reps:
        mesh = rep["mesh"]
        check(mesh["transport"] == "gloo" and mesh["shape"] == list(MESH18),
              f"[18b] mesh {mesh}")
        for tag in ("uniform", "weighted", "rebalanced"):
            c = rep[tag]
            r = rep["rank"]
            work = np.asarray(c["device_work"], np.float64)
            w = np.asarray(c["weights"])
            check(c["launches"].get("spec_match", 0) > 0
                  and c["launches"].get("spec_compose_lanes", 0) > 0
                  and "onehot_block_maps" not in c["launches"],
                  f"[18b] rank {r} {tag}: launches {c['launches']}")
            g = c["gathers"]
            check(set(g) == {"chunk", "doc"} and g["chunk"][0] == c["tiles"]
                  and g["doc"][0] == c["tiles"],
                  f"[18b] rank {r} {tag}: collectives {g}")
            print(f"[18b] rank {r} at {mesh['coordinate']} {tag}: first "
                  f"{c['first_s']:.4f} s, warm {c['warm_s']:.4f} s; device "
                  f"work share {work[r] / work.sum():.4f} against Eq. 1 "
                  f"weight share {w[r] / w.sum():.4f}; lane-state gathers "
                  f"{g['chunk'][0]} x {g['chunk'][1] // g['chunk'][0]} B, "
                  f"{g['chunk'][2] / g['chunk'][0] * 1e3:.3f} ms a tile; row "
                  f"collections {g['doc'][0]} x "
                  f"{g['doc'][1] // g['doc'][0]} B, "
                  f"{g['doc'][2] / g['doc'][0] * 1e3:.3f} ms; launches "
                  f"{c['launches']}")
    check(all(rep["snapshot_seen"] and rep["sids"] == reps[0]["sids"]
              for rep in reps), "[18c] the snapshot was not seen by every "
          "rank")
    check(os.listdir(snap) == ["step_00000000"],
          f"[18c] snapshot directory {os.listdir(snap)}")
    print(f"[18c] (2, 2) snapshot of {len(reps[0]['sids'])} sessions "
          f"published by rank 0 in {reps[0]['snapshot_s']:.4f} s")
    return snap, reps[0]["sids"], cuts, late


def phase18c_failover(ps, docs, want3, m3, ms11, snap, sids, cuts):
    """(c) The (2, 2) world's snapshot restored on (a)'s (1, 1) mesh and on
    ``backend="cuda"``; closed results equal the whole documents'."""
    from repro_torch.core import Matcher
    from repro_torch.streaming import StreamMatcher, TickPolicy

    n_exact = len(docs) - KEYED16
    lazy = TickPolicy(max_batch=1 << 30, max_delay=1 << 30)
    bodies = docs[:n_exact] + [d[HEAD16:] for d in docs[n_exact:]]
    keys = [m3.dev.advance_key(-1, d[:HEAD16]) for d in docs[n_exact:]]
    heads = m3.advance_segments(
        [d[:HEAD16] for d in docs[n_exact:]],
        np.tile(m3.packed.starts, (KEYED16, 1))).final_states
    cidx = m3.dev.cidx_pad_t.cpu().numpy()
    maps_by = {}
    for label, matcher in (("(1, 1) sharded", ms11),
                           ("backend='cuda'", Matcher(
                               ps, num_chunks=8, batch_tile=64,
                               device=DEVICE))):
        sm = StreamMatcher(matcher, lane_ticks=True, policy=lazy)
        by_sid, rest_s = synced(lambda: {s.sid: s for s in
                                         sm.restore(snap)})
        got = [by_sid[i] for i in sids]
        reset_kernel_launches()
        _, first = synced(sm.flush)
        for j in (2, 3):
            for sess, b, c in zip(got, bodies, cuts):
                sess.feed(b[c[j]:c[j + 1]])
            sm.flush()
        counts = kernel_launches()
        fin = np.stack([s.close().final_states for s in got[:n_exact]])
        maps = np.stack([sm.close_map(s).lane_states for s in got[n_exact:]])
        check(np.array_equal(fin, want3[:n_exact]),
              f"[18c] {label}: closed sessions differ from membership_batch")
        # each keyed map, read at the head's true states, is the document's
        lane = cidx[np.asarray(keys)[:, None], heads]
        check((lane >= 0).all() and np.array_equal(
            np.take_along_axis(maps, lane[:, :, None], axis=2)[:, :, 0],
            want3[n_exact:]), f"[18c] {label}: close_map differs")
        maps_by[label] = maps
        print(f"[18c] restored on {label}: restore {rest_s:.4f} s, first "
              f"tick {first:.4f} s; launches {launched(counts)}; closed "
              "results equal the whole documents'")
    a, b = maps_by.values()
    check(np.array_equal(a, b), "[18c] close_map differs between meshes")


def phase18_sharded(ps, docs, want3, m3):
    """The sharded backend on the card: (a) mesh (1, 1) on NCCL here, (b)
    mesh (2, 2) as four processes over gloo, (c) failover across them."""
    import shutil
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    ms11 = phase18a_mesh11(ps, docs, want3, m3)
    print(f"[18a] in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke18_")
    try:
        t0 = time.perf_counter()
        snap, sids, cuts, _ = phase18b_mesh22(ps, docs, want3, tmp)
        print(f"[18b] in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase18c_failover(ps, docs, want3, m3, ms11, snap, sids, cuts)
        print(f"[18c] in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if dist.is_initialized():   # (a)'s world of one
            dist.destroy_process_group()


def prefill_vs_blockwise(tag, params, cfg, batch, n_tokens, counts):
    """``api.prefill`` on the auto route (B9 once per attention layer of
    the prompt) against the blockwise route: warm, then one timed call of
    each; last-position logits within 5e-2 of the largest, greedy argmax
    equal wherever the blockwise top-2 margin passes that tolerance.
    Returns (wall of the auto route, B9 launches)."""
    import torch
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api

    runs = {}
    for route in ("auto", "blockwise"):
        api.prefill(params, cfg, batch, attn_route=route)          # warm
        torch.cuda.synchronize()
        flash_attn.reset_launches()
        t0 = time.perf_counter()
        logits, _ = api.prefill(params, cfg, batch, attn_route=route)
        torch.cuda.synchronize()
        runs[route] = (logits[:, -1].float(), time.perf_counter() - t0,
                       flash_attn.launches["flash_attn"])
        del logits
    (lk, wk, nk), (lx, wx, nx) = runs["auto"], runs["blockwise"]
    counts["flash_attn"] += nk
    check(bool(torch.isfinite(lk).all())
          and lk.shape == (lx.shape[0], cfg.padded_vocab),
          f"{tag} prefill logits not finite or of the wrong shape")
    err = float((lk - lx).abs().max())
    scale = float(lx.abs().max())
    tol = 5e-2 * scale
    print(f"{tag} api.prefill {n_tokens} tokens: B9 route {wk:.4f} s "
          f"({n_tokens / wk:.0f} tokens/s, B9 launches {nk}); blockwise "
          f"route {wx:.4f} s ({n_tokens / wx:.0f} tokens/s, B9 launches "
          f"{nx}); last-position logits max |err| {err:.5f} of max |logit| "
          f"{scale:.4f} ({err / scale:.5f})")
    check(nx == 0, f"{tag} the blockwise route launched B9")
    check(err <= tol, f"{tag} prefill logits on B9 and on the blockwise "
          "route differ by more than 5e-2 of the largest logit")
    ak, ax = lk.argmax(-1), lx.argmax(-1)
    top2 = lx.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    for r in torch.nonzero(ak != ax).flatten().tolist():
        print(f"{tag} row {r}: argmax {int(ak[r])} vs {int(ax[r])}; "
              f"blockwise top-2 margin {float(margin[r]):.5f}")
    check(bool(((ak == ax) | (margin <= tol)).all()), f"{tag} greedy argmax "
          "differs between the routes where the top two logits are apart")
    return wk, nk


def generate_constrained(tag, params, cfg, rng, counts):
    """Phase 12's constrained ``generate`` (8 prompts x 512 bytes, 32 greedy
    steps, no EOS): B5 once a step, every row a live prefix of the grammar,
    tokens equal to a run with ``use_kernel=False``."""
    import torch
    from repro_torch.core import compile_regex
    from repro_torch.kernels import token_mask
    from repro_torch.serving import (GrammarConstraint, ServeConfig,
                                     ServingEngine)

    n, width, max_new, _ = SERVE12
    dfa = compile_regex(GRAMMAR12)
    prompts = grammar_prompts(rng, n, width)
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
    counts["token_mask"] += launched
    steps = decode_steps(out, eng.serve.eos_id)
    check(steps == max_new and launched == steps, f"{tag} generate launched "
          f"B5 {launched} times over {steps} decode steps (of {max_new})")
    check(out.shape == (n, max_new) and all(
        live_prefix(dfa, p, row, eng.serve.eos_id)
        for p, row in zip(prompts, out)),
        f"{tag} a generated row leaves the grammar")
    plain = GrammarConstraint(dfa, cfg.padded_vocab, use_kernel=False,
                              eos_id=None, device=DEVICE)
    out_plain = ServingEngine(cfg, params, ServeConfig(max_new_tokens=max_new),
                              constraint=plain).generate(prompts)
    check(np.array_equal(out, out_plain), f"{tag} generate with B5 differs "
          "from generate with use_kernel=False")
    print(f"{tag} generate: {n} prompts x {width} bytes, {steps} decode steps"
          f", {n * steps} tokens in {wall:.4f} s: {n * steps / wall:.1f} "
          f"tokens/s; B5 launches {launched}; every row a live prefix of the "
          f"grammar, tokens equal with use_kernel=False")
    text = bytes(int(x) for x in out[0] if x < 256).decode(errors="replace")
    print(f"{tag}   ...{bytes(prompts[0][-24:].astype(np.uint8)).decode()!r}"
          f" -> {text!r}")


def decode_loop_ms(step, n):
    """``n`` eager decode steps (``step(i)`` runs step i): host-clock ms a
    step over all but the first (warm) one."""
    import torch
    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n):
        step(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (n - 1) * 1e3


class f32_compute:
    """Run the model layers in float32 instead of bf16 inside the block
    (``models.layers.Compute``, read at every use)."""

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        self.saved = layers.Compute
        layers.Compute = torch.float32

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.Compute = self.saved


def forced_decode(params, cfg, init_state, step_fn, toks):
    """(train_logits, the logits of decode steps from an empty state fed
    ``toks`` one at a time), float32."""
    import torch
    from repro_torch.models import api

    full, _ = api.train_logits(params, cfg, {"tokens": toks})
    state = init_state(cfg, toks.shape[0], device=DEVICE)
    outs = []
    for i in range(toks.shape[1]):
        logits, state = step_fn(params, cfg, state, toks[:, i:i + 1], i)
        outs.append(logits[:, 0].float())
    return full.float(), torch.stack(outs, 1)


def logit_gap(got, want):
    """(max |err|, max of |err| - 3e-2 |want|, RMS err / RMS want, argmax
    agreement) of two [B, T, V] logit tensors."""
    err = (got - want).abs()
    return (float(err.max()), float((err - 3e-2 * want.abs()).max()),
            float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()),
            float((got.argmax(-1) == want.argmax(-1)).float().mean()))


def forced_decode_check(tag, params, cfg, init_state, step_fn, atol):
    """Teacher-forced decode from an empty state over a 64-token prompt
    against ``train_logits``.  In float32 compute it is held to the JAX
    package's ``test_decode_matches_forward`` envelope (rtol 3e-2,
    ``atol``, argmax agreement > 0.9): the decode recurrences equal the
    forward pass's.  In bf16, the model's compute dtype, the gap is
    printed beside each path's gap to the float32 forward pass: at full
    width both paths' bf16 roundings move the logits alike."""
    import torch

    b, t = 2, 64
    gen = np.random.default_rng(SEED + 19)
    toks = torch.from_numpy(gen.integers(0, cfg.vocab_size, size=(b, t))
                            .astype(np.int32)).to(DEVICE)
    with f32_compute():
        full32, dec32 = forced_decode(params, cfg, init_state, step_fn, toks)
    full, dec = forced_decode(params, cfg, init_state, step_fn, toks)
    check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
          f"{tag} bf16 logits not finite")
    fmt = ("max |err| {:.5f}, max |err| - 3e-2 |logit| {:.5f}, RMS err / RMS "
           "logit {:.5f}, argmax agreement {:.4f}")
    gap = logit_gap(dec32, full32)
    print(f"{tag} teacher-forced decode over {t} tokens vs train_logits, "
          f"float32 compute: " + fmt.format(*gap) + f" (atol {atol})")
    for name, got, want in (("bf16 decode vs bf16 forward", dec, full),
                            ("bf16 forward vs float32 forward", full,
                             full32),
                            ("bf16 decode vs float32 forward", dec, full32)):
        print(f"{tag}   {name}: " + fmt.format(*logit_gap(got, want)))
    check(gap[1] <= atol and gap[3] > 0.9, f"{tag} teacher-forced decode "
          "differs from the forward pass beyond the reference's envelope")


def recurrent_prefill_and_decode(tag, params, cfg, init_state, step_fn):
    """``api.prefill`` at B = 4, T = 2,048 (no kernel) and 32 greedy decode
    steps from an empty state.  Returns the prefill's batch."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api

    b, t = PREFILL19R
    batch = api.make_inputs(cfg, ShapeSpec("p", "prefill", t, b), SEED,
                            device=DEVICE)
    api.prefill(params, cfg, batch)                              # warm
    flash_attn.reset_launches()
    logits, wall = synced(lambda: api.prefill(params, cfg, batch)[0])
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (b, 1, cfg.padded_vocab)
          and flash_attn.launches["flash_attn"] == 0,
          f"{tag} prefill logits not finite, of the wrong shape, or B9 ran")
    print(f"{tag} api.prefill B={b} T={t}: {wall:.4f} s "
          f"({b * t / wall:.0f} tokens/s)")
    state = init_state(cfg, b, device=DEVICE)
    tok = batch["tokens"][:, :1]
    finite = []

    def step(i):
        nonlocal tok
        logits, _ = step_fn(params, cfg, state, tok, i)
        finite.append(torch.isfinite(logits).all())
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True).to(
            torch.int32)

    ms = decode_loop_ms(step, DECODE19)
    check(bool(torch.stack(finite).all()), f"{tag} decode logits not finite")
    print(f"{tag} {DECODE19} greedy decode steps from an empty state "
          f"(B={b}): {ms:.2f} ms a step on the host clock, "
          f"{b * 1e3 / ms:.1f} tokens/s")
    device_busy(lambda: step(DECODE19), f"{tag} decode step")
    return batch


def phase19_families(counts):
    """Every model family at full published width on the card, one model
    at a time: moe, vlm and encdec prefill on B9 against the blockwise
    route, constrained generate on B5 (moe, vlm), encdec decode against the
    encoded memory, the hybrid and xLSTM prefill and decode with the
    teacher-forced check."""
    import dataclasses

    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.models import encdec as ED
    from repro_torch.models import recurrent as RG
    from repro_torch.models import transformer as TF
    from repro_torch.models import xlstm as XL

    rng = np.random.default_rng(SEED + 19)
    for family, arch in ARCH19:
        tag = f"[19{family}]"
        t_model = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        if family in LAYERS19:
            cfg = dataclasses.replace(cfg, n_layers=LAYERS19[family])
        t0 = time.perf_counter()
        params = api.init(cfg, SEED, device=DEVICE)
        torch.cuda.synchronize()
        print(f"{tag} {arch} ({cfg.family}): {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
              f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
              f"; {numel(params)} random f32 parameters in "
              f"{time.perf_counter() - t0:.2f} s")
        if cfg.family in ("moe", "vlm", "encdec"):
            b, t = PREFILL19[cfg.family]
            batch = api.make_inputs(cfg, ShapeSpec("p", "prefill", t, b),
                                    SEED, device=DEVICE)
            _, nk = prefill_vs_blockwise(tag, params, cfg, batch, b * t,
                                         counts)
            check(nk == cfg.n_layers, f"{tag} api.prefill launched B9 {nk} "
                  f"times; expected once per decoder layer ({cfg.n_layers})")
            device_busy(lambda: api.prefill(params, cfg, batch),
                        f"{tag} prefill")
        if cfg.family in ("moe", "vlm"):
            generate_constrained(tag, params, cfg, rng, counts)
            n, width, max_new, _ = SERVE12
            cache = TF.init_cache(cfg, n, width + max_new, device=DEVICE)
            tok = torch.full((n, 1), ord("1"), dtype=torch.int32,
                             device=DEVICE)
            ms = decode_loop_ms(lambda i: TF.decode_step(
                params, cfg, cache, tok, width + i), 9)
            print(f"{tag} decode_step (eager, B={n}, cache "
                  f"{width + max_new}): {ms:.2f} ms a step on the host clock")
            device_busy(lambda: TF.decode_step(params, cfg, cache, tok,
                                               width + 9),
                        f"{tag} decode_step")
            del cache
        if cfg.family == "encdec":
            # continue from the B9 prefill's cache against the encoded memory
            b, t = batch["tokens"].shape
            _, pcache = api.prefill(params, cfg, batch)
            cache = ED.init_encdec_cache(cfg, b, t + DECODE19 + 1,
                                         device=DEVICE)
            for name in ("k", "v"):
                cache[name][:, :, :t] = pcache[name]
            del pcache
            memory = ED.encode(params, cfg, batch["frames"])
            tok = batch["tokens"][:, -1:]
            finite = []

            def step(i):
                nonlocal tok
                logits, _ = api.decode(params, cfg, {
                    "cache": cache, "memory": memory, "tokens": tok,
                    "pos": t + i})
                finite.append(torch.isfinite(logits).all())
                tok = logits[:, -1, :cfg.vocab_size].argmax(
                    -1, keepdim=True).to(torch.int32)

            ms = decode_loop_ms(step, DECODE19)
            check(bool(torch.stack(finite).all()),
                  f"{tag} decode logits not finite")
            print(f"{tag} {DECODE19} eager api.decode steps (B={b}) "
                  f"after the B9 prefill, against the encoded memory: "
                  f"{ms:.2f} ms a step on the host clock, "
                  f"{b * 1e3 / ms:.1f} tokens/s")
            device_busy(lambda: step(DECODE19), f"{tag} decode step")
            del cache, memory
        if cfg.family == "hybrid":
            batch = recurrent_prefill_and_decode(
                tag, params, cfg, RG.init_hybrid_state, RG.decode_step_hybrid)
            device_busy(lambda: api.prefill(params, cfg, batch),
                        f"{tag} prefill")
            forced_decode_check(tag, params, cfg, RG.init_hybrid_state,
                                RG.decode_step_hybrid, 3e-2)
        if cfg.family == "ssm":
            batch = recurrent_prefill_and_decode(
                tag, params, cfg, XL.init_xlstm_state, XL.decode_step_xlstm)
            # the sLSTM blocks' share of a prefill (synchronised around each)
            spent = [0.0, 0]
            block = XL.slstm_block

            def timed(*a, **kw):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = block(*a, **kw)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t1
                spent[1] += 1
                return out

            XL.slstm_block = timed
            try:
                _, wall_s = synced(lambda: api.prefill(params, cfg, batch))
            finally:
                XL.slstm_block = block
            print(f"{tag} sLSTM blocks ({spent[1]} of {cfg.n_layers}, "
                  f"{PREFILL19R[1]} sequential steps each): "
                  f"{spent[0]:.4f} s of a {wall_s:.4f} s prefill (share "
                  f"{spent[0] / wall_s:.3f})")
            # a quarter of the prompt: the profiler's own processing of the
            # full prefill's ~300 k events takes about a minute
            short = {"tokens": batch["tokens"][:, :PREFILL19R[1] // 4]}
            device_busy(lambda: api.prefill(params, cfg, short),
                        f"{tag} prefill (T = {PREFILL19R[1] // 4})")
            forced_decode_check(tag, params, cfg, XL.init_xlstm_state,
                                XL.decode_step_xlstm, 0.15)
        print(f"{tag} peak device memory {torch.cuda.max_memory_allocated()}"
              f" B ({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
              f"{time.perf_counter() - t_model:.1f} s for the model")
        del params, batch
        torch.cuda.empty_cache()
        if cfg.family in ("moe", "vlm"):
            serve.main(["--arch", arch, "--max-new", "8", "--prompts",
                        "12. 34", "7, 891", "--grammar", GRAMMAR12])
            torch.cuda.empty_cache()


def dense_train_flops(cfg, b, t):
    """The flops of one train step of ``b`` x ``t`` tokens of a dense LM
    under full remat: 6 per matmul parameter (all but the embedding table
    and the norm scales) and token, causal attention's 6 T H hd a token and
    layer (QK^T and PV, forward and backward, half the keys), and one more
    forward for the recompute (a third more).  Also returns the matmul
    parameters."""
    from repro_torch.models import api

    def matmul_params(tree, path=""):
        if isinstance(tree, dict):
            return sum(matmul_params(v, f"{path}/{k}")
                       for k, v in tree.items())
        return 0 if path.endswith(("embed/table", "scale")) \
            else int(np.prod(tree))

    n_mm = matmul_params(api.param_shapes(cfg))
    per_token = 6 * n_mm + 6 * cfg.n_layers * t * cfg.n_heads * cfg.hd
    return b * t * per_token * 4 / 3, n_mm


def train_opts20():
    """20(a)'s options: the launcher's (lr 3e-4, 20 warm-up steps: the lr
    of steps 0-19 does not depend on --steps), TRAIN20's microbatches."""
    from repro_torch.training import AdamWConfig, TrainOptions
    return TrainOptions(num_microbatches=TRAIN20[2], optimizer=AdamWConfig(
        warmup_steps=20, total_steps=CLI20 + 1))


def phase20a_train(counts):
    """tinyllama-1.1b at full width trained in this process on the
    launcher's B1-filtered stream: per-step time, tokens/s, flop share,
    loss; the loss falling on one batch; peak memory, the idle share of a
    profiled step and the filter's decisions against backend='local'."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import CorpusConfig, CorpusFilter, generate_documents
    from repro_torch.kernels import dfa_match
    from repro_torch.launch import train as launch_train
    from repro_torch.training import init_train_state, make_train_step

    cfg = get_config(ARCH20)
    b, t, nm = TRAIN20
    opts = train_opts20()
    docs, masks = [], []

    def source():
        for d in generate_documents(CorpusConfig(n_documents=10_000,
                                                 doc_len=t * 4, seed=1)):
            docs.append(d)
            yield d

    batches, filt = launch_train.corpus_batches(cfg, b, t, RULES20,
                                                device=DEVICE, docs=source())
    scan = filt.scan_batch

    def recording(batch_docs):
        keep = scan(batch_docs)
        masks.append(keep)
        return keep

    filt.scan_batch = recording
    torch.cuda.reset_peak_memory_stats()
    state, init_s = synced(lambda: init_train_state(cfg, SEED, device=DEVICE,
                                                    opts=opts))
    work, n_mm = dense_train_flops(cfg, b, t)
    print(f"[20a] {ARCH20}: {numel(state['params'])} random f32 parameters "
          f"({n_mm} in matmuls) and their AdamW moments in {init_s:.2f} s; "
          f"{b} x {t} tokens a step in {nm} microbatches, remat "
          f"{cfg.remat_policy!r}; {work:.4e} flops a step, bound "
          f"{work / BF16_FLOPS_PER_S:.4f} s at 989.4 TFLOP/s")
    step = make_train_step(cfg, None, opts)
    reset_kernel_launches()
    losses, walls = [], []
    for i in range(sum(STEPS20)):
        if i < STEPS20[0]:
            t0 = time.perf_counter()
            host = next(batches)
            data_s = time.perf_counter() - t0
            batch = launch_train.batch_to_device(host, DEVICE)
        (state, metrics), wall = synced(lambda: step(state, batch))
        loss, gnorm, lr = (float(metrics[k]) for k in ("loss", "grad_norm",
                                                       "lr"))
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"[20a] step {i}: loss {loss}, grad_norm {gnorm}")
        losses.append(loss)
        walls.append(wall)
        again = (f" (step {STEPS20[0] - 1}'s batch again)"
                 if i >= STEPS20[0] else f", its batch {data_s:.3f} s")
        print(f"[20a] step {i}{again}: {wall:.3f} s, {b * t / wall:.0f} "
              f"tokens/s, {work / wall / 1e12:.1f} TFLOP/s (share "
              f"{work / wall / BF16_FLOPS_PER_S:.4f} of 989.4); loss "
              f"{loss:.6f} grad_norm {gnorm:.4f} lr {lr:.4e}")
        if i == STEPS20[0] - 1:
            b1 = kernel_launches()["spec_match_merge"]
    # a net fall, as tests/test_substrate.py asks: in the warm-up one Adam
    # step can overshoot (the loss on its own batch rising), the next ones
    # bring it down
    fixed = losses[STEPS20[0] - 1:]
    check(fixed[-1] < fixed[0],
          f"[20a] the loss did not fall on one batch: {fixed}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[20a] loss on one batch over {len(fixed)} steps: {fixed} "
          f"(the last below the first); steps 1-{len(walls) - 1}: {np.mean(walls[1:]):.3f} s "
          f"a step on average ({b * t / np.mean(walls[1:]):.0f} tokens/s); "
          f"peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    check(b1 > 0, "[20a] the filtered stream launched no B1")
    counts["spec_match_merge"] += b1
    decided = np.concatenate(masks)
    local = CorpusFilter(RULES20, num_chunks=8, backend="local",
                         device=DEVICE)
    check(np.array_equal(decided, local.scan_batch(docs[:len(decided)])),
          "[20a] the filter's decisions differ from backend='local'")
    check(filt.stats.scanned == len(decided)
          and filt.stats.dropped == int((~decided).sum()),
          f"[20a] filter stats {filt.stats}")
    print(f"[20a] the stream's filter: {filt.stats.dropped}/"
          f"{filt.stats.scanned} documents dropped ({len(docs)} generated), "
          f"{filt.stats.batch_calls} tiles, B1 launches {b1}; decisions "
          f"equal backend='local' on the same documents")
    # the idle share of one microbatch's step (a whole step's ~4x as many
    # profiler events take minutes to process)
    one = make_train_step(cfg, None, dataclasses.replace(
        opts, num_microbatches=1))
    part = {k: v[:b // nm] for k, v in batch.items()}
    device_busy(lambda: one(state, part),
                f"[20a] one step of {b // nm} x {t} (one microbatch)",
                margin=PROFILE_MARGIN_S, cpu=False)
    del part
    t0 = time.perf_counter()
    phase22a_train_census(cfg, opts, state, batch, float(np.mean(walls[1:])))
    print(f"[22a] in {time.perf_counter() - t0:.1f} s")
    del state, batch
    torch.cuda.empty_cache()


def launcher_line(line):
    """A launcher's ``step N loss L gnorm G lr R`` line as (N, numbers)."""
    words = line.split()
    return int(words[1]), {k: float(words[words.index(k) + 1])
                           for k in ("loss", "gnorm", "lr")}


def launcher_reference(cfg, b, t, nm, steps):
    """The lines (loss, gnorm, lr by step) of ``steps`` steps of the
    launcher's B1-filtered stream, initial state (seed 0) and options, run
    uninterrupted in this process on one device."""
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.training import (AdamWConfig, TrainOptions,
                                      init_train_state, make_train_step)

    batches, _ = launch_train.corpus_batches(cfg, b, t, RULES20,
                                             device=torch.device(DEVICE))
    opts = TrainOptions(num_microbatches=nm, optimizer=AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=steps))
    state = init_train_state(cfg, 0, device=DEVICE, opts=opts)
    step = make_train_step(cfg, None, opts)
    lines = {}
    for i in range(steps):
        state, m = step(state, launch_train.batch_to_device(
            next(batches), DEVICE))
        lines[i] = {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
                    "lr": float(m["lr"])}
    del state, step
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return lines


def cli_config():
    """20(b)'s and 21(d)'s model: ``ARCH20`` at its widths, ``LAYERS_CLI``
    layers (the launcher's ``--layers``)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH20), n_layers=LAYERS_CLI)


def phase20b_launcher():
    """``python -m repro_torch.launch.train`` at (a)'s widths and
    ``LAYERS_CLI`` layers for 1 step, checkpointed, then ``--resume`` for
    the step after it: each printed step against the same step of the
    launcher's stream, initial state and options run uninterrupted in this
    process, within ``LINE20_TOL``; the saves' blocking times and the
    restore time."""
    import shutil
    import tempfile

    steps = CLI20
    b, t, nm = TRAIN20
    uninterrupted = launcher_reference(cli_config(), b, t, nm, steps + 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke20_")
    ckpt = os.path.join(tmp, "ckpt")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            ARCH20, "--layers", str(LAYERS_CLI), "--batch", str(b), "--seq",
            str(t), "--microbatches", str(nm), "--ckpt-every", str(steps),
            "--ckpt-dir", ckpt, "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}
    try:
        for name, extra in (("first", ["--steps", str(steps)]),
                            ("resumed", ["--steps", str(steps + 1),
                                         "--resume"])):
            t0 = time.perf_counter()
            res = subprocess.run(base + extra, env=env, cwd=ROOT,
                                 capture_output=True, text=True,
                                 timeout=CLI20_S)
            wall = time.perf_counter() - t0
            check(res.returncode == 0, f"[20b] the launcher ({name}) exited "
                  f"{res.returncode}: {res.stderr[-3000:]}")
            lines = res.stdout.splitlines()
            for ln in lines:
                print(f"[20b] {name}: {ln}")
            print(f"[20b] {name} run: {wall:.1f} s of command")
            check(lines[-1].startswith(f"done: {int(extra[1])} steps"),
                  f"[20b] {name}: no done line")
            runs[name] = dict(launcher_line(ln) for ln in lines
                              if ln.startswith("step "))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first, resumed = runs["first"], runs["resumed"]
    check(sorted(first) == list(range(steps))
          and sorted(resumed) == [steps],
          f"[20b] the launcher's steps {sorted(first)}, {sorted(resumed)}")
    printed = {**first, **resumed}
    gaps = {k: max(abs(printed[i][k] - uninterrupted[i][k])
                   / (uninterrupted[i][k] if k == "lr" else 1)
                   for i in printed) for k in LINE20_TOL}
    check(all(gaps[k] <= LINE20_TOL[k] for k in gaps),
          f"[20b] the launcher's lines {printed} differ from one "
          f"process's {uninterrupted}: gaps {gaps}")
    print(f"[20b] {LAYERS_CLI} layers at {ARCH20}'s widths: the launcher's "
          f"step 0 and, resumed from its step-{steps} checkpoint in a new "
          f"process, its step {steps} equal one process's uninterrupted "
          f"steps within {LINE20_TOL} (lr relative; gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + ")")


def phase20b_restart():
    """A ``RestartManager`` run at the reduced config on the card with a
    fault injected at one step: it restores the last checkpoint and reaches
    the final step, its state beside an uninterrupted run's."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import ShapeSpec, get_config, reduce_for_smoke
    from repro_torch.distributed.fault_tolerance import RestartManager
    from repro_torch.models import api
    from repro_torch.training import (AdamWConfig, CheckpointManager,
                                      TrainOptions, init_train_state,
                                      make_train_step)

    cfg = reduce_for_smoke(get_config(ARCH20))
    n, fail_at, every = FAULT20
    b, t = SMALL20
    batches = [api.make_inputs(cfg, ShapeSpec("t", "train", t, b), s,
                               device=DEVICE) for s in range(n)]
    opts = TrainOptions(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=20))
    step = make_train_step(cfg, None, opts)
    tmp = tempfile.mkdtemp(prefix="chip_smoke20_")

    def run(fail, name):
        state = init_train_state(cfg, SEED, device=DEVICE, opts=opts)
        mgr = CheckpointManager(os.path.join(tmp, name), keep=2)
        failed = []

        def one_step(st, i):
            if i == fail and not failed:
                failed.append(i)
                raise RuntimeError("injected worker fault")
            return step(st, batches[i])[0]

        rm = RestartManager(save_fn=mgr.save,
                            restore_fn=lambda: mgr.restore(state))
        final, at = rm.run(state, 0, n, one_step, checkpoint_every=every)
        mgr.wait()
        return final, at, rm

    # deterministic algorithms (the embedding's backward sorts instead of
    # adding atomically; cuBLAS on one stream with a fixed workspace), so
    # the restored run must end bit for bit where the clean one does
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        clean, at0, _ = run(None, "clean")
        final, at, rm = run(fail_at, "faulty")
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(torch.equal(a, c) for a, c in
               zip(tensors(final), tensors(clean)))
    check(at == at0 == n and rm.restarts == 1
          and int(final["opt"]["step"]) == n and same,
          f"[20b] restart: final step {at}, restarts {rm.restarts}, failures "
          f"{rm.failures}, state bit-equal to the clean run's: {same}")
    print(f"[20b] RestartManager, reduced {ARCH20}, {n} steps of {b} x {t} "
          f"under deterministic algorithms, checkpoints every {every}, a "
          f"fault injected at step {fail_at}: {rm.restarts} restart "
          f"({rm.failures[0][1]}), restored step "
          f"{fail_at // every * every}, final step {at}; parameters and "
          f"moments bit-equal to an uninterrupted run's")


def phase20c_families():
    """One AdamW step of every other family at full width, ~4,096 tokens,
    one model at a time: step time, peak memory, finite loss, aux loss and
    gradients (a finite global norm), grad_norm > 0."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.models import api
    from repro_torch.training import (AdamWConfig, TrainOptions,
                                      init_train_state, make_train_step)

    for family, arch in FAMILIES20:
        tag = f"[20c{family}]"
        b, t = SHAPE20C.get(family, SHAPE20)
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        state, init_s = synced(lambda: init_train_state(cfg, SEED,
                                                        device=DEVICE))
        batch = api.make_inputs(cfg, ShapeSpec("t", "train", t, b), SEED,
                                device=DEVICE)
        step = make_train_step(cfg, None, TrainOptions(
            optimizer=AdamWConfig(warmup_steps=20)))
        auxes = []
        forward = api.train_logits

        def recording(*args, **kwargs):
            logits, aux = forward(*args, **kwargs)
            auxes.append(aux.detach())
            return logits, aux

        api.train_logits = recording
        try:
            (state, metrics), wall = synced(lambda: step(state, batch))
        finally:
            api.train_logits = forward
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        aux = float(auxes[0])
        finite = all(bool(torch.isfinite(p).all())
                     for p in tensors(state["params"]))
        check(np.isfinite(loss) and np.isfinite(aux) and np.isfinite(gnorm)
              and gnorm > 0 and finite and (family != "moe" or aux > 0),
              f"{tag} loss {loss}, aux {aux}, grad_norm {gnorm}, finite "
              f"parameters {finite}")
        peak = torch.cuda.max_memory_allocated()
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        print(f"{tag} {arch}: {numel(state['params'])} f32 parameters in "
              f"{init_s:.2f} s; one AdamW step on {shapes}: {wall:.3f} s; "
              f"loss {loss:.4f}, aux {aux:.4f}, grad_norm {gnorm:.4f} (every "
              f"gradient leaf finite), parameters finite; peak device memory "
              f"{peak} B ({peak / 2**30:.2f} GiB)")
        del state, batch, step, metrics
        torch.cuda.empty_cache()


def phase20d_card_vs_cpu():
    """One step of the reduced tinyllama from one converted train state
    and batch on the card and on the CPU: loss, grad_norm, the parameters
    and, per leaf, the moments (the first step's m is (1 - b1) x the
    clipped gradient, so they carry each leaf's gradient)."""
    from repro_torch.configs import ShapeSpec, get_config, reduce_for_smoke
    from repro_torch.models import api
    from repro_torch.models.convert import (train_state_from_jax,
                                            train_state_to_numpy)
    from repro_torch.training import (AdamWConfig, TrainOptions,
                                      init_train_state, make_train_step)

    cfg = reduce_for_smoke(get_config(ARCH20))
    b, t = SMALL20
    tree = train_state_to_numpy(init_train_state(cfg, SEED, device="cpu"))
    host = api.make_inputs(cfg, ShapeSpec("t", "train", t, b), SEED,
                           device="cpu")
    step = make_train_step(cfg, None, TrainOptions(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20)))
    out = {}
    for dev in ("cpu", DEVICE):
        state = train_state_from_jax(cfg, tree, device=dev)
        state, m = step(state, {k: v.to(dev) for k, v in host.items()})
        out[dev] = (train_state_to_numpy(state),
                    {k: float(v) for k, v in m.items()})
    (sc, mc), (sd, md) = out["cpu"], out[DEVICE]
    gap = max(float(np.abs(a - c).max())
              for a, c in zip(tensors(sd["params"]), tensors(sc["params"])))
    # each moment leaf's relative L2 gap, the worst of m and v
    moments = max(float(np.linalg.norm(a - c) / max(np.linalg.norm(c),
                                                     1e-30))
                  for name in ("m", "v") for a, c in
                  zip(tensors(sd["opt"][name]), tensors(sc["opt"][name])))
    lr = mc["lr"]
    loss_rel = abs(md["loss"] - mc["loss"]) / abs(mc["loss"])
    norm_rel = abs(md["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
    check(loss_rel <= 1e-3 and norm_rel <= 2e-2 and gap <= 2 * lr + 1e-6
          and moments <= LEAF20_TOL,
          f"[20d] card against CPU: loss {md['loss']} / {mc['loss']}, "
          f"grad_norm {md['grad_norm']} / {mc['grad_norm']}, parameter gap "
          f"{gap}, worst moment leaf {moments}")
    print(f"[20d] reduced {ARCH20}, {b} x {t}, one step from one converted "
          f"state: loss {md['loss']:.6f} on the card, {mc['loss']:.6f} on the "
          f"CPU (rel {loss_rel:.2e} <= 1e-3); grad_norm {md['grad_norm']:.5f} "
          f"/ {mc['grad_norm']:.5f} (rel {norm_rel:.2e} <= 2e-2); m and v "
          f"per leaf within {moments:.3e} relative L2 <= {LEAF20_TOL} (the "
          f"bf16 leaf tolerance of tests/test_torch_training.py); parameters "
          f"max |err| {gap:.3e} <= 2 lr + 1e-6 = {2 * lr + 1e-6:.3e}")


def phase20_training(counts):
    """Training on the card: (a) tinyllama-1.1b at full width in this
    process, (b) the launcher, its resume and a restart, (c) one step of
    every other family, (d) the card against the CPU."""
    t0 = time.perf_counter()
    phase20a_train(counts)
    print(f"[20a] in {time.perf_counter() - t0:.1f} s")
    for name, fn in (("b", phase20b_launcher),
                     ("b restart", phase20b_restart),
                     ("c", phase20c_families), ("d", phase20d_card_vs_cpu)):
        t0 = time.perf_counter()
        fn()
        print(f"[20{name}] in {time.perf_counter() - t0:.1f} s")


# -- phase 22: the analysis tools ---------------------------------------------

# the subprocess of the dry run's fake traces and what it wrote
TRACES22: dict = {}


def phase22_traces_child(out):
    """``--phase22-traces out``: the dry run's trace of 22(a)'s train step
    (the card's program on fake CPU tensors, as ``launch.dryrun`` traces
    every cell; host work only, no card), written to ``out`` as JSON."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun

    b, t, _ = TRAIN20
    t0 = time.perf_counter()
    res = dryrun.trace_one_card(get_config(ARCH20),
                                ShapeSpec("train", "train", t, b),
                                opts=train_opts20(), device="cuda")
    res["host_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def phase22_start():
    """Start 22(a)'s fake trace in a subprocess (``--phase22-traces``), at
    the lowest priority, with one thread and no card visible, so that its
    ~100 s of host work overlap phases 19 and 20(a) instead of adding to
    the script's time."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke22_")
    out = os.path.join(tmp, "traces.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    TRACES22.update(tmp=tmp, out=out, proc=subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase22-traces", out],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, preexec_fn=lambda: os.nice(19)))


def phase22_trace():
    """22(a)'s fake trace, waiting for its subprocess the first time."""
    if "res" not in TRACES22:
        proc = TRACES22["proc"]
        t0 = time.perf_counter()
        stdout, stderr = proc.communicate(timeout=CHILD22_S)
        check(proc.returncode == 0, f"[22] the fake trace exited "
              f"{proc.returncode}: {stdout[-1000:]}{stderr[-3000:]}")
        with open(TRACES22["out"]) as f:
            TRACES22["res"] = json.load(f)
        TRACES22["res"]["wait_s"] = time.perf_counter() - t0
    return TRACES22["res"]


def phase22_stop():
    """Stop the traces' subprocess if it still runs; remove its files."""
    import shutil
    proc = TRACES22.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()
    if "tmp" in TRACES22:
        shutil.rmtree(TRACES22["tmp"], ignore_errors=True)

def census_gap(got, want):
    """The keys (and for ``ops`` the ops) where two censuses differ."""
    out = {}
    for k in sorted(set(got) | set(want)):
        if got.get(k) != want.get(k):
            if k == "ops":
                a, b = got.get(k, {}), want.get(k, {})
                out[k] = {o: (a.get(o), b.get(o))
                          for o in sorted(set(a) | set(b))
                          if a.get(o) != b.get(o)}
            else:
                out[k] = (got.get(k), want.get(k))
    return out


def phase22a_train_census(cfg, opts, state, batch, step_s):
    """22(a): one train step of 20(a)'s shape under the census on 20(a)'s
    live state, held to the dry run's trace of the same one-card step (the
    card's program on fake CPU tensors, as ``launch.dryrun`` traces every
    cell); the predicted peak memory against the measured; the measured
    step's share of the function's bound; the census's roofline row on
    H100 constants."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch import roofline
    from repro_torch.launch.census import trace_census
    from repro_torch.training import make_train_step

    b, t = (int(n) for n in batch["tokens"].shape)
    check((b, t, opts.num_microbatches) == TRAIN20, f"[22a] shape {b, t}")
    fake = phase22_trace()
    fc = dict(fake["census"], collectives=fake["collectives"])
    step = make_train_step(cfg, None, opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (_, metrics), real = trace_census(step, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    loss = float(metrics["loss"])
    check(np.isfinite(loss), f"[22a] loss {loss} under the census")
    gap = census_gap(real, fc)
    check(not {"dot_flops", "ops", "kernels", "collectives"} & set(gap),
          f"[22a] the card's census differs from the fake trace's: "
          f"{str(gap)[:2000]}")
    mem = fake["memory"]
    ratio = mem["peak_bytes"] / peak
    print(f"[22a] {ARCH20} step of {b} x {t} tokens in "
          f"{opts.num_microbatches} microbatches under the census: "
          f"{wall:.3f} s ({step_s:.3f} s without it in 20(a)), loss "
          f"{loss:.6f}; fake trace {fake['host_s']:.1f} s of host time (its "
          f"subprocess, beside phases 19 and 20(a); waited for "
          f"{fake['wait_s']:.1f} s): dot flops {real['dot_flops']:.6e}, "
          f"{real['n_ops']} ops ({len(real['ops'])} kinds), max multiplier "
          f"{real['max_multiplier']}, kernels {real['kernels']}, approx HBM "
          f"bytes {real['approx_hbm_bytes']:.6e}; equal on the card and in "
          f"the fake trace (keys that differ: {sorted(gap)})")
    print(f"[22a] peak memory: predicted {mem['peak_bytes']} B "
          f"(arguments {mem['argument_bytes']}, temporaries "
          f"{mem['temp_bytes']}), measured max_memory_allocated {peak} B; "
          f"ratio {ratio:.4f} within {MEM22}")
    check(MEM22[0] <= ratio <= MEM22[1],
          f"[22a] predicted / measured peak memory {ratio:.4f} outside "
          f"{MEM22}")
    # the function's bound: its flops (20(a)'s count) at the bf16 rate,
    # against the state read and written once and the batch read once
    work, _ = dense_train_flops(cfg, b, t)
    state_b, batch_b = (sum(x.numel() * x.element_size()
                            for x in tensors(tree)
                            if isinstance(x, torch.Tensor))
                        for tree in (state, batch))
    t_ops = work / BF16_FLOPS_PER_S
    t_bytes = (2 * state_b + batch_b) / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes)
    print(f"[22a] the step's bound: {work:.4e} flops (20(a)'s count: 6 a "
          f"matmul parameter and token, causal attention, remat's "
          f"recompute) at 989.4 TFLOP/s {t_ops:.4f} s against "
          f"{2 * state_b + batch_b} B (the {state_b} B state read and "
          f"written once, the batch read) at 3.35 TB/s {t_bytes:.4f} s: "
          f"{bound:.4f} s, by {'operations' if t_ops >= t_bytes else 'bytes'}"
          f"; the measured step {step_s:.3f} s reads {bound / step_s:.4f} "
          f"of it")
    check(t == SHAPES["train_4k"].seq_len, f"[22a] seq_len {t}")
    # the row of a train_4k record whose device count gives each device
    # this step's b x t tokens (the model flops 6 N D of this step)
    rec = {"arch": ARCH20, "shape": "train_4k", "mesh": "one card",
           "ok": True, "n_devices": SHAPES["train_4k"].global_batch // b,
           "census": real, "collectives": real["collectives"],
           "memory": mem}
    row = roofline.analyze_record(rec, roofline.count_params(ARCH20))
    print(f"[22a] the census's roofline row on H100 constants "
          f"({roofline.PEAK_FLOPS:.4g} flop/s, {roofline.HBM_BW:.4g} B/s, "
          f"{roofline.LINK_BW:.4g} B/s): t_compute {row['t_compute_s']:.4f} "
          f"s, t_memory {row['t_memory_s']:.4f} s, t_collective "
          f"{row['t_collective_s']:.4f} s, {row['dominant']}-dominated; "
          f"useful {row['useful_ratio']:.4f} (6 N D "
          f"{row['model_flops_chip']:.4e} over census flops "
          f"{row['hlo_flops_chip']:.4e}). t_memory is this eager program's "
          f"traffic (every op's operands read and written once), which "
          f"grows with the program's own passes: a model of the program, "
          f"not a bound of the step; the step moves it at "
          f"{row['t_memory_s'] / step_s:.4f} of 3.35 TB/s")
    print(roofline.to_markdown([row]))


def phase22b_prefill_census(params, cfg, batch):
    """22(b): one of phase 12's ``api.prefill`` calls under the census: B9
    launched once a layer, its work as the dry run's trace of the same
    call counts it (traced here, on fake CPU tensors, launching
    nothing)."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import flash_attn
    from repro_torch.launch import dryrun
    from repro_torch.launch.census import trace_census
    from repro_torch.models import api

    b, t = (int(n) for n in batch["tokens"].shape)
    check((b, t) == PREFILL12, f"[22b] shape {b, t}")
    before = flash_attn.launches["flash_attn"]
    t0 = time.perf_counter()
    fake = dryrun.trace_one_card(cfg, ShapeSpec("prefill", "prefill", t, b),
                                 device="cuda")
    fake_s = time.perf_counter() - t0
    check(flash_attn.launches["flash_attn"] == before,
          "[22b] the fake trace moved B9's launch counter")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (logits, cache), real = trace_census(api.prefill, params, cfg, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = flash_attn.launches["flash_attn"] - before
    got = real["kernels"].get("flash_attn", {})
    want = fake["census"]["kernels"].get("flash_attn", {})
    check(bool(torch.isfinite(logits).all()), "[22b] logits not finite")
    check(n == cfg.n_layers and got.get("launches") == n
          and want.get("launches") == n,
          f"[22b] B9 launches: counter {n}, census {got}, fake trace "
          f"{want}; expected {cfg.n_layers}")
    check(got == want, f"[22b] B9's census {got} differs from the fake "
          f"trace's {want}")
    check(real["dot_flops"] == fake["census"]["dot_flops"],
          f"[22b] dot flops {real['dot_flops']} against the fake trace's "
          f"{fake['census']['dot_flops']}")
    print(f"[22b] api.prefill B={b} T={t} under the census: {wall:.4f} s, "
          f"B9 {n} launches (counter and census), {got['flops']:.6e} flops, "
          f"{got['bytes']:.6e} bytes; dot flops {real['dot_flops']:.6e}; "
          f"equal to the fake trace's ({fake_s:.2f} s of host time, no "
          f"launch); predicted peak {fake['memory']['peak_bytes']} B")
    del cache


# -- phase 21: the LM mesh ----------------------------------------------------

def all_launches():
    """Launches so far of every kernel wrapper, by name."""
    from repro_torch.kernels import flash_attn, token_mask
    return {**kernel_launches(), **flash_attn.launches,
            **token_mask.launches}


def launch_delta(before):
    """The launches since ``before`` (an ``all_launches()``), nonzero."""
    return {k: v - before.get(k, 0) for k, v in all_launches().items()
            if v - before.get(k, 0)}


def reset_all_launches():
    from repro_torch.kernels import flash_attn, token_mask
    reset_kernel_launches()
    flash_attn.reset_launches()
    token_mask.reset_launches()


def dfas21():
    """21(a)'s DFAs: a PCRE-14 search DFA with 8 < Q <= 256 (the product
    route, B8 then B7) and a random DFA of Q = 512 (the gather route,
    B6)."""
    from repro_torch.core import PCRE_PATTERNS, compile_regex, random_dfa
    from repro_torch.core.automata import make_search_dfa
    return {"pcre": make_search_dfa(compile_regex(PCRE_PATTERNS[PCRE21])),
            "random": random_dfa(RANDOM21[0], RANDOM21[1],
                                 rng=np.random.default_rng(SEED + 21),
                                 with_sink=False)}


def cfg21(train=False, no_drop=False):
    """granite-moe-1b-a400m at published widths, cut to ``LAYERS21``
    layers (``train``: to ``TRAIN21[3]``); ``no_drop``: capacity factor
    E / top_k, at which no choice drops."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCH21), n_layers=TRAIN21[3]
                              if train else LAYERS21)
    if no_drop:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def opts21(compression="none", aux=0.01, nm=TRAIN21[2]):
    from repro_torch.training import AdamWConfig, TrainOptions
    return TrainOptions(num_microbatches=nm, aux_loss_weight=aux,
                        grad_compression=compression,
                        optimizer=AdamWConfig(lr=3e-4, warmup_steps=20,
                                              total_steps=100))


def batch21(cfg, device, shape=TRAIN21[:2]):
    """The first batch of the launcher's B1-filtered stream."""
    from repro_torch.launch import train as launch_train
    b, t = shape
    batches, _ = launch_train.corpus_batches(cfg, b, t, RULES20,
                                             device=device)
    return launch_train.batch_to_device(next(batches), device)


def blocked_moe21(p, x, *, top_k, capacity_factor, mesh=None):
    """``moe._moe_sharded``'s arithmetic on ``MESH21``, in one process on
    whole expert weights: the plain version 21(b) holds the mesh to at the
    published capacity factor.  The caller's tokens split into the same
    blocks (the batch over ("pod", "data") when that divides it, the
    sequence over "model" when that divides it), each block routed from
    its rows of one router product over all tokens and with the capacity
    of its own token count; the expert buffers of the "model" ranks that
    share a batch block are exchanged as ``all_to_all`` does (experts
    split, capacity concatenated), each expert shard runs on its buffer of
    the mesh's shape, and the results return the same way."""
    import math

    import torch
    from repro_torch.models import moe
    dp, ep = MESH21[0] * MESH21[1], MESH21[2]
    b, t, d = x.shape
    e = p["router"].shape[1]
    nb = dp if b % dp == 0 else 1
    nt = ep if t % ep == 0 else 1
    logits = torch.matmul(x, p["router"].to(moe.Compute))
    shard = [{k: p[k][j * e // ep:(j + 1) * e // ep]
              for k in moe.MOE_EXPERTS} for j in range(ep)]
    rows, auxes = [], []
    for xb, lb in zip(x.chunk(nb, 0), logits.chunk(nb, 0)):
        # the "model" ranks of this batch block: their sequence block (all
        # of them the whole sequence where it is not split)
        xs = xb.chunk(nt, 1) if nt > 1 else (xb,) * ep
        ls = lb.chunk(nt, 1) if nt > 1 else (lb,) * ep
        routed, sends = [], []
        for xj, lj in zip(xs, ls):
            flat = xj.reshape(-1, d)
            n = flat.shape[0]
            cap = max(top_k, int(math.ceil(n * top_k * capacity_factor / e)))
            gates, ids, aux = moe._route(None, flat, top_k,
                                         logits=lj.reshape(n, e))
            slot = moe._slots(ids, e, cap)
            routed.append((slot, gates, xj.shape, cap))
            sends.append(moe._dispatch(flat, slot, e, cap))
            auxes.append(aux)
        outs = [moe._expert_ffn(shard[k], torch.cat(
            [sj[k * e // ep:(k + 1) * e // ep] for sj in sends], dim=1))
            for k in range(ep)]
        parts = []
        for j, (slot, gates, shape, cap) in enumerate(routed):
            back = torch.cat([h[:, j * cap:(j + 1) * cap] for h in outs], 0)
            parts.append(moe._combine(back, slot, gates, x.dtype)
                         .reshape(shape))
        rows.append(torch.cat(parts, 1) if nt > 1 else parts[0])
    return torch.cat(rows, 0), torch.stack(auxes).mean()


def cfg21e():
    """tinyllama-1.1b at full width, ``LAYERS21E`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH21E), n_layers=LAYERS21E)


def f32_compute21(fn):
    """``fn()`` with the models' compute dtype float32 (``layers`` and
    ``moe``)."""
    import torch
    from repro_torch.models import layers, moe
    saved = layers.Compute, moe.Compute
    layers.Compute = moe.Compute = torch.float32
    try:
        return fn()
    finally:
        layers.Compute, moe.Compute = saved


def blocked21(fn):
    """``fn()`` with the transformer family's MoE layers on
    ``blocked_moe21``."""
    from repro_torch.models import transformer
    saved = transformer.moe_mlp
    transformer.moe_mlp = blocked_moe21
    try:
        return fn()
    finally:
        transformer.moe_mlp = saved


def stats21():
    """``MESH_STATS`` as {"name axes": [calls, MB, ms, the largest call's
    MB]}."""
    from repro_torch.launch import mesh as lm
    return stats_mb21(lm.MESH_STATS)


def stats_mb21(stats):
    """``MESH_STATS``-shaped ``stats`` (bytes, seconds) in MB and ms."""
    return {k: [v[0], round(v[1] / 1e6, 3), round(v[2] * 1e3, 3),
                round(v[3] / 1e6, 3)] for k, v in sorted(stats.items())}


def logits_mb21(rows, tokens, cfg, m, nbytes):
    """MB of one microbatch's logits on a rank of a ``m``-way "model" axis:
    its ``rows`` x ``tokens`` x vocab / m slice in ``nbytes``-byte
    floats."""
    return rows * tokens * (cfg.padded_vocab // m) * nbytes / 1e6


def vocab_parallel21(part, stats, slice_mb):
    """Check and print that a sharded step's loss gathered no logits over
    "model" (``stats`` of ``stats21``: no all-gather over "model" moved
    as much as one microbatch's logits slice on a rank, ``slice_mb``),
    with its collectives over "model" beside ``GATHERED21``'s."""
    over = {k: v[:3] for k, v in stats.items() if k.endswith(" model")}
    largest = stats.get("all_gather model", [0, 0.0, 0.0, 0.0])[3]
    check(largest < slice_mb, f"[21{part}] the step all-gathered "
          f"{largest} MB in one call over \"model\": a microbatch's "
          f"logits slice is {slice_mb:.3f} MB")
    print(f"[21{part}] the loss is vocab-parallel: the largest all-gather "
          f"over \"model\" {largest:.3f} MB (a microbatch's logits slice "
          f"on a rank: {slice_mb:.3f} MB); the step's collectives over "
          f"\"model\" [calls, MB, ms] {over}, "
          f"{sum(v[1] for v in over.values()):.3f} MB in "
          f"{sum(v[2] for v in over.values()):.3f} ms; with the logits "
          f"gathered: {GATHERED21.get(part, 'not measured')}")


def peak21():
    import torch
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else 0.0)


def phase21a_child(mesh, smesh, tmp):
    """(a) ``distributed_membership`` for both DFAs at both chunk counts,
    the 2-tier merge against the flat one, the int8 pod mean over this
    rank's shard of a tinyllama-1.1b gradient tree, and the pipeline."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compression as Q
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import mesh as lm
    from repro_torch.models import api

    rep = {}
    stream = np.load(os.path.join(tmp, "stream.npy"), mmap_mode="r")
    for tag, dfa in dfas21().items():
        classes = dfa.classes_of(stream).astype(np.int32)
        for nc in NC21:
            before = all_launches()
            got, wall = synced(lambda: C.distributed_membership(
                dfa.table, classes, dfa.start, dfa.sink, dfa.accepting,
                mesh, num_chunks_per_device=nc))
            rep[f"{tag}_{nc}"] = {"state": int(got), "s": wall,
                                  "launches": launch_delta(before)}
    # the merge tiers, on the same maps: chunk maps of the random DFA
    q = RANDOM21[0]
    g = torch.Generator(device=mesh.device).manual_seed(SEED)
    maps = torch.randint(0, q, (mesh.axis_size(("pod", "data")) * 64, q),
                         generator=g, device=mesh.device, dtype=torch.int32)
    want = np.arange(q)
    for m in maps.cpu().numpy():
        want = m[want]
    times = {"hier": [], "flat": []}
    tiers = {}
    for name in ("hier", "flat", "flat", "hier"):
        fn = (C.hierarchical_merge_lvecs if name == "hier"
              else C.flat_merge_lvecs)
        lm.reset_mesh_stats()
        lm.time_collectives(True)
        got, wall = synced(lambda: fn(maps, mesh))
        lm.time_collectives(False)
        check(np.array_equal(got.cpu().numpy(), want),
              f"[21a] {name} merge differs from the host fold")
        times[name].append(wall)
        tiers[name] = stats21()
    rep["merge"] = {"times": times, "tiers": tiers}
    # the int8 pod mean over this rank's shard of tinyllama's gradients
    tcfg = get_config("tinyllama-1.1b")
    shapes = api.param_shapes(tcfg)
    specs = shr.param_specs(shapes, mesh)
    pod = mesh.coordinate("pod")

    def grads_of(p):
        g = torch.Generator(device=mesh.device).manual_seed(SEED + 100 + p)
        out = {}
        for path, shape in sorted(_flat21(shapes).items()):
            idx = shr.local_slices(shape, _at21(specs, path), mesh.shape,
                                   mesh.get_coordinate())
            local = tuple(s.stop - s.start for s in idx)
            out[path] = torch.randn(local, generator=g, device=mesh.device)
        return out

    grads = grads_of(pod)
    err = Q.init_error_state(grads)
    n_el = sum(x.numel() for x in grads.values())
    walls = []
    for _ in range(2):
        lm.reset_mesh_stats()
        lm.time_collectives(True)
        (mean, err), wall = synced(lambda: Q.compressed_pod_mean(
            grads, err, mesh))
        lm.time_collectives(False)
        walls.append(wall)
        if len(walls) == 1:
            other = grads_of(1 - pod)
            worst = 0.0
            for path, m in mean.items():
                g0, g1 = (grads[path], other[path]) if pod == 0 else \
                    (other[path], grads[path])
                s0, s1 = (g0.abs().max() / 127, g1.abs().max() / 127)
                gap = ((m - (g0 + g1) / 2).abs().max() / ((s0 + s1) / 4))
                worst = max(worst, float(gap))
            del other
            check(worst <= 1.0 + 1e-3, f"[21a] int8 pod mean off by {worst}"
                  " half-steps")
    rep["compress"] = {"elements": n_el, "s": walls, "worst_half_steps":
                       worst, "stats": stats21()}
    del grads, err, mean
    # the pipeline over ranks 0-3
    if smesh.get_coordinate() is not None:
        s, m, d = PIPE21
        g = torch.Generator(device=mesh.device).manual_seed(SEED + 2)
        ws = torch.randn((s, d, d), generator=g, device=mesh.device) \
            * d ** -0.5
        xs = torch.randn((m, 16, d), generator=g, device=mesh.device)
        lm.reset_mesh_stats()
        lm.time_collectives(True)
        got, wall = synced(lambda: pipeline_apply(
            lambda w, x: torch.tanh(x @ w), ws, xs, smesh))
        lm.time_collectives(False)
        want = xs
        for i in range(s):
            want = torch.tanh(want @ ws[i])
        rep["pipeline"] = {"s": wall, "err": float((got - want).abs().max()),
                           "stats": stats21()}
    return rep


def _flat21(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat21(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _at21(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def keyed21(trees):
    """(``name-path`` key, leaf) of each leaf of ``trees`` ({name: tree}),
    in key order."""
    for name, tree in trees.items():
        for path, leaf in sorted(_flat21(tree).items()):
            yield "-".join((name,) + path), leaf


def save_leaves21(directory, trees):
    """Each leaf of ``trees`` (plain tensors) as ``directory/key.npy``."""
    os.makedirs(directory, exist_ok=True)
    for key, leaf in keyed21(trees):
        np.save(os.path.join(directory, key + ".npy"), leaf.cpu().numpy())


def gathered21(trees):
    """(key, the whole leaf as numpy) of each ``DTensor`` leaf of
    ``trees``, on the first rank of its mesh (``None`` on the others).
    Collective over the leaves' mesh."""
    from repro_torch.launch import mesh as lm
    for key, leaf in keyed21(trees):
        whole = lm.whole_on_host(leaf, writer_only=True)
        yield key, None if whole is None else whole.numpy()


def gap21(key, got, want):
    """A parameter's max |gap|; a moment leaf's relative L2 gap."""
    if key.startswith("params-"):
        return float(np.abs(got - want).max())
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def like21(cfg):
    """A restore template of ``cfg``'s train state with ``"err"``: 0-d
    leaves of each leaf's dtype on the card (a restored leaf takes its
    shape from the checkpoint)."""
    import torch
    from repro_torch.models import api

    def leaves(tree):
        return {k: leaves(v) if isinstance(v, dict) else torch.empty(
            (), dtype=torch.float32, device=DEVICE) for k, v in tree.items()}

    shapes = api.param_shapes(cfg)
    return {"params": leaves(shapes),
            "opt": {"m": leaves(shapes), "v": leaves(shapes),
                    "step": torch.empty((), dtype=torch.int32,
                                        device=DEVICE)},
            "err": leaves(shapes)}


def phase21c_after_restore(tmp):
    """The step the world took after its restore onto (2, 2), taken in this
    process from the same checkpoint, batch, config and options: its loss,
    grad_norm and each moment leaf's relative L2 gap to the world's."""
    import torch
    from repro_torch.training import restore_checkpoint
    from repro_torch.training import train_loop as TL

    cfg = cfg21(train=True, no_drop=True)
    state, at = restore_checkpoint(os.path.join(tmp, "ckpt21"), like21(cfg))
    step = TL.make_train_step(cfg, None, opts21(aux=0.0))
    batch = batch21(cfg, torch.device(DEVICE))
    state, m = f32_compute21(lambda: step(state, batch))
    out = {"step": at, **{k: float(v) for k, v in m.items()}}
    after = os.path.join(tmp, "after21")
    out["gaps"] = {key: gap21(key, leaf.cpu().numpy(), np.load(
        os.path.join(after, key + ".npy"))) for key, leaf in keyed21(
            {"m": state["opt"]["m"], "v": state["opt"]["v"]})}
    del state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def phase21b_child(mesh, tmp):
    """(b) granite-moe-1b-a400m at full width, ``LAYERS21`` layers, on the
    partitioned program (tensor-parallel attention, experts under expert
    parallelism, each rank its rows), in float32 compute (tensor
    parallelism sums the attention's heads in another order than one
    process; blockwise attention, B9 takes bf16 only): prefill at the
    published capacity factor and at E / top_k, then constrained decode
    (B5) at the published factor."""
    import torch
    from repro_torch.core import compile_regex
    from repro_torch.distributed import sharding as shr
    from repro_torch.models import api
    from repro_torch.serving import (GrammarConstraint, ServeConfig,
                                     ServingEngine)

    cfg = cfg21()
    params, init_s = synced(lambda: api.init(
        cfg, SEED, device=mesh.device, keep=shr.param_keep(mesh)))
    z = np.load(os.path.join(tmp, "prompts.npz"))
    toks = torch.from_numpy(z["tokens"]).to(mesh.device)
    rep = {"init_s": init_s}
    (logits, cache), rep["prefill_s"] = synced(lambda: f32_compute21(
        lambda: api.prefill(params, cfg, {"tokens": toks}, mesh=mesh,
                            attn_route="blockwise")))
    del cache
    (logits_nd, cache), rep["prefill_nodrop_s"] = synced(
        lambda: f32_compute21(lambda: api.prefill(
            params, cfg21(no_drop=True), {"tokens": toks}, mesh=mesh,
            attn_route="blockwise")))
    del cache
    if mesh.get_coordinate() == [0, 0, 0]:
        np.savez(os.path.join(tmp, "prefill_mesh.npz"),
                 logits=logits.float().cpu().numpy(),
                 nodrop=logits_nd.float().cpu().numpy())
    del logits, logits_nd
    gc = GrammarConstraint(compile_regex(GRAMMAR12), cfg.padded_vocab,
                           eos_id=None, device=mesh.device)
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=DECODE21),
                        constraint=gc, mesh=mesh)
    out, rep["generate_s"] = synced(lambda: f32_compute21(
        lambda: eng.generate(z["grammar"])))
    if mesh.get_coordinate() == [0, 0, 0]:
        np.save(os.path.join(tmp, "generate_mesh.npy"), out)
    rep["peak_gib"] = peak21()
    return rep


def phase21e_child(mesh, tmp):
    """(e) tinyllama-1.1b at full width (``LAYERS21E`` layers) on the
    partitioned program: a bf16 prefill of ``PREFILL21E`` (B9 on the
    rank's rows and query heads), the same prefill in float32 compute
    (blockwise), then
    ``DECODE21E`` constrained greedy steps (B5 on the rank's rows) in
    float32 compute; the collectives of each and the rank's peak memory
    over this part."""
    import torch
    from repro_torch.core import compile_regex
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch import mesh as lm
    from repro_torch.models import api
    from repro_torch.serving import (GrammarConstraint, ServeConfig,
                                     ServingEngine)

    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = cfg21e()
    params, init_s = synced(lambda: api.init(
        cfg, SEED, device=mesh.device, keep=shr.param_keep(mesh)))
    z = np.load(os.path.join(tmp, "prompts21e.npz"))
    batch = {"tokens": torch.from_numpy(z["tokens"]).to(mesh.device)}
    rep = {"init_s": init_s, "wq": list(params["layers"]["attn"]["wq"]
                                        .shape)}
    first = mesh.get_coordinate() == [0, 0, 0]
    lm.reset_mesh_stats()
    lm.time_collectives(True)
    before = all_launches()
    (logits, cache), rep["prefill_s"] = synced(lambda: api.prefill(
        params, cfg, batch, mesh=mesh))
    rep["prefill_launches"] = launch_delta(before)
    lm.time_collectives(False)
    rep["prefill_stats"] = stats21()
    rep["cache"] = list(cache["k"].shape)
    del cache
    if first:
        np.save(os.path.join(tmp, "prefill21e.npy"),
                logits.float().cpu().numpy())
    del logits
    lm.reset_mesh_stats()
    lm.time_collectives(True)
    (logits, cache), rep["prefill32_s"] = synced(lambda: f32_compute21(
        lambda: api.prefill(params, cfg, batch, mesh=mesh,
                            attn_route="blockwise")))
    lm.time_collectives(False)
    rep["prefill32_stats"] = stats21()
    del cache
    if first:
        np.save(os.path.join(tmp, "prefill21e32.npy"), logits.cpu().numpy())
    del logits
    gc = GrammarConstraint(compile_regex(GRAMMAR12), cfg.padded_vocab,
                           eos_id=None, device=mesh.device)
    eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=DECODE21E),
                        constraint=gc, mesh=mesh)
    lm.reset_mesh_stats()
    lm.time_collectives(True)
    before = all_launches()
    out, rep["generate_s"] = synced(lambda: f32_compute21(
        lambda: eng.generate(z["grammar"])))
    rep["generate_launches"] = launch_delta(before)
    lm.time_collectives(False)
    rep["generate_stats"] = stats21()
    if first:
        np.save(os.path.join(tmp, "generate21e.npy"), out)
    rep["tokens"] = out.tolist()
    rep["peak_gib"] = peak21()
    del params, eng
    return rep


def phase21c_child(mesh, tmp):
    """(c) the sharded train step of granite-moe-1b-a400m (depth cut to
    ``TRAIN21[3]`` layers) against the one-process card step, at a capacity
    factor where no choice drops and aux weight 0 (the sharded layer
    averages each token block's aux loss, as the reference's
    ``_moe_sharded``: not the whole batch's): parameters and, per leaf, m
    and v; then two int8 steps at the published factor and aux weight; a
    save, a restore onto (2, 2) ranks 0-3 and one more step at E / top_k
    and aux weight 0, its moments saved for the same step in one
    process."""
    import torch
    from repro_torch.launch import mesh as lm
    from repro_torch.training import CheckpointManager
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import _tree_map

    cfg = cfg21(train=True, no_drop=True)
    batch = batch21(cfg, mesh.device)
    rep = {}
    opts = opts21(aux=0.0)
    state, init_s = synced(lambda: TL.init_train_state_sharded(
        cfg, SEED, mesh, opts))
    step = TL.make_train_step(cfg, mesh, opts)
    lm.reset_mesh_stats()
    lm.time_collectives(True)
    (state, m), wall = synced(lambda: f32_compute21(
        lambda: step(state, batch)))
    lm.time_collectives(False)
    rep["none"] = {"init_s": init_s, "s": wall, "stats": stats21(),
                   **{k: float(v) for k, v in m.items()}}
    lr = float(m["lr"])
    ref = os.path.join(tmp, "ref21c")
    rep["none"]["gaps"] = {
        key: gap21(key, got, np.load(os.path.join(ref, key + ".npy")))
        for key, got in gathered21({"params": state["params"],
                                    "m": state["opt"]["m"],
                                    "v": state["opt"]["v"]})
        if got is not None}
    rep["none"]["param_tol"] = 2 * lr + 1e-6
    del state
    torch.cuda.empty_cache() if DEVICE == "cuda" else None
    # two int8 steps on one batch, from a fresh state
    cfg = cfg21(train=True)
    opts8 = opts21("int8")
    state = TL.init_train_state_sharded(cfg, SEED, mesh, opts8)
    step8 = TL.make_train_step(cfg, mesh, opts8)
    rep["int8"] = []
    for _ in range(2):
        lm.reset_mesh_stats()
        lm.time_collectives(True)
        (state, m), wall = synced(lambda: step8(state, batch))
        lm.time_collectives(False)
        rep["int8"].append({"s": wall, "stats": stats21(),
                            **{k: float(v) for k, v in m.items()}})
    mgr = CheckpointManager(os.path.join(tmp, "ckpt21"), use_async=False)
    _, rep["save_s"] = synced(lambda: (mgr.save(state, 2), mgr.wait()))
    like = _tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device="meta"), state)
    del state
    torch.cuda.empty_cache() if DEVICE == "cuda" else None
    mesh_b = lm.make_local_mesh(2, 2, device=None if DEVICE == "cuda"
                                else DEVICE)
    if mesh_b.get_coordinate() is not None:
        (back, at), rep["restore_s"] = synced(lambda: mgr.restore(
            like, TL.state_shardings(like, mesh_b)))
        check(at == 2 and "err" in back, f"[21c] restored step {at}")
        cfg_b = cfg21(train=True, no_drop=True)
        step_b = TL.make_train_step(cfg_b, mesh_b, opts21(aux=0.0))
        (back, m), wall = synced(lambda: f32_compute21(
            lambda: step_b(back, batch)))
        rep["after_restore"] = {"s": wall,
                                **{k: float(v) for k, v in m.items()}}
        after = os.path.join(tmp, "after21")
        os.makedirs(after, exist_ok=True)
        for key, got in gathered21({"m": back["opt"]["m"],
                                    "v": back["opt"]["v"]}):
            if got is not None:
                np.save(os.path.join(after, key + ".npy"), got)
        del back
    rep["peak_gib"] = peak21()
    return rep


def cfg21f(family):
    """The 21(f) config of ``family``: published widths, ``LAYERS21F``
    layers (the enc-dec: as many encoder layers)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(dict(FAMILIES21F)[family])
    n = LAYERS21F[family]
    return dataclasses.replace(cfg, n_layers=n, **(
        {"n_enc_layers": n} if family == "encdec" else {}))


def serve21f(family, params, cfg, inputs, mesh=None):
    """21(f)'s serving of one family, on ``mesh`` or in one process: the
    bf16 prefill (the enc-dec decoder's self-attention on B9), the
    float32-compute prefill (blockwise), then ``DECODE21F`` float32-compute
    decode steps (the enc-dec from the float32 prefill's cache against the
    one-process encoder memory ``inputs["memory"]``, the hybrid and ssm
    from their zero state).  Returns ({part: last-position logits as
    numpy}, {part: seconds}, {part: launches}, {part: collectives})."""
    import torch
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch import mesh as lm
    from repro_torch.models import api
    from repro_torch.models import encdec as ED
    from repro_torch.models import recurrent as RG
    from repro_torch.models import xlstm as XL

    dev = DEVICE if mesh is None else mesh.device
    batch = {k: torch.from_numpy(inputs[f"{family}_{k}"]).to(dev)
             for k in ("tokens", "frames") if f"{family}_{k}" in inputs}
    logits, secs, launches, stats = {}, {}, {}, {}

    def part(name, fn):
        lm.reset_mesh_stats()
        lm.time_collectives(mesh is not None)
        before = all_launches()
        out, secs[name] = synced(fn)
        launches[name] = launch_delta(before)
        lm.time_collectives(False)
        stats[name] = stats21()
        return out

    out, _ = part("bf16", lambda: api.prefill(params, cfg, batch, mesh=mesh))
    logits["bf16"] = out.float().cpu().numpy()
    out, cache = part("f32", lambda: f32_compute21(lambda: api.prefill(
        params, cfg, batch, mesh=mesh, attn_route="blockwise")))
    logits["f32"] = out.cpu().numpy()
    b, t = batch["tokens"].shape
    rows = b if mesh is None else b // shr.dp_parts(mesh, b)
    dec = torch.from_numpy(inputs[f"{family}_decode"]).to(dev)

    def steps():
        """The decode steps from the float32 cache or zero state (made in
        the float32 compute dtype)."""
        if family == "encdec":
            state = {"cache": ED.init_encdec_cache(
                cfg, rows, t + DECODE21F, device=dev, mesh=mesh)}
            for k in state["cache"]:
                state["cache"][k][:, :, :t] = cache[k]
            state["memory"] = torch.from_numpy(inputs["memory"]).to(dev)
            pos = t
        else:
            init = (RG.init_hybrid_state if family == "hybrid"
                    else XL.init_xlstm_state)
            state = {"state": init(cfg, rows, device=dev, mesh=mesh)}
            pos = 0
        outs = []
        for i in range(DECODE21F):
            out, _ = api.decode(params, cfg, {
                "tokens": dec[:, i:i + 1], "pos": pos + i, **state},
                mesh=mesh)
            outs.append(out[:, -1].cpu().numpy())
        return np.stack(outs)

    logits["decode"] = part("decode", lambda: f32_compute21(steps))
    return logits, secs, launches, stats


def phase21f_references(tmp, rng):
    """21(f)'s one-process card runs, in this process: each family's
    inputs (``inputs21f.npz``, with the enc-dec's float32 encoder memory
    of its frames), its ``serve21f`` logits and peak memory, and
    recurrentgemma-2b's train step in float32 compute (its loss and norm;
    its parameters and moments saved leaf by leaf in ``ref21f/``)."""
    import torch
    from repro_torch.models import api
    from repro_torch.models import encdec as ED
    from repro_torch.training import train_loop as TL

    ref, inputs = {}, {}
    for family, _ in FAMILIES21F:
        cfg = cfg21f(family)
        b, t = PREFILL21F[family]
        inputs[f"{family}_tokens"] = rng.integers(
            0, cfg.vocab_size, size=(b, t)).astype(np.int32)
        inputs[f"{family}_decode"] = rng.integers(
            0, cfg.vocab_size, size=(b, DECODE21F)).astype(np.int32)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = api.init(cfg, SEED, device=DEVICE)
        if family == "encdec":
            frames = rng.normal(0, 1, size=(b, t, cfg.d_model))
            inputs["encdec_frames"] = frames.astype(np.float32)
            inputs["memory"] = f32_compute21(lambda: ED.encode(
                params, cfg, torch.from_numpy(inputs["encdec_frames"])
                .to(DEVICE))).cpu().numpy()
        logits, secs, _, _ = serve21f(family, params, cfg, inputs)
        ref[f"f_{family}"] = logits
        ref[f"f_{family}_s"] = secs
        ref[f"f_{family}_peak_gib"] = peak21()
        del params
    np.savez(os.path.join(tmp, "inputs21f.npz"), **inputs)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = cfg21f("hybrid")
    state = TL.init_train_state(cfg, SEED, device=DEVICE)
    step = TL.make_train_step(cfg, None, opts21(aux=0.0, nm=1))
    batch = batch21(cfg, torch.device(DEVICE), TRAIN21F)
    (state, m), ref["f_train_s"] = synced(lambda: f32_compute21(
        lambda: step(state, batch)))
    ref["f_train"] = {k: float(v) for k, v in m.items()}
    ref["f_train_peak_gib"] = peak21()
    save_leaves21(os.path.join(tmp, "ref21f"), {
        "params": state["params"], "m": state["opt"]["m"],
        "v": state["opt"]["v"]})
    del state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return ref


def block_gaps21f(state, ref_dir, mesh):
    """Each leaf of a sharded step's parameters and moments against the
    one-process leaves in ``ref_dir``: a parameter's max |gap|, a moment
    leaf's relative L2 gap.  Each rank reads and compares only its own
    block (no leaf is gathered), each element counted once over its
    replicas; one sum and one max over the mesh.  Collective."""
    import math

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shr

    keys, sums, worst = [], [], []
    n = mesh.size()
    for key, leaf in keyed21({"params": state["params"],
                              "m": state["opt"]["m"],
                              "v": state["opt"]["v"]}):
        placements = tuple(leaf.placements)
        ref = np.load(os.path.join(ref_dir, key + ".npy"), mmap_mode="r")
        idx = shr.local_slices(ref.shape, placements, mesh.shape,
                               mesh.get_coordinate())
        local = leaf.to_local().detach().double()
        want = torch.from_numpy(np.ascontiguousarray(ref[idx])).to(
            local.device).double()
        diff = local - want
        share = math.prod(mesh.axis_size(a) for a, _ in
                          shr.shards_of(placements, mesh)) / n
        keys.append(key)
        sums.append([share * float(torch.sum(diff * diff)),
                     share * float(torch.sum(want * want))])
        worst.append(float(diff.abs().max()) if diff.numel() else 0.0)
        del local, want, diff
    sums, worst = torch.tensor(sums), torch.tensor(worst)
    group = mesh.group(mesh.mesh_dim_names)
    dist.all_reduce(sums, group=group)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    return {k: float(worst[i]) if k.startswith("params-") else
            math.sqrt(float(sums[i, 0])) / max(math.sqrt(float(sums[i, 1])),
                                               1e-30)
            for i, k in enumerate(keys)}


def phase21f_child(mesh, tmp):
    """(f) recurrentgemma-2b, xlstm-1.3b and seamless-m4t-medium at
    published widths (``LAYERS21F`` layers) on the partitioned program,
    one model at a time (``serve21f``: each rank its rows and its channels
    or heads), then recurrentgemma-2b's tensor-parallel train step in
    float32 compute on ``MESH21F``; the peaks, collectives and launches of
    each."""
    import torch
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch import mesh as lm
    from repro_torch.models import api
    from repro_torch.training import train_loop as TL

    inputs = dict(np.load(os.path.join(tmp, "inputs21f.npz")))
    first = mesh.get_coordinate() == [0, 0, 0]
    rep = {}
    for family, _ in FAMILIES21F:
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = cfg21f(family)
        params, init_s = synced(lambda: api.init(
            cfg, SEED, device=mesh.device, keep=shr.param_keep(mesh)))
        logits, secs, launches, stats = serve21f(family, params, cfg,
                                                 inputs, mesh)
        if first:
            np.savez(os.path.join(tmp, f"f21_{family}.npz"), **logits)
        rep[family] = {"init_s": init_s, "s": secs, "launches": launches,
                       "stats": stats, "peak_gib": peak21(),
                       "argmax": {k: v.argmax(-1).tolist()
                                  for k, v in logits.items()}}
        del params, logits
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tmesh = lm.make_mesh(MESH21F, ("data", "model"),
                         device=None if DEVICE == "cuda" else DEVICE)
    cfg = cfg21f("hybrid")
    opts = opts21(aux=0.0, nm=1)
    state, init_s = synced(lambda: TL.init_train_state_sharded(
        cfg, SEED, tmesh, opts))
    step = TL.make_train_step(cfg, tmesh, opts)
    batch = batch21(cfg, tmesh.device, TRAIN21F)
    lm.reset_mesh_stats()
    lm.time_collectives(True)
    (state, m), wall = synced(lambda: f32_compute21(
        lambda: step(state, batch)))
    lm.time_collectives(False)
    rep["train"] = {"init_s": init_s, "s": wall, "stats": stats21(),
                    "peak_gib": peak21(),
                    **{k: float(v) for k, v in m.items()}}
    rep["train"]["gaps"] = block_gaps21f(state, os.path.join(tmp, "ref21f"),
                                         tmesh)
    del state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return rep


def cfg21g(family):
    """The 21(g) config of ``family``: published widths, ``LAYERS21G``
    layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(dict(FAMILIES21F)[family]),
                               n_layers=LAYERS21G[family])


def state_mb21g(family, cfg, rows, mesh=None):
    """(MB of the attention blocks' ring or the mLSTM blocks' ``C`` and
    ``n``, MB of the whole decode state) of ``rows`` rows on a rank of
    ``mesh`` (``None``: one process)."""
    from repro_torch.models import recurrent as RG
    from repro_torch.models import xlstm as XL
    init = (RG.init_hybrid_state if family == "hybrid"
            else XL.init_xlstm_state)
    split = total = 0
    for path, leaf in _flat21(init(cfg, rows, device="meta",
                                   mesh=mesh)).items():
        nb = leaf.numel() * leaf.element_size()
        total += nb
        if any(k.endswith(("_attn", "_mlstm")) for k in path):
            split += nb
    return split / 1e6, total / 1e6


def phase21g_references(tmp, rng):
    """21(g)'s one-process card runs, in this process: each family's
    inputs (``inputs21g.npz``), its ``serve21f`` logits and peak memory,
    and its decode state's MB."""
    import torch
    from repro_torch.models import api

    ref, inputs = {}, {}
    for family in LAYERS21G:
        cfg = cfg21g(family)
        b, t = PREFILL21G[family]
        inputs[f"{family}_tokens"] = rng.integers(
            0, cfg.vocab_size, size=(b, t)).astype(np.int32)
        inputs[f"{family}_decode"] = rng.integers(
            0, cfg.vocab_size, size=(b, DECODE21F)).astype(np.int32)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = api.init(cfg, SEED, device=DEVICE)
        logits, secs, _, _ = serve21f(family, params, cfg, inputs)
        ref[f"g_{family}"] = logits
        ref[f"g_{family}_s"] = secs
        ref[f"g_{family}_peak_gib"] = peak21()
        ref[f"g_{family}_state_mb"] = state_mb21g(family, cfg, b)
        del params
    np.savez(os.path.join(tmp, "inputs21g.npz"), **inputs)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return ref


def phase21g_child(tmp):
    """(g) recurrentgemma-2b and xlstm-1.3b at published widths
    (``LAYERS21G`` layers) on ("data", "model") = ``MESH21G``, one model
    at a time (``serve21f``): 10 and 4 heads do not divide 8, so each
    rank computes the attention's and the mLSTM's head_dim / 8 columns
    of every head and keeps that block of the ring and of ``C``/``n``;
    the peaks, collectives, launches and state MB of each."""
    import torch
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch import mesh as lm
    from repro_torch.models import api

    gmesh = lm.make_mesh(MESH21G, ("data", "model"),
                         device=None if DEVICE == "cuda" else DEVICE)
    inputs = dict(np.load(os.path.join(tmp, "inputs21g.npz")))
    m, r = gmesh.axis_size("model"), gmesh.coordinate("model")
    rep = {}
    for family in LAYERS21G:
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = cfg21g(family)
        hd = cfg.hd if family == "hybrid" else cfg.d_model // cfg.n_heads
        params, init_s = synced(lambda: api.init(
            cfg, SEED, device=gmesh.device, keep=shr.param_keep(gmesh)))
        logits, secs, launches, stats = serve21f(family, params, cfg,
                                                 inputs, gmesh)
        if r == 0:
            np.savez(os.path.join(tmp, f"g21_{family}.npz"), **logits)
        b = PREFILL21G[family][0]
        rows = b // shr.dp_parts(gmesh, b)
        rep[family] = {"init_s": init_s, "s": secs, "launches": launches,
                       "stats": stats, "peak_gib": peak21(),
                       "head_dim": shr.model_head_dim(cfg.n_heads, hd, m, r),
                       "state_mb": state_mb21g(family, cfg, rows, gmesh),
                       "argmax": {k: v.argmax(-1).tolist()
                                  for k, v in logits.items()}}
        del params, logits
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return rep


def phase21_child(argv):
    """One rank of phase 21's world (``python3 chip_smoke.py
    --phase21-child rank world store tmp [parts]``): eight processes share
    the card over gloo on the ("pod", "data", "model") mesh (2, 2, 2).
    Writes its measurements as JSON."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as lm

    rank, world = int(argv[0]), int(argv[1])
    store, tmp = argv[2:4]
    parts = argv[4] if len(argv) > 4 else PARTS21
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=CHILD21_S))
    try:
        _build.build_all()   # the parent's build: loaded, not compiled
        dev = None if DEVICE == "cuda" else DEVICE
        mesh = lm.make_mesh(MESH21, ("pod", "data", "model"), device=dev)
        smesh = lm.make_mesh((4,), ("stage",), device=dev)
        rep = {"rank": rank, "coordinate": mesh.get_coordinate(),
               "transport": mesh.transport, "device": str(mesh.device)}
        reset_all_launches()
        runs = (("a", lambda: phase21a_child(mesh, smesh, tmp)),
                ("b", lambda: phase21b_child(mesh, tmp)),
                ("c", lambda: phase21c_child(mesh, tmp)),
                ("e", lambda: phase21e_child(mesh, tmp)),
                ("f", lambda: phase21f_child(mesh, tmp)),
                ("g", lambda: phase21g_child(tmp)))
        for part, fn in ((p, fn) for p, fn in runs if p in parts):
            before = all_launches()
            t0 = time.perf_counter()
            rep[part] = fn()
            rep[part]["wall_s"] = time.perf_counter() - t0
            rep[part]["launches_total"] = launch_delta(before)
        # (c), (e), (f) and (g) restart the peak's count: the rank's peak
        # is the largest
        rep["peak_gib"] = max(
            [peak21()] + [rep[p]["peak_gib"] for p in "ce" if p in rep]
            + [v["peak_gib"] for p in "fg" for v in rep.get(p, {}).values()
               if isinstance(v, dict) and "peak_gib" in v])
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(rep, fh)
    finally:
        dist.destroy_process_group()
    return 0


def phase21_oracle(tmp):
    """``dfa.run`` of 21(a)'s stream for both DFAs (a process of its own,
    beside the spawned world)."""
    stream = np.load(os.path.join(tmp, "stream.npy"), mmap_mode="r")
    out = {tag: int(dfa.run(np.asarray(stream)))
           for tag, dfa in dfas21().items()}
    with open(os.path.join(tmp, "oracle.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def phase21_references(tmp, rng, parts=PARTS21):
    """The one-process card runs the world is held to, in float32 compute
    where tensor parallelism reorders a sum: (b) prefill logits at the
    published capacity factor through ``blocked_moe21`` and at E / top_k
    through the local path, and constrained decode at the published factor
    through ``blocked_moe21``; (c) one step of the cut model (its
    parameters and moments saved leaf by leaf); (e) tinyllama-1.1b's
    prefill in bf16 (B9) and in float32 compute, its constrained greedy
    tokens in float32 compute, and this process's peak memory over (e);
    (f) ``phase21f_references``.  ``parts``: the parts to make."""
    import torch
    from repro_torch.core import compile_regex
    from repro_torch.models import api
    from repro_torch.serving import (GrammarConstraint, ServeConfig,
                                     ServingEngine)
    from repro_torch.training import train_loop as TL

    ref = {}
    if "b" in parts:
        cfg = cfg21()
        b, t = PREFILL21
        toks = rng.integers(0, cfg.vocab_size,
                            size=(b, t)).astype(np.int32)
        gram = grammar_prompts(rng, b, PROMPT21)
        np.savez(os.path.join(tmp, "prompts.npz"), tokens=toks,
                 grammar=gram)
        params = api.init(cfg, SEED, device=DEVICE)
        batch = {"tokens": torch.from_numpy(toks).to(DEVICE)}

        def prefill(c):
            return f32_compute21(lambda: api.prefill(
                params, c, batch, attn_route="blockwise"))

        blocked, _ = blocked21(lambda: prefill(cfg))
        plain, _ = prefill(cfg)
        # how far the mesh's token blocks move the logits from the local
        # path at the published factor (each block drops its own choices)
        ref.update({"logits": blocked.float().cpu().numpy(),
                    "plain_share": float((~torch.isclose(
                        plain.float(), blocked.float(), rtol=1e-5,
                        atol=MISMATCH21[1])).float().mean())})
        del blocked, plain
        logits, _ = prefill(cfg21(no_drop=True))
        ref["nodrop"] = logits.float().cpu().numpy()
        del logits
        gc = GrammarConstraint(compile_regex(GRAMMAR12), cfg.padded_vocab,
                               eos_id=None, device=DEVICE)
        eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=DECODE21),
                            constraint=gc)
        ref["tokens"] = blocked21(lambda: f32_compute21(
            lambda: eng.generate(gram)))
        del params, eng
    if "c" in parts:
        tcfg = cfg21(train=True, no_drop=True)
        opts = opts21(aux=0.0)
        state = TL.init_train_state(tcfg, SEED, device=DEVICE)
        step = TL.make_train_step(tcfg, None, opts)
        batch = batch21(tcfg, torch.device(DEVICE))
        state, m = f32_compute21(lambda: step(state, batch))
        ref.update({k: float(v) for k, v in m.items()})
        save_leaves21(os.path.join(tmp, "ref21c"), {
            "params": state["params"], "m": state["opt"]["m"],
            "v": state["opt"]["v"]})
        del state
    if "e" in parts:
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = cfg21e()
        b, t = PREFILL21E
        toks = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
        gram = grammar_prompts(rng, b, PROMPT21)
        np.savez(os.path.join(tmp, "prompts21e.npz"), tokens=toks,
                 grammar=gram)
        params = api.init(cfg, SEED, device=DEVICE)
        batch = {"tokens": torch.from_numpy(toks).to(DEVICE)}
        logits, _ = api.prefill(params, cfg, batch)
        ref["e_bf16"] = logits.float().cpu().numpy()
        logits, _ = f32_compute21(lambda: api.prefill(
            params, cfg, batch, attn_route="blockwise"))
        ref["e_f32"] = logits.cpu().numpy()
        del logits
        gc = GrammarConstraint(compile_regex(GRAMMAR12), cfg.padded_vocab,
                               eos_id=None, device=DEVICE)
        eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=DECODE21E),
                            constraint=gc)
        ref["e_tokens"] = f32_compute21(lambda: eng.generate(gram))
        ref["e_peak_gib"] = peak21()
        del params, eng
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    if "f" in parts:
        ref.update(phase21f_references(tmp, rng))
    if "g" in parts:
        ref.update(phase21g_references(tmp, rng))
    return ref


def phase21d_launcher():
    """(d) ``launch.train`` on a (2, 2) mesh under ``torch.distributed.run``
    (four ranks sharing the card over gloo) at published widths and
    ``LAYERS_CLI`` layers, a small batch, 2 steps; each printed step
    against the same step of the launcher's stream, initial state and
    options run in this process on one device."""
    import shutil
    import socket
    import tempfile

    b, t, steps = CLI21
    one = launcher_reference(cli_config(), b, t, 1, steps)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke21d_")
    argv = [sys.executable, "-m", "torch.distributed.run",
            "--nproc-per-node", "4", "--master-port", str(port), "-m",
            "repro_torch.launch.train",
            "--arch", ARCH20, "--layers", str(LAYERS_CLI),
            "--batch", str(b), "--seq", str(t),
            "--steps", str(steps), "--log-every", "1", "--mesh-data", "2",
            "--mesh-model", "2", "--log-collectives",
            "--ckpt-dir", os.path.join(tmp, "ckpt")]
    if DEVICE != "cuda":                  # a rehearsal on the CPU
        argv += ["--device", DEVICE, "--smoke"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        t0 = time.perf_counter()
        res = subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=CLI21_S)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(res.returncode == 0, f"[21d] the launcher exited "
          f"{res.returncode}: {res.stdout[-2000:]}{res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith(("step ", "checkpoint", "done"))]
    for ln in lines:
        print(f"[21d] mesh (2, 2): {ln}")
    print(f"[21d] the launcher on (2, 2): {wall:.1f} s of command")
    mesh = dict(launcher_line(ln) for ln in lines if ln.startswith("step "))
    check(sorted(mesh) == list(range(steps)), f"[21d] steps {sorted(mesh)}")
    # each step's collectives (bf16 compute: 2-byte logits), rank 0
    colls = [json.loads(ln.split(": ", 1)[1])
             for ln in res.stdout.splitlines()
             if ln.startswith("collectives step ")]
    check(len(colls) == steps, f"[21d] {len(colls)} collectives lines")
    for i, st in enumerate(colls):
        vocab_parallel21(f"d step {i}", stats_mb21(st),
                         logits_mb21(b // 2, t, cli_config(), 2, 2))
    gaps = {k: max(abs(mesh[i][k] - one[i][k])
                   / (one[i][k] if k != "loss" else 1) for i in one)
            for k in LINE21_TOL}
    check(all(gaps[k] <= LINE21_TOL[k] for k in gaps),
          f"[21d] the mesh launcher's lines {mesh} differ from one "
          f"process's {one}: gaps {gaps}")
    print(f"[21d] its steps equal one process's (the launcher's stream, "
          f"state and options on one device) within {LINE21_TOL} (gnorm "
          f"and lr relative; gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + ")")


def phase21_mesh(counts, parts=PARTS21):
    """The LM mesh on the card: eight ranks sharing it over gloo on
    ("pod", "data", "model") = (2, 2, 2): (a) collectives, (b) serving
    granite-moe-1b-a400m under tensor and expert parallelism, (c) sharded
    training, (e) tinyllama-1.1b served at full width on the
    partitioned program, (f) the hybrid, ssm and enc-dec families on it,
    (g) recurrentgemma-2b and xlstm-1.3b on ("data", "model") = (1, 8),
    split on head_dim, then (d) the launcher on a (2, 2) mesh.
    ``parts``: the parts to run (``python3 chip_smoke.py --phase21 g``
    runs (g) alone)."""
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke21_")
    try:
        rng = np.random.default_rng(SEED + 21)
        stream = make_docs(rng, [BYTES21 // 64] * 64)
        np.save(os.path.join(tmp, "stream.npy"),
                np.frombuffer(b"".join(stream), np.uint8))
        del stream
        env = {**os.environ, "PYTHONUNBUFFERED": "1"}
        oracle = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase21-oracle",
             tmp], env=env, cwd=ROOT) if "a" in parts else None
        t0 = time.perf_counter()
        ref = phase21_references(tmp, rng, parts)
        archs = ", ".join(a for _, a in FAMILIES21F)
        print(f"[21] one-process references of parts {parts} "
              f"(granite-moe-1b-a400m prefill {PREFILL21}, generate, a "
              f"train step at {TRAIN21[3]} layers; {ARCH21E} prefill "
              f"{PREFILL21E} and generate; {archs} served, "
              f"recurrentgemma-2b's step; (g)'s two at "
              f"{LAYERS21G} layers) in {time.perf_counter() - t0:.1f} s")
        n = int(np.prod(MESH21))
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase21-child",
             str(r), str(n), os.path.join(tmp, "store"), tmp, parts],
            env=env, cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        waited = procs + ([oracle] if oracle is not None else [])
        try:
            for p in waited:
                p.wait(timeout=max(CHILD21_S - (time.perf_counter() - t0),
                                   1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in waited:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        spawn_s = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            check(p.returncode == 0, f"[21] rank {r} exited "
                  f"{p.returncode}:\n" + text[-4000:])
        reps = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                reps.append(json.load(fh))
        oracle_states = after = None
        if oracle is not None:
            check(oracle.returncode == 0, "[21a] the dfa.run oracle failed")
            with open(os.path.join(tmp, "oracle.json")) as fh:
                oracle_states = json.load(fh)
        print(f"[21] {n} ranks on {MESH21} ('pod', 'data', 'model') sharing "
              f"the card over gloo (device tensors staged through host "
              f"memory), spawn to exit {spawn_s:.1f} s")
        if "c" in parts:
            t0 = time.perf_counter()
            after = phase21c_after_restore(tmp)
            print(f"[21c] the step after the restore, in one process: "
                  f"{time.perf_counter() - t0:.1f} s")
        phase21_report(reps, ref, oracle_states, after, tmp, counts, parts)
        if "d" in parts:
            t0 = time.perf_counter()
            phase21d_launcher()
            print(f"[21d] in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase21e_report(reps, ref, tmp):
    """Print and check 21(e): every rank launched B9 in its prefill and B5
    in its decode steps; the prefill's logits within ``F32_21E`` (float32
    compute) and ``BF16_21E`` (bf16) of one process's, of its largest
    |logit|, argmax equal in float32; the greedy tokens equal to one
    process's on every rank."""
    cfg = cfg21e()
    e = reps[0]["e"]
    m = MESH21[2]
    got16 = np.load(os.path.join(tmp, "prefill21e.npy"))
    scale16 = float(np.abs(ref["e_bf16"]).max())
    share = float(np.mean(~np.isclose(got16, ref["e_bf16"],
                                      atol=MISMATCH21[1])))
    gap16 = float(np.abs(got16 - ref["e_bf16"]).max())
    rows16 = int((got16.argmax(-1) == ref["e_bf16"].argmax(-1)).sum())
    got = np.load(os.path.join(tmp, "prefill21e32.npy"))
    scale = float(np.abs(ref["e_f32"]).max())
    gap = float(np.abs(got - ref["e_f32"]).max())
    print(f"[21e] {ARCH21E}, full width, {cfg.n_layers} layers, on the "
          f"partitioned "
          f"program: rank 0 holds wq {e['wq']} ({cfg.n_heads // m} of "
          f"{cfg.n_heads} query heads, d_model over 'data'), its cache "
          f"{e['cache']} (its {PREFILL21E[0] // (MESH21[0] * MESH21[1])} "
          f"rows, the kv heads its query heads read); init "
          f"{e['init_s']:.2f} s")
    print(f"[21e] bf16 prefill {PREFILL21E} on B9 (launches a rank "
          f"{[r['e']['prefill_launches'].get('flash_attn', 0) for r in reps]}"
          f", BH = rows x {cfg.n_heads // m} heads): "
          f"{min(r['e']['prefill_s'] for r in reps):.3f}-"
          f"{max(r['e']['prefill_s'] for r in reps):.3f} s a rank; logits "
          f"against one process: |max| {scale16:.3f}, max |gap| "
          f"{gap16:.4e} ({gap16 / scale16:.3e}; bound {BF16_21E}), mismatch "
          f"share (atol {MISMATCH21[1]}) {share:.4f}, rows equal in argmax "
          f"{rows16}/{got16.shape[0]}; collectives [calls, MB, ms, "
          f"largest MB] {e['prefill_stats']}")
    print(f"[21e] float32-compute prefill (blockwise): "
          f"{e['prefill32_s']:.3f} s (rank 0); max |gap| {gap:.4e} of |max| "
          f"{scale:.3f} ({gap / scale:.3e}; bound {F32_21E}); collectives "
          f"{e['prefill32_stats']}")
    equal = [np.array_equal(np.array(r["e"]["tokens"]), ref["e_tokens"])
             for r in reps]
    print(f"[21e] float32-compute generate, {DECODE21E} constrained greedy "
          f"steps (B5 on each rank's rows, launches a rank "
          f"{[r['e']['generate_launches'].get('token_mask', 0) for r in reps]}"
          f"): {min(r['e']['generate_s'] for r in reps):.3f}-"
          f"{max(r['e']['generate_s'] for r in reps):.3f} s a rank, tokens "
          f"equal to one process's on {sum(equal)}/{len(reps)} ranks; "
          f"collectives {e['generate_stats']}")
    print(f"[21e] peak memory over (e), GiB: one process "
          f"{ref['e_peak_gib']:.2f}; a rank " + ", ".join(
              f"{r['rank']}: {r['e']['peak_gib']:.2f}" for r in reps))
    for r in reps:
        check(r["e"]["prefill_launches"].get("flash_attn", 0)
              == cfg.n_layers, f"[21e] rank {r['rank']} prefill launches "
              f"{r['e']['prefill_launches']}")
        check(r["e"]["generate_launches"].get("token_mask", 0) == DECODE21E,
              f"[21e] rank {r['rank']} generate launches "
              f"{r['e']['generate_launches']}")
    check(all(equal), f"[21e] tokens differ from one process's on ranks "
          f"{[r['rank'] for r, ok in zip(reps, equal) if not ok]}")
    check(np.isfinite(got16).all() and gap16 <= BF16_21E * scale16,
          f"[21e] bf16 prefill logits: max |gap| {gap16} of |max| "
          f"{scale16} against one process (bound {BF16_21E} of it)")
    check(gap <= F32_21E * scale and np.array_equal(
        got.argmax(-1), ref["e_f32"].argmax(-1)),
          f"[21e] float32 prefill logits: max |gap| {gap} of |max| {scale}"
          f" against one process (bound {F32_21E} of it)")


def phase21f_report(reps, ref, tmp):
    """Print and check 21(f): each family's float32-compute prefill and
    decode logits within ``F32_21E`` of one process's largest |logit|,
    argmax equal on every rank; its bf16 prefill within ``BF16_21E``; B9
    in every rank's enc-dec bf16 prefill (one a decoder layer) and nowhere
    else in (f); recurrentgemma-2b's step within ``F32_21`` of one
    process (parameters within 2 lr + 1e-6)."""
    m = MESH21[2]
    for family, arch in FAMILIES21F:
        cfg = cfg21f(family)
        want = ref[f"f_{family}"]
        got = np.load(os.path.join(tmp, f"f21_{family}.npz"))
        gaps = {}
        for part in ("bf16", "f32", "decode"):
            scale = float(np.abs(want[part]).max())
            gaps[part] = (float(np.abs(got[part] - want[part]).max()), scale)
        for r in reps:
            for part in ("f32", "decode"):
                check(np.array_equal(np.array(r["f"][family]["argmax"][part]),
                                     want[part].argmax(-1)),
                      f"[21f] {arch} rank {r['rank']}: {part} argmax "
                      f"differs from one process's")
            b9 = [r["f"][family]["launches"][p].get("flash_attn", 0)
                  for p in ("bf16", "f32", "decode")]
            check(b9 == [cfg.n_layers if family == "encdec" else 0, 0, 0],
                  f"[21f] {arch} rank {r['rank']}: B9 launches {b9} "
                  f"(bf16 prefill, float32 prefill, decode)")
        f = reps[0]["f"][family]
        b, t = PREFILL21F[family]
        print(f"[21f] {arch}, published widths, {LAYERS21F[family]} layers"
              f"{' each side' if family == 'encdec' else ''}, prompts "
              f"({b}, {t}) on the partitioned program: init "
              f"{f['init_s']:.2f} s; bf16 prefill "
              f"{min(r['f'][family]['s']['bf16'] for r in reps):.3f}-"
              f"{max(r['f'][family]['s']['bf16'] for r in reps):.3f} s a "
              f"rank (one process {ref[f'f_{family}_s']['bf16']:.3f}), "
              f"max |gap| {gaps['bf16'][0]:.4e} of |max| "
              f"{gaps['bf16'][1]:.3f} "
              f"({gaps['bf16'][0] / gaps['bf16'][1]:.3e}; bound "
              f"{BF16_21E}); float32 prefill "
              f"{f['s']['f32']:.3f} s (rank 0), max |gap| "
              f"{gaps['f32'][0]:.4e} ({gaps['f32'][0] / gaps['f32'][1]:.3e}"
              f"); {DECODE21F} float32 decode steps {f['s']['decode']:.3f} "
              f"s (rank 0), max |gap| {gaps['decode'][0]:.4e} "
              f"({gaps['decode'][0] / gaps['decode'][1]:.3e}); bound "
              f"{F32_21E}, argmax equal on {len(reps)} ranks")
        print(f"[21f] {arch} collectives [calls, MB, ms, largest MB] "
              f"(rank 0): " + "; ".join(f"{p}: {f['stats'][p]}"
                          for p in ("bf16", "f32", "decode")))
        print(f"[21f] {arch} peak memory, GiB: one process "
              f"{ref[f'f_{family}_peak_gib']:.2f}; a rank " + ", ".join(
                  f"{r['rank']}: {r['f'][family]['peak_gib']:.2f}"
                  for r in reps) + f" (m = {m})")
        for part in ("bf16", "f32", "decode"):
            bound = BF16_21E if part == "bf16" else F32_21E
            check(np.isfinite(got[part]).all()
                  and gaps[part][0] <= bound * gaps[part][1],
                  f"[21f] {arch} {part} logits: max |gap| {gaps[part][0]} "
                  f"of |max| {gaps[part][1]} against one process (bound "
                  f"{bound} of it)")
    tr = reps[0]["f"]["train"]
    one = ref["f_train"]
    gaps = tr["gaps"]
    worst = max(v for k, v in gaps.items() if k.startswith("params-"))
    moments = max(v for k, v in gaps.items() if not k.startswith("params-"))
    tol = 2 * one["lr"] + 1e-6
    b, t = TRAIN21F
    print(f"[21f] recurrentgemma-2b train step ({LAYERS21F['hybrid']} "
          f"layers, {b} x {t} tokens, 1 microbatch, float32 compute) on "
          f"('data', 'model') = {MESH21F}: {tr['s']:.3f} s (one process "
          f"{ref['f_train_s']:.3f}), loss {tr['loss']:.6f} vs "
          f"{one['loss']:.6f}, grad_norm {tr['grad_norm']:.6f} vs "
          f"{one['grad_norm']:.6f}, m and v per leaf within {moments:.3e} "
          f"relative L2, worst parameter gap {worst:.3e} (bound {tol:.3e}),"
          f" each rank comparing its own blocks; collectives {tr['stats']}; "
          f"peak GiB: one process {ref['f_train_peak_gib']:.2f}, a rank "
          + ", ".join(f"{r['rank']}: {r['f']['train']['peak_gib']:.2f}"
                      for r in reps))
    vocab_parallel21("f", tr["stats"], logits_mb21(
        b // MESH21F[0], t, cfg21f("hybrid"), MESH21F[1], 4))
    check(abs(tr["loss"] - one["loss"]) <= F32_21["loss"]
          and abs(tr["grad_norm"] - one["grad_norm"])
          <= F32_21["gnorm"] * one["grad_norm"],
          f"[21f] train step loss {tr['loss']} gnorm {tr['grad_norm']} vs "
          f"one process {one['loss']} {one['grad_norm']}")
    check(worst <= tol and moments <= F32_21["leaf"],
          f"[21f] train step against one process: worst parameter gap "
          f"{worst} (bound {tol}), worst moment leaf {moments} relative L2 "
          f"(bound {F32_21['leaf']})")


def phase21g_report(reps, ref, tmp):
    """Print and check 21(g): on every rank the rules split each family's
    attention or mLSTM on head_dim (``sharding.model_head_dim``), its ring
    or ``C``/``n`` is 1 / m of one process's, and no part launched B9 (the
    split prefill takes the blockwise route, ``layers._kernel_route``);
    the float32-compute prefill and decode logits within ``F32_21E`` of
    one process's largest |logit|, argmax equal on every rank; the bf16
    prefill within ``BF16_21E``."""
    m = MESH21G[1]
    parts = ("bf16", "f32", "decode")
    for family in LAYERS21G:
        arch = dict(FAMILIES21F)[family]
        want = ref[f"g_{family}"]
        got = np.load(os.path.join(tmp, f"g21_{family}.npz"))
        gaps = {}
        for part in parts:
            scale = float(np.abs(want[part]).max())
            gaps[part] = (float(np.abs(got[part] - want[part]).max()), scale)
        one_split, one_total = ref[f"g_{family}_state_mb"]
        for r in reps:
            g = r["g"][family]
            check(g["head_dim"] is not None, f"[21g] {arch} rank "
                  f"{r['rank']}: the rules do not split head_dim on "
                  f"{MESH21G}")
            for part in ("f32", "decode"):
                check(np.array_equal(np.array(g["argmax"][part]),
                                     want[part].argmax(-1)),
                      f"[21g] {arch} rank {r['rank']}: {part} argmax "
                      f"differs from one process's")
            b9 = [g["launches"][p].get("flash_attn", 0) for p in parts]
            check(b9 == [0, 0, 0], f"[21g] {arch} rank {r['rank']}: B9 "
                  f"launches {b9} (bf16 prefill, float32 prefill, decode)")
            check(np.isclose(g["state_mb"][0] * m, one_split),
                  f"[21g] {arch} rank {r['rank']}: its split state "
                  f"{g['state_mb'][0]} MB is not 1/{m} of one process's "
                  f"{one_split} MB")
        g0 = reps[0]["g"][family]
        b, t = PREFILL21G[family]
        what = "ring (k, v)" if family == "hybrid" else "C and n"
        print(f"[21g] {arch}, published widths, {LAYERS21G[family]} "
              f"layers, prompts ({b}, {t}) on ('data', 'model') = "
              f"{MESH21G}: head_dim columns a rank "
              + ", ".join(f"{r['rank']}: {r['g'][family]['head_dim']}"
                          for r in reps) + f"; init {g0['init_s']:.2f} s")
        print(f"[21g] {arch} decode state a rank, MB (its {what} / the "
              f"whole state): one process {one_split:.3f} / "
              f"{one_total:.3f}; a rank " + ", ".join(
                  f"{r['rank']}: {r['g'][family]['state_mb'][0]:.3f} / "
                  f"{r['g'][family]['state_mb'][1]:.3f}" for r in reps))
        print(f"[21g] {arch} attention route: blockwise (a head_dim split "
              f"never takes B9, layers._kernel_route); B9 launches a rank "
              f"(bf16 prefill, float32 prefill, decode) " + ", ".join(
                  f"{r['rank']}: " + "/".join(
                      str(r["g"][family]["launches"][p].get("flash_attn",
                                                            0))
                      for p in parts) for r in reps))
        print(f"[21g] {arch} bf16 prefill "
              f"{min(r['g'][family]['s']['bf16'] for r in reps):.3f}-"
              f"{max(r['g'][family]['s']['bf16'] for r in reps):.3f} s a "
              f"rank (one process {ref[f'g_{family}_s']['bf16']:.3f}), "
              f"max |gap| {gaps['bf16'][0]:.4e} of |max| "
              f"{gaps['bf16'][1]:.3f} "
              f"({gaps['bf16'][0] / gaps['bf16'][1]:.3e}; bound "
              f"{BF16_21E}); float32 prefill {g0['s']['f32']:.3f} s "
              f"(rank 0), max |gap| {gaps['f32'][0]:.4e} "
              f"({gaps['f32'][0] / gaps['f32'][1]:.3e}); {DECODE21F} "
              f"float32 decode steps {g0['s']['decode']:.3f} s (rank 0), "
              f"max |gap| {gaps['decode'][0]:.4e} "
              f"({gaps['decode'][0] / gaps['decode'][1]:.3e}); bound "
              f"{F32_21E}, argmax equal on {len(reps)} ranks")
        print(f"[21g] {arch} collectives [calls, MB, ms, largest MB] "
              f"(rank 0): " + "; ".join(f"{p}: {g0['stats'][p]}"
                                        for p in parts))
        print(f"[21g] {arch} peak memory, GiB: one process "
              f"{ref[f'g_{family}_peak_gib']:.2f}; a rank " + ", ".join(
                  f"{r['rank']}: {r['g'][family]['peak_gib']:.2f}"
                  for r in reps) + f" (m = {m})")
        for part in parts:
            bound = BF16_21E if part == "bf16" else F32_21E
            check(np.isfinite(got[part]).all()
                  and gaps[part][0] <= bound * gaps[part][1],
                  f"[21g] {arch} {part} logits: max |gap| {gaps[part][0]} "
                  f"of |max| {gaps[part][1]} against one process (bound "
                  f"{bound} of it)")


def phase21a_report(reps, oracle_states):
    """Print and check 21(a): the stream's final states against
    ``dfa.run``, the merge tiers, the int8 pod mean, the pipeline."""
    for tag in ("pcre", "random"):
        for nc in NC21:
            res = [rep["a"][f"{tag}_{nc}"] for rep in reps]
            check(all(r["state"] == oracle_states[tag] for r in res),
                  f"[21a] {tag} nc={nc}: {[r['state'] for r in res]} != "
                  f"dfa.run {oracle_states[tag]}")
            kind = "onehot_block_maps" if tag == "pcre" else "spec_match"
            check(all(r["launches"].get(kind, 0) > 0
                      and r["launches"].get("lvec_compose", 0) > 0
                      for r in res), f"[21a] {tag} nc={nc}: launches "
                  f"{res[0]['launches']}")
            walls = [r["s"] for r in res]
            print(f"[21a] distributed_membership {tag} ({BYTES21} bytes, "
                  f"{len(reps)} ranks x {nc} chunks a dp rank): final state "
                  f"{res[0]['state']} = dfa.run; {min(walls):.3f}-"
                  f"{max(walls):.3f} s a rank; rank 0 launches "
                  f"{res[0]['launches']}")
    mg = reps[0]["a"]["merge"]
    print(f"[21a] 2-tier merge vs flat (rank 0, 256 maps of "
          f"{RANDOM21[0]} states, gloo on one card: host staging, not the "
          f"paper's intra/inter-node gap): hierarchical "
          f"{[round(x * 1e3, 3) for x in mg['times']['hier']]} ms, flat "
          f"{[round(x * 1e3, 3) for x in mg['times']['flat']]} ms; "
          f"collectives [calls, MB, ms, largest MB]: hierarchical "
          f"{mg['tiers']['hier']}, flat {mg['tiers']['flat']}")
    cp = reps[0]["a"]["compress"]
    print(f"[21a] compressed_pod_mean over rank 0's shard of tinyllama-1.1b's"
          f" gradients ({cp['elements']} float32): {cp['s']} s a round; "
          f"worst error {cp['worst_half_steps']:.3f} half-steps of the "
          f"pods' scales; collectives {cp['stats']}")
    for rep in reps[:4]:
        pl = rep["a"]["pipeline"]
        check(pl["err"] <= 1e-4, f"[21a] pipeline rank {rep['rank']}: "
              f"max |err| {pl['err']}")
    pl = reps[0]["a"]["pipeline"]
    print(f"[21a] pipeline_apply over ('stage',) = 4 ranks, {PIPE21}: "
          f"{pl['s']:.4f} s, max |err| vs the sequential stages "
          f"{max(r['a']['pipeline']['err'] for r in reps[:4]):.2e}; "
          f"collectives {pl['stats']}")


def phase21b_report(reps, ref, tmp):
    """Print and check 21(b): granite-moe-1b-a400m's prefill logits and
    constrained tokens on the mesh against one process."""
    pre = np.load(os.path.join(tmp, "prefill_mesh.npz"))
    got = pre["logits"]
    share = float(np.mean(~np.isclose(got, ref["logits"],
                                      atol=MISMATCH21[1])))
    share_nd = float(np.mean(~np.isclose(pre["nodrop"], ref["nodrop"],
                                         atol=MISMATCH21[1])))
    gap = np.abs(got - ref["logits"])
    print(f"[21b] float32 compute: prefill logits at the published capacity "
          f"factor against one process on blocked_moe21: |max| "
          f"{np.abs(ref['logits']).max():.3f}, max |gap| {gap.max():.4e}, "
          f"rows equal in argmax "
          f"{int((got.argmax(-1) == ref['logits'].argmax(-1)).sum())}/"
          f"{got.shape[0]}; the local path's logits differ from the "
          f"blocked ones in {ref['plain_share']:.4f} of entries")
    del gap
    check(share < MISMATCH21[0], f"[21b] prefill logits at the published "
          f"capacity factor: mismatch share {share} against one process on "
          f"blocked_moe21")
    check(share_nd < MISMATCH21[0], f"[21b] prefill logits at E / top_k: "
          f"mismatch share {share_nd} against the one-process card run")
    tokens = np.load(os.path.join(tmp, "generate_mesh.npy"))
    equal = (tokens == ref["tokens"]).all(1)
    check(bool(equal.all()), f"[21b] decoded tokens differ from one process "
          f"on blocked_moe21 on rows {np.flatnonzero(~equal)}")
    b = reps[0]["b"]
    print(f"[21b] granite-moe-1b-a400m, full width, {LAYERS21} layers, "
          f"tensor-parallel attention, 16 experts a model rank, float32 "
          f"compute: init {b['init_s']:.2f} s; prefill {PREFILL21} "
          f"{b['prefill_s']:.3f} s (rank 0), logits mismatch share (atol "
          f"{MISMATCH21[1]}) {share:.4f} at the published factor against "
          f"one process on blocked_moe21, {share_nd:.4f} at E / top_k "
          f"({b['prefill_nodrop_s']:.3f} s) against the local path; "
          f"generate at the published factor, {DECODE21} constrained steps "
          f"{b['generate_s']:.3f} s, tokens equal on {int(equal.sum())}/"
          f"{len(equal)} rows")


def phase21c_report(reps, ref, after):
    """Print and check 21(c): the sharded step, the int8 steps and the
    step after the restore against one process."""
    c0 = reps[0]["c"]
    nonec = c0["none"]
    check(abs(nonec["loss"] - ref["loss"]) <= F32_21["loss"]
          and abs(nonec["grad_norm"] - ref["grad_norm"])
          <= F32_21["gnorm"] * ref["grad_norm"],
          f"[21c] sharded step loss {nonec['loss']} gnorm "
          f"{nonec['grad_norm']} vs one process {ref['loss']} "
          f"{ref['grad_norm']}")
    gaps = nonec["gaps"]
    worst = max(v for k, v in gaps.items() if k.startswith("params-"))
    moments = max(v for k, v in gaps.items() if not k.startswith("params-"))
    check(worst <= nonec["param_tol"] and moments <= F32_21["leaf"],
          f"[21c] against the one-process step: worst parameter gap {worst}"
          f" (bound {nonec['param_tol']}), worst moment leaf {moments} "
          f"relative L2 (bound {F32_21['leaf']})")
    l1, l2 = (s["loss"] for s in c0["int8"])
    check(np.isfinite(l1) and np.isfinite(l2) and l2 < l1 + 0.5,
          f"[21c] int8 losses {l1}, {l2}")
    ar = c0["after_restore"]
    restored = max(after["gaps"].values())
    check(after["step"] == 2
          and abs(ar["loss"] - after["loss"]) <= F32_21["loss"]
          and abs(ar["grad_norm"] - after["grad_norm"])
          <= F32_21["gnorm"] * after["grad_norm"]
          and restored <= F32_21["leaf"],
          f"[21c] the step after the restore onto (2, 2): loss {ar['loss']}"
          f" gnorm {ar['grad_norm']} vs one process from the same checkpoint"
          f" {after['loss']} {after['grad_norm']}; worst moment leaf "
          f"{restored} relative L2 (bound {F32_21['leaf']})")
    print(f"[21c] sharded step ({TRAIN21[3]}-layer granite-moe-1b-a400m, "
          f"float32 compute, "
          f"{TRAIN21[0]} x {TRAIN21[1]} tokens in {TRAIN21[2]} microbatches)"
          f": {nonec['s']:.3f} s, loss {nonec['loss']:.6f} vs "
          f"{ref['loss']:.6f}, grad_norm {nonec['grad_norm']:.6f} vs "
          f"{ref['grad_norm']:.6f}, m and v per leaf within {moments:.3e} "
          f"relative L2 <= {F32_21['leaf']}, worst parameter gap {worst:.3e} "
          f"(bound {nonec['param_tol']:.3e}); collectives of the step "
          f"[calls, MB, ms, largest MB] {nonec['stats']}")
    pod, data, m = MESH21
    vocab_parallel21("c", nonec["stats"], logits_mb21(
        TRAIN21[0] // TRAIN21[2] // (pod * data), TRAIN21[1],
        cfg21(train=True), m, 4))
    for i, s in enumerate(c0["int8"]):
        print(f"[21c] int8 step {i}: {s['s']:.3f} s, loss {s['loss']:.6f}, "
              f"collectives {s['stats']}")
    print(f"[21c] save {c0['save_s']:.2f} s; restored onto (2, 2) in "
          f"{c0['restore_s']:.2f} s (rank 0); its step (E / top_k, aux 0) "
          f"{ar['s']:.3f} s, loss {ar['loss']:.6f} vs {after['loss']:.6f} "
          f"and grad_norm {ar['grad_norm']:.6f} vs {after['grad_norm']:.6f} "
          f"in one process from the same checkpoint, m and v per leaf "
          f"within {restored:.3e} relative L2")


def phase21_report(reps, ref, oracle_states, after, tmp, counts,
                   parts=PARTS21):
    """Check and print what the world reported; add its launches to
    ``counts``."""
    for rep in reps:
        check(rep["transport"] == "gloo", f"[21] rank {rep['rank']}: "
              f"transport {rep['transport']}")
        check(DEVICE != "cuda" or rep["device"].startswith("cuda"),
              f"[21] rank {rep['rank']} computed on {rep['device']}")
    if "a" in parts:
        phase21a_report(reps, oracle_states)
    if "b" in parts:
        phase21b_report(reps, ref, tmp)
    if "c" in parts:
        phase21c_report(reps, ref, after)
    if "e" in parts:
        phase21e_report(reps, ref, tmp)
    if "f" in parts:
        phase21f_report(reps, ref, tmp)
    if "g" in parts:
        phase21g_report(reps, ref, tmp)
    print("[21] peak memory a rank (GiB): " + ", ".join(
        f"{r['rank']}: {r['peak_gib']:.2f}" for r in reps))
    ran = [p for p in "abcefg" if p in parts]
    print(f"[21] each rank's ({'), ('.join(ran)}) in s: " + ", ".join(
        f"{r['rank']}: " + "/".join(f"{r[p]['wall_s']:.1f}" for p in ran)
        for r in reps))
    total = {}
    for rep in reps:
        for part in ran:
            for k, v in rep[part]["launches_total"].items():
                total[k] = total.get(k, 0) + v
    # the kernels each part launches: (a) B6, B8 + B7, (b) B5, (c) and
    # (f) B1 (the filtered stream), (e) B9 and B5, (f) B9; (g) none (its
    # head_dim split prefill is blockwise)
    need = {"a": ("spec_match", "lvec_compose", "onehot_block_maps"),
            "b": ("token_mask",), "c": ("spec_match_merge",),
            "e": ("token_mask", "flash_attn"),
            "f": ("spec_match_merge", "flash_attn"), "g": ()}
    for name in sorted({k for p in ran for k in need[p]}):
        check(total.get(name, 0) > 0, f"[21] the world launched no "
              f"{name}: {total}")
    for k, v in total.items():
        counts[k] = counts.get(k, 0) + v
    print(f"[21] launches over the world's ranks: {total}")


def phase21_alone(parts):
    """``python3 chip_smoke.py --phase21 PARTS``: the card's name and power
    limit, the build, then phase 21's ``parts`` alone (``f``: 21(f);
    ``abcdef``: all of it) and the world's launches."""
    import torch
    if not torch.cuda.is_available() and DEVICE == "cuda":
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[21] build {time.perf_counter() - t0:.1f} s")
    counts = {}
    t0 = time.perf_counter()
    phase21_mesh(counts, parts)
    print(f"[21] parts {parts} in {time.perf_counter() - t0:.1f} s; "
          f"launches {counts}")
    return 0


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
            matcher, policy=policy), docs9, plans, seg9), tag, cpu=False)
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

    # -- phase 18: the sharded backend ----------------------------------------
    t0 = time.perf_counter()
    phase18_sharded(ps, docs, want3, m)
    print(f"[18] phase 18 in {time.perf_counter() - t0:.1f} s")

    # -- phase 19: every model family at full width ---------------------------
    phase22_start()              # 22(a)'s fake trace, beside phases 19-20(a)
    t0 = time.perf_counter()
    phase19_families(counts)
    print(f"[19] phase 19 in {time.perf_counter() - t0:.1f} s")

    # -- phase 20: training on the card ---------------------------------------
    t0 = time.perf_counter()
    phase20_training(counts)
    print(f"[20] phase 20 in {time.perf_counter() - t0:.1f} s")

    # -- phase 21: the LM mesh ------------------------------------------------
    t0 = time.perf_counter()
    phase21_mesh(counts)
    print(f"[21] phase 21 in {time.perf_counter() - t0:.1f} s")
    for name in kernels:
        kernels[name]["launches"] = counts[name]

    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase18-child"]:
        sys.exit(phase18_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase21-child"]:
        sys.exit(phase21_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase21-oracle"]:
        sys.exit(phase21_oracle(sys.argv[2]))
    if sys.argv[1:2] == ["--phase21"]:
        sys.exit(phase21_alone(sys.argv[2]))
    if sys.argv[1:2] == ["--phase22-traces"]:
        sys.exit(phase22_traces_child(sys.argv[2]))
    try:
        rc = main()
    finally:
        phase22_stop()
    sys.exit(rc)
