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


def device_busy(fn, tag):
    """Run ``fn`` once under torch.profiler; print its wall time, the device
    busy time (device-side events only: kernels and copies — an aten op's
    own device time repeats its kernels', and the profiler's buffer
    requests are its own overhead), the device idle share of the wall time
    and the largest kernels.  Returns the idle share (None when the
    profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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


def check(cond, what):
    if not cond:
        raise AssertionError(what)


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
