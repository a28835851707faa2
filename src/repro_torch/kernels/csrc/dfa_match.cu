// Speculative chunk scans for Hopper (sm_90a): the fused scan + in-CTA
// Eq. 8 fold (B1, B2) and the plain chunk x lane scan (B6).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   B1  repro/kernels/dfa_match.py::spec_match_merge_kernel       (LANES=false)
//   B2  repro/kernels/dfa_match.py::spec_match_merge_lanes_kernel (LANES=true)
// both with their shared symbol-block body `_scan_block_with_exit`, and
//   B6  repro/kernels/dfa_match.py::spec_match_kernel             (spec_match)
// The symbol scan itself (table placement, staged symbol tiles, several
// lanes per thread) is spec_scan.cuh, shared by all three.
//
// What it computes, per document b (one CTA each):
//   * every lane of the [C, K*S] carry (chunk x pattern x candidate) steps
//     through the chunk's L symbols: idx = state * n_cls_pad + class into
//     the packed table, whose last column is the identity (padding);
//   * after every l_blk symbols the CTA votes whether all its lanes sit in
//     absorbing states; once they do, the remaining symbol blocks are not
//     scanned and are counted into skipped[b] (the Pallas kernel's exact
//     block granularity, so positions derived from it agree);
//   * the Eq. 8 fold over chunks 1..C-1 through cand_index, the sink on a
//     miss and passthrough on the pad key: B1 folds one exact state per
//     pattern -> out[b, K]; B2 folds lane for lane -> out[b, K*S].
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move are the symbols
// (B*C*L*4) plus the init lanes (B*C*K*S*4), read once; for the PCRE-14 set
// at B=64, C=8, L=8192 that is ~17 MB, about 5 us.  The work is B*C*K*S*L
// lane-steps, each one int32 add and one dependent table load from shared
// memory: ~0.9e9 for that shape.  The card serves 32 four-byte shared-memory
// words per SM per clock (~8.4e12 loads/s over 132 SMs; its int32 issue rate
// is twice that), so the loads bind: ~0.1 ms.  With the early exit the
// chip_smoke.py inputs need ~0.47e9 lane-steps (~0.056 ms); this kernel takes
// ~1.4 ms per launch there (~0.33e12 lane-steps/s, ~25x its bound, on an
// H100 80GB HBM3 at 700 W): one CTA per document fills 64 of the 132 SMs,
// each lane is a chain of L dependent table loads, and a warp's random
// gathers conflict in the shared-memory banks.  The scan (spec_scan.cuh)
// keeps the chains short in latency and many: the pre-scaled table in
// shared memory when it fits (29 KiB for PCRE-14), staged symbol tiles,
// several lanes per thread.  The lane carry lives in shared memory between
// tiles when it fits, else in a global scratch row of the document.
// Left for later: classifying bytes in the kernel (uint8 input), several
// documents per CTA, and more CTAs than one batch tile's 64 (64 CTAs leave
// most of the 132 SMs idle).
//
// B6, spec_match: C chunks x S lanes through the table, no fold (paper
// Listing 2).  The paper engine's matcher slot (lookahead mode, S = I_max
// candidate lanes), and with C = S = 1 its sequential matcher.  The grid
// runs over blocks of c_blk chunks x s_blk lanes (spec_plan in
// dfa_match.py picks them so that about two CTAs per SM are in flight and
// no CTA holds more than 4096 lanes: a PROSITE search DFA has up to 22,857
// lanes per chunk).  A CTA keeps its lanes in shared memory between symbol
// tiles; the table goes to shared memory when it fits and is read from
// global memory otherwise (the large PROSITE search tables, 0.3-1 MB).
// Bound: C*S*L lane-steps, each one dependent shared-memory load, at the
// card's 8.4e12 loads/s; against the symbols (C*L*4 bytes) and lanes read
// once at 3.35 TB/s.  The first kernel is latency-bound: one lane is a
// chain of L dependent loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spec_scan.cuh"

namespace {

using spec_scan::SYM_TILE;

template <bool LANES, bool TABLE_IN_SMEM>
__global__ void spec_match_merge(
        const int* __restrict__ table,      // [Q, n_cls_pad] unscaled
        const int* __restrict__ chunks,     // [B, C, L] classes
        const int* __restrict__ init,       // [B, C, K*S] entry lanes
        const int* __restrict__ lookahead,  // [B, C] boundary keys
        const int* __restrict__ cand_index, // [n_keys + 1, Q]
        const int* __restrict__ sinks,      // [K]
        const int* __restrict__ absorbing,  // [Q] 0/1
        int* __restrict__ out,              // [B, K] or [B, K*S]
        int* __restrict__ skipped,          // [B]
        int* __restrict__ scratch,          // [B, C*K*S] or null
        int C, int L, int Q, int n_cls_pad, int K, int S, int pad_key,
        int l_blk, int early_exit, int carry_in_smem) {
    extern __shared__ int smem[];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int ks = K * S;
    const int n_lanes = C * ks;

    int* s_table = smem;
    int* s_sym = smem + (TABLE_IN_SMEM ? Q * n_cls_pad : 0);
    int* carry = carry_in_smem ? s_sym + C * SYM_TILE
                               : scratch + (size_t)b * n_lanes;

    if (TABLE_IN_SMEM) {
        for (int i = tid; i < Q * n_cls_pad; i += nthreads)
            s_table[i] = table[i] * n_cls_pad;
    }
    const int* init_b = init + (size_t)b * n_lanes;
    for (int i = tid; i < n_lanes; i += nthreads)
        carry[i] = init_b[i] * n_cls_pad;
    __syncthreads();

    const int* chunks_b = chunks + (size_t)b * C * L;
    const int l_blocks = L / l_blk;
    int n_skipped = 0;
    for (int j = 0; j < l_blocks; ++j) {
        for (int t0 = j * l_blk; t0 < (j + 1) * l_blk; t0 += SYM_TILE) {
            const int tl = min(SYM_TILE, (j + 1) * l_blk - t0);
            spec_scan::stage_symbols(s_sym, chunks_b, C, L, t0, tl);
            __syncthreads();
            spec_scan::scan_tile<TABLE_IN_SMEM>(carry, n_lanes, ks, s_sym,
                                                tl, s_table, table,
                                                n_cls_pad);
            __syncthreads();
        }
        if (early_exit) {
            int mine = 1;
            for (int i = tid; i < n_lanes; i += nthreads)
                mine &= __ldg(absorbing + carry[i] / n_cls_pad);
            if (__syncthreads_and(mine)) {
                n_skipped = l_blocks - 1 - j;
                break;
            }
        }
    }
    if (tid == 0) skipped[b] = n_skipped;

    // Eq. 8 fold: lane states (unscaled) stay where the carry is, [C, K, S]
    for (int i = tid; i < n_lanes; i += nthreads) carry[i] /= n_cls_pad;
    __syncthreads();
    const int* la_b = lookahead + (size_t)b * C;
    const int n_out = LANES ? ks : K;
    for (int o = tid; o < n_out; o += nthreads) {
        const int k = LANES ? o / S : o;
        int st = LANES ? carry[o] : carry[k * S];
        const int sink = sinks[k];
        for (int i = 1; i < C; ++i) {
            const int la = la_b[i];
            if (la == pad_key) continue;   // whole chunk is padding
            const int lane = __ldg(cand_index + (size_t)la * Q + st);
            if (lane < 0) {
                if (sink >= 0) st = sink;
            } else {
                st = carry[i * ks + k * S + lane];
            }
        }
        out[(size_t)b * n_out + o] = st;
    }
}

template <bool LANES>
int launch(const int* table, const int* chunks, const int* init,
           const int* lookahead, const int* cand_index, const int* sinks,
           const int* absorbing, int* out, int* skipped, int* scratch,
           int B, int C, int L, int Q, int n_cls_pad, int K, int S,
           int pad_key, int l_blk, int early_exit, int table_in_smem,
           int carry_in_smem, void* stream) {
    const int n_lanes = C * K * S;
    int threads = ((n_lanes + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    size_t smem = (size_t)C * SYM_TILE * sizeof(int);
    if (table_in_smem) smem += (size_t)Q * n_cls_pad * sizeof(int);
    if (carry_in_smem) smem += (size_t)n_lanes * sizeof(int);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (table_in_smem) {
        auto kern = spec_match_merge<LANES, true>;
        spec_scan::allow_smem(kern, smem);
        kern<<<B, threads, smem, s>>>(table, chunks, init, lookahead,
                                      cand_index, sinks, absorbing, out,
                                      skipped, scratch, C, L, Q, n_cls_pad,
                                      K, S, pad_key, l_blk, early_exit,
                                      carry_in_smem);
    } else {
        auto kern = spec_match_merge<LANES, false>;
        spec_scan::allow_smem(kern, smem);
        kern<<<B, threads, smem, s>>>(table, chunks, init, lookahead,
                                      cand_index, sinks, absorbing, out,
                                      skipped, scratch, C, L, Q, n_cls_pad,
                                      K, S, pad_key, l_blk, early_exit,
                                      carry_in_smem);
    }
    return (int)cudaGetLastError();
}


// B6: chunks [c0, c0 + c_blk) x lanes [s0, s0 + s_blk) of one CTA.
template <bool TABLE_IN_SMEM>
__global__ void spec_match(const int* __restrict__ table,   // [Q, n_cls]
                           const int* __restrict__ chunks,  // [C, L]
                           const int* __restrict__ init,    // [C, S]
                           int* __restrict__ out,           // [C, S]
                           int C, int L, int Q, int n_cls, int S, int c_blk,
                           int s_blk) {
    extern __shared__ int smem[];
    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * c_blk, s0 = blockIdx.y * s_blk;
    const int rows = min(c_blk, C - c0), width = min(s_blk, S - s0);
    const int n_lanes = rows * width;
    int* s_table = smem;
    int* s_sym = smem + (TABLE_IN_SMEM ? Q * n_cls : 0);
    int* carry = s_sym + c_blk * SYM_TILE;

    if (TABLE_IN_SMEM) {
        for (int i = tid; i < Q * n_cls; i += blockDim.x)
            s_table[i] = table[i] * n_cls;
    }
    for (int i = tid; i < n_lanes; i += blockDim.x) {
        const int c = i / width;
        carry[i] = init[(size_t)(c0 + c) * S + s0 + i - c * width] * n_cls;
    }
    __syncthreads();
    const int* chunks_b = chunks + (size_t)c0 * L;
    for (int t0 = 0; t0 < L; t0 += SYM_TILE) {
        const int tl = min(SYM_TILE, L - t0);
        spec_scan::stage_symbols(s_sym, chunks_b, rows, L, t0, tl);
        __syncthreads();
        spec_scan::scan_tile<TABLE_IN_SMEM>(carry, n_lanes, width, s_sym, tl,
                                            s_table, table, n_cls);
        __syncthreads();
    }
    for (int i = tid; i < n_lanes; i += blockDim.x) {
        const int c = i / width;
        out[(size_t)(c0 + c) * S + s0 + i - c * width] = carry[i] / n_cls;
    }
}

int spec_match_impl(const int* table, const int* chunks, const int* init,
                    int* out, int C, int L, int Q, int n_cls, int S,
                    int c_blk, int s_blk, int table_in_smem, void* stream) {
    const int lanes = c_blk * s_blk;
    int threads = ((lanes + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    size_t smem = (size_t)(c_blk * SYM_TILE + lanes) * sizeof(int);
    if (table_in_smem) smem += (size_t)Q * n_cls * sizeof(int);
    const dim3 grid((C + c_blk - 1) / c_blk, (S + s_blk - 1) / s_blk);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (table_in_smem) {
        auto kern = spec_match<true>;
        spec_scan::allow_smem(kern, smem);
        kern<<<grid, threads, smem, s>>>(table, chunks, init, out, C, L, Q,
                                         n_cls, S, c_blk, s_blk);
    } else {
        auto kern = spec_match<false>;
        spec_scan::allow_smem(kern, smem);
        kern<<<grid, threads, smem, s>>>(table, chunks, init, out, C, L, Q,
                                         n_cls, S, c_blk, s_blk);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int spec_match_merge_launch(
        const int* table, const int* chunks, const int* init,
        const int* lookahead, const int* cand_index, const int* sinks,
        const int* absorbing, int* out, int* skipped, int* scratch,
        int B, int C, int L, int Q, int n_cls_pad, int K, int S, int pad_key,
        int l_blk, int early_exit, int table_in_smem, int carry_in_smem,
        void* stream) {
    return launch<false>(table, chunks, init, lookahead, cand_index, sinks,
                         absorbing, out, skipped, scratch, B, C, L, Q,
                         n_cls_pad, K, S, pad_key, l_blk, early_exit,
                         table_in_smem, carry_in_smem, stream);
}

int spec_match_merge_lanes_launch(
        const int* table, const int* chunks, const int* init,
        const int* lookahead, const int* cand_index, const int* sinks,
        const int* absorbing, int* out, int* skipped, int* scratch,
        int B, int C, int L, int Q, int n_cls_pad, int K, int S, int pad_key,
        int l_blk, int early_exit, int table_in_smem, int carry_in_smem,
        void* stream) {
    return launch<true>(table, chunks, init, lookahead, cand_index, sinks,
                        absorbing, out, skipped, scratch, B, C, L, Q,
                        n_cls_pad, K, S, pad_key, l_blk, early_exit,
                        table_in_smem, carry_in_smem, stream);
}

int spec_match_launch(const int* table, const int* chunks, const int* init,
                      int* out, int C, int L, int Q, int n_cls, int S,
                      int c_blk, int s_blk, int table_in_smem, void* stream) {
    return spec_match_impl(table, chunks, init, out, C, L, Q, n_cls, S,
                           c_blk, s_blk, table_in_smem, stream);
}

}  // extern "C"
