// Speculative chunk scan + in-CTA Eq. 8 fold for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   B1  repro/kernels/dfa_match.py::spec_match_merge_kernel       (LANES=false)
//   B2  repro/kernels/dfa_match.py::spec_match_merge_lanes_kernel (LANES=true)
// both with their shared symbol-block body `_scan_block_with_exit`.
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
// gathers conflict in the shared-memory banks.  The design keeps the chains
// short in latency and many:
//   * the pre-scaled table sits in shared memory when it fits (29 KiB for
//     PCRE-14), so every step is one shared-memory load; a larger table is
//     read through the read-only path (TABLE_IN_SMEM=false);
//   * symbols are staged through shared memory one tile at a time; every
//     lane of a chunk reads the same symbol (a broadcast);
//   * each thread advances up to LANES_PER_PASS independent lanes together,
//     so several loads are in flight per thread;
//   * the lane carry lives in shared memory between tiles when it fits,
//     else in a global scratch row of the document.
// Left for later: classifying bytes in the kernel (uint8 input), several
// documents per CTA, and more CTAs than one batch tile's 64 (64 CTAs leave
// most of the 132 SMs idle).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SYM_TILE = 64;        // symbols staged per shared-memory tile
constexpr int LANES_PER_PASS = 4;   // independent lanes one thread advances

template <bool TABLE_IN_SMEM>
__device__ __forceinline__ int step(const int* __restrict__ s_table,
                                    const int* __restrict__ g_table,
                                    int idx, int n_cls_pad) {
    if (TABLE_IN_SMEM) return s_table[idx];
    return __ldg(g_table + idx) * n_cls_pad;
}

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
            for (int i = tid; i < C * tl; i += nthreads) {
                const int c = i / tl, t = i - c * tl;
                s_sym[c * SYM_TILE + t] = chunks_b[(size_t)c * L + t0 + t];
            }
            __syncthreads();
            for (int base = tid; base < n_lanes;
                 base += LANES_PER_PASS * nthreads) {
                int st[LANES_PER_PASS];
                const int* row[LANES_PER_PASS];
#pragma unroll
                for (int u = 0; u < LANES_PER_PASS; ++u) {
                    const int lane = base + u * nthreads;
                    const bool ok = lane < n_lanes;
                    st[u] = ok ? carry[lane] : 0;
                    row[u] = s_sym + (ok ? lane / ks : 0) * SYM_TILE;
                }
                for (int t = 0; t < tl; ++t) {
#pragma unroll
                    for (int u = 0; u < LANES_PER_PASS; ++u)
                        st[u] = step<TABLE_IN_SMEM>(s_table, table,
                                                    st[u] + row[u][t],
                                                    n_cls_pad);
                }
#pragma unroll
                for (int u = 0; u < LANES_PER_PASS; ++u) {
                    const int lane = base + u * nthreads;
                    if (lane < n_lanes) carry[lane] = st[u];
                }
            }
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
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        kern<<<B, threads, smem, s>>>(table, chunks, init, lookahead,
                                      cand_index, sinks, absorbing, out,
                                      skipped, scratch, C, L, Q, n_cls_pad,
                                      K, S, pad_key, l_blk, early_exit,
                                      carry_in_smem);
    } else {
        auto kern = spec_match_merge<LANES, false>;
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        kern<<<B, threads, smem, s>>>(table, chunks, init, lookahead,
                                      cand_index, sinks, absorbing, out,
                                      skipped, scratch, C, L, Q, n_cls_pad,
                                      K, S, pad_key, l_blk, early_exit,
                                      carry_in_smem);
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

}  // extern "C"
