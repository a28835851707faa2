// The symbol scan shared by the speculative match kernels of dfa_match.cu
// (B1, B2 and B6): lanes hold pre-scaled states (state * n_cls_pad), so a
// step is idx = lane + class and one dependent table load.
//
//   * the table is read from shared memory (pre-scaled when it was staged)
//     or, when it does not fit there, through the read-only path from global
//     memory (unscaled, so the step multiplies);
//   * symbols are staged through shared memory one tile of SYM_TILE at a
//     time, one row per chunk; every lane of a chunk reads the same symbol
//     (a broadcast);
//   * each thread advances up to LANES_PER_PASS independent lanes together,
//     so several loads are in flight per thread, and loops over further
//     lanes when there are more than LANES_PER_PASS * blockDim.x.

#pragma once

#include <cuda_runtime.h>

namespace spec_scan {

constexpr int SYM_TILE = 64;        // symbols staged per shared-memory tile
constexpr int LANES_PER_PASS = 4;   // independent lanes one thread advances

template <bool TABLE_IN_SMEM>
__device__ __forceinline__ int step(const int* __restrict__ s_table,
                                    const int* __restrict__ g_table,
                                    int idx, int n_cls_pad) {
    if (TABLE_IN_SMEM) return s_table[idx];
    return __ldg(g_table + idx) * n_cls_pad;
}

// Stage symbols [t0, t0 + tl) of `rows` rows of `src` (row stride L) into
// s_sym, one row of SYM_TILE per source row.
__device__ __forceinline__ void stage_symbols(int* __restrict__ s_sym,
                                              const int* __restrict__ src,
                                              int rows, int L, int t0,
                                              int tl) {
    for (int i = threadIdx.x; i < rows * tl; i += blockDim.x) {
        const int c = i / tl, t = i - c * tl;
        s_sym[c * SYM_TILE + t] = src[(size_t)c * L + t0 + t];
    }
}

// Advance every lane of `carry` (pre-scaled states) through one staged tile
// of tl symbols; lane i reads symbol row i / lanes_per_row.
template <bool TABLE_IN_SMEM>
__device__ __forceinline__ void scan_tile(int* __restrict__ carry,
                                          int n_lanes, int lanes_per_row,
                                          const int* __restrict__ s_sym,
                                          int tl,
                                          const int* __restrict__ s_table,
                                          const int* __restrict__ g_table,
                                          int n_cls_pad) {
    const int nthreads = blockDim.x;
    for (int base = threadIdx.x; base < n_lanes;
         base += LANES_PER_PASS * nthreads) {
        int st[LANES_PER_PASS];
        const int* row[LANES_PER_PASS];
#pragma unroll
        for (int u = 0; u < LANES_PER_PASS; ++u) {
            const int lane = base + u * nthreads;
            const bool ok = lane < n_lanes;
            st[u] = ok ? carry[lane] : 0;
            row[u] = s_sym + (ok ? lane / lanes_per_row : 0) * SYM_TILE;
        }
        for (int t = 0; t < tl; ++t) {
#pragma unroll
            for (int u = 0; u < LANES_PER_PASS; ++u)
                st[u] = step<TABLE_IN_SMEM>(s_table, g_table,
                                            st[u] + row[u][t], n_cls_pad);
        }
#pragma unroll
        for (int u = 0; u < LANES_PER_PASS; ++u) {
            const int lane = base + u * nthreads;
            if (lane < n_lanes) carry[lane] = st[u];
        }
    }
}

// Let a kernel use more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline void allow_smem(Kernel kern, size_t smem) {
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
}

}  // namespace spec_scan
