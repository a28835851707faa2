// The speculative scan shared by the match kernels of dfa_match.cu (B1, B2
// and B6), designed for Hopper (sm_90a):
//
//   * lanes live in registers for the whole scan: each consumer thread
//     carries LPT independent lanes of ONE chunk, so one symbol read feeds
//     LPT dependent chains;
//   * symbols arrive through a ring of STAGES tiles in shared memory, one
//     row of `tile` symbols per chunk, filled by a producer warp (bulk
//     copies that complete on the stage's mbarrier, or plain loads where a
//     row is not 16-byte aligned); consumers wait only on the stage's
//     barrier parity and give the stage back with one arrival per warp --
//     no __syncthreads inside the scan;
//   * a consumer reads its row 4 symbols at a time (one 16-byte shared
//     load) for GROUP symbols, fully unrolled, and turns each class into
//     its column's address (an IMAD off the dependent chain);
//   * the table sits in shared memory class-major, s_tab[class * Q_pad +
//     state], entries pre-scaled to byte offsets, Q_pad odd: the lanes of
//     one chunk gather from distinct banks whatever n_cls is, and a step
//     is one add and one dependent shared load.  A table that does not fit
//     is read row-major from global memory through the read-only path
//     (state * n_cls + class: a multiply-add and a load per step).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace spec_scan {

constexpr int LPT = 4;             // lanes one consumer thread carries
constexpr int STAGES = 4;          // symbol tiles in the ring
constexpr int GROUP = 32;          // symbols per fully unrolled step group
constexpr int MAX_CONSUMERS = 992; // consumer threads of a CTA (+1 producer
                                   // warp = 1024)
constexpr int CONSUMER_BAR = 1;    // named barrier of the consumer threads

// A lane is a byte offset (state * 4) into the class-major shared table.
struct SmemTable {
    uint32_t base;   // shared address of class column 0
    uint32_t col;    // bytes per class column (Q_pad * 4)
    __device__ __forceinline__ uint32_t prep(uint32_t cls) const {
        return base + cls * col;
    }
    __device__ __forceinline__ uint32_t step(uint32_t lane, uint32_t p) const {
        return sm90::lds(p + lane);
    }
    __device__ __forceinline__ int state(uint32_t lane) const {
        return (int)(lane >> 2);
    }
    __device__ __forceinline__ uint32_t lane(int st) const {
        return (uint32_t)st << 2;
    }
};

// A lane is a state; the row-major [Q, n_cls] table stays in global memory.
struct GlobalTable {
    const int* table;
    uint32_t n_cls;
    __device__ __forceinline__ uint32_t prep(uint32_t cls) const { return cls; }
    __device__ __forceinline__ uint32_t step(uint32_t lane, uint32_t p) const {
        return (uint32_t)__ldg(table + (lane * n_cls + p));
    }
    __device__ __forceinline__ int state(uint32_t lane) const {
        return (int)lane;
    }
    __device__ __forceinline__ uint32_t lane(int st) const {
        return (uint32_t)st;
    }
};

template <int N, class Tab>
__device__ __forceinline__ void step_all(uint32_t (&ln)[N], const Tab& tab,
                                         uint32_t p) {
#pragma unroll
    for (int u = 0; u < N; ++u) ln[u] = tab.step(ln[u], p);
}

// Advance the N lanes through `tl` symbols of one ring row (shared
// address `row`, 16-byte aligned): GROUP-symbol groups fully unrolled, the
// tail one symbol at a time.
template <int N, class Tab>
__device__ __forceinline__ void scan_row(uint32_t (&ln)[N], uint32_t row,
                                         int tl, const Tab& tab) {
    const int full = tl - tl % GROUP;
#pragma unroll 1
    for (int t = 0; t < full; t += GROUP) {
        uint4 v[GROUP / 4];
#pragma unroll
        for (int q = 0; q < GROUP / 4; ++q)
            v[q] = sm90::lds4(row + (uint32_t)(t + 4 * q) * 4);
#pragma unroll
        for (int q = 0; q < GROUP / 4; ++q) {
            const uint32_t p0 = tab.prep(v[q].x), p1 = tab.prep(v[q].y);
            const uint32_t p2 = tab.prep(v[q].z), p3 = tab.prep(v[q].w);
            step_all(ln, tab, p0);
            step_all(ln, tab, p1);
            step_all(ln, tab, p2);
            step_all(ln, tab, p3);
        }
    }
#pragma unroll 1
    for (int t = full; t < tl; ++t)
        step_all(ln, tab, tab.prep(sm90::lds(row + (uint32_t)t * 4)));
}

}  // namespace spec_scan
