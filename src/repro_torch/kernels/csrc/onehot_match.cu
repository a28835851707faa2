// One-hot matrix-product block maps for Hopper (sm_90a), on warpgroup
// products with the accumulator in registers.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   B8  repro/kernels/onehot_match.py::onehot_match_kernel
//
// What it computes, for symbols [C, L] (L = nb * l_blk) and a table
// [Q, n_cls] with Q <= 256: per (chunk, symbol block) the map
//     M = P_{s_1} P_{s_2} ... P_{s_l_blk},   P_c[k, n] = (table[k, c] == n)
// and out[chunk, block, q] = argmax_n M[q, n] = delta*(q, block).  Every row
// of a product of one-hot matrices holds exactly one 1, so bf16 operands
// with float32 accumulation are exact and the argmax is the one nonzero
// column.
//
// Layout.  Q is padded to QP = 16 * ceil(Q / 16), rows to slabs of 64.
// Rows of M never mix (row q is the one-hot vector of q's current state),
// so the slabs are independent: the grid runs over (chunk * block, group of
// up to two slabs), and each consumer warpgroup owns one slab.  Its
// [64, QP] accumulator stays in float32 registers for the whole block: per
// symbol one wgmma m64nQPk16 per 16 columns of k, with A from registers --
// the previous product rounded to bf16 in place, exact since every entry
// is 0 or 1 (the identity for the first symbol) -- and B = P_c from shared
// memory, K-major with the 128-byte swizzle.  Rows past Q (and past QP
// where QP < 64) start at zero, stay zero and are not written.
//
// P_c is built once per symbol per CTA by a producer warp, into a ring of
// buffers with full/empty mbarriers (lane 0 of each consumer warp frees a
// buffer), overlapping the consumers' products of the previous symbols.
// The ring starts zeroed and a P_c has one 1 per real row k (rows k >= Q
// are zero), so building one is Q two-byte stores of 1.0 and reusing a
// buffer Q stores of 0 where its previous symbol put its ones: the producer
// reads the table column from global memory (L1).  Two full buffers fit for
// QP <= 224 (2 x 112 KiB at QP = 224), up to eight where they are small.
// Above 224 a P_c is ringed in two chunks of k (rows 0..127 and 128..QP-1)
// through three chunk buffers (at QP = 256: 3 x 64 KiB): the consumers
// issue both chunks' products as two commit groups and free the first
// chunk as soon as its group completes, so the next symbol's first chunk
// is built while the second chunk's products run.  From QP = 192 the
// accumulator and A fragments (up to 192 registers) need more than a CTA
// of three warpgroups starts with: the producer is then a whole warpgroup
// that gives its registers to the consumers (setmaxnreg).
//
// The argmax runs from registers: each thread finds the column of the one
// 1 of its fragment of a row, a quad shuffle combines the four fragments.
//
// Bound on an H100 SXM: 2 * QP^3 flops per symbol at 989.4 TFLOP/s dense
// bf16 (at QP = 256, C = 40 and L = 26,368, 35.8 ms), against the symbols
// and maps moved once at 3.35 TB/s: the products bind.  The design issues
// them as the card's widest warpgroup products straight from the register
// accumulator, with two consumer warpgroups per CTA to cover each other's
// waits and conversions.  Each symbol's product waits on the previous one,
// so at small QP (one m64nQPk16 per symbol) the chain's latency, not the
// tensor cores, sets the time.  Built from inline PTX (sm90.cuh, and
// wgmma.cuh written by gen_wgmma.py), no CUTLASS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSmemBudget = 232448;      // dynamic shared memory per block
constexpr uint16_t kOne = 0x3F80;        // bf16 1.0

template <int QP>
struct Cfg {
    static constexpr int kSlabs = (QP + 63) / 64;
    static constexpr int kConsumers = kSlabs >= 2 ? 2 : 1;
    static constexpr int kRegion = QP * 128;        // 64 k-columns, QP rows
    static constexpr int kFullBuf = kSlabs * kRegion;
    static constexpr bool kSplit =
        2 * kFullBuf + 1024 + 64 > kSmemBudget;     // two full P_c don't fit
    static constexpr int kChunks = kSplit ? 2 : 1;
    // a deeper ring where P_c is small: up to 8 stages within 64 KiB
    static constexpr int kStages = kSplit ? 3
        : 65536 / kFullBuf >= 8 ? 8 : 65536 / kFullBuf >= 2
        ? 65536 / kFullBuf : 2;
    // from QP = 192 a consumer's accumulator and A fragments need more
    // than the 168 registers a CTA of two consumer warpgroups and a
    // producer starts with: the producer is then a whole warpgroup (one
    // warp of it works) that gives its registers to the consumers
    // (setmaxnreg), as a lone producer warp has none to give
    static constexpr bool kRebalance = QP >= 192;
    static constexpr int kThreads = kConsumers * 128 + (kRebalance ? 128 : 32);
    static constexpr int kChunkK = kSplit ? 128 : QP;   // k rows of chunk 0
    static constexpr int kBuf = kSplit ? 2 * kRegion : kFullBuf;
    static constexpr int kSmem = kStages * kBuf + 2 * kStages * 8;
    // k-steps of chunk h, and its first global k-step
    __host__ __device__ static constexpr int steps(int h) {
        return kSplit ? (h == 0 ? 8 : (QP - 128) / 16) : QP / 16;
    }
    __host__ __device__ static constexpr int first_step(int h) {
        return h == 0 ? 0 : 8;
    }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    // the values are exactly 0 or 1: truncating float32 to bf16 is exact
    return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t ident(int r, int c, int Q) {
    return r < Q ? (r == c ? 0x3F80u : 0u) | (r == c + 1 ? 0x3F800000u : 0u)
                 : 0u;
}

// one chunk of P_c: value v at (n = table[k, c], k) for its rows k < Q
template <int QP>
__device__ __forceinline__ void put_chunk(uint8_t* buf,
                                          const int* __restrict__ table,
                                          int Q, int n_cls, int c, int h,
                                          uint16_t v, int lane) {
    using C = Cfg<QP>;
    const int k0 = h * C::kChunkK;
    const int k1 = min(Q, h == 0 ? C::kChunkK : QP);
    for (int k = k0 + lane; k < k1; k += 32) {
        const int n = __ldg(table + (size_t)k * n_cls + c);
        const int kl = k - k0;
        *reinterpret_cast<uint16_t*>(
            buf + (kl / 64) * C::kRegion + sm90::swizzled<128>(n, kl % 64)) = v;
    }
}

template <int QP>
__global__ void __launch_bounds__(Cfg<QP>::kThreads, 1)
onehot_block_maps(const int* __restrict__ table,  // [Q, n_cls]
                  const int* __restrict__ syms,   // [C, nb * l_blk]
                  int* __restrict__ out,          // [C, nb, Q]
                  int Q, int n_cls, int l_blk) {
    using C = Cfg<QP>;
    constexpr int KT = QP / 16;                   // k-steps of one product
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023))
                                & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages * C::kBuf);
    uint64_t* empty = full + C::kStages;

    const size_t blk = blockIdx.x;                 // chunk * nb + block
    const int slab0 = blockIdx.y * C::kConsumers;
    const int active = min(C::kConsumers, C::kSlabs - slab0);
    const int* sym_b = syms + blk * l_blk;

    for (int i = threadIdx.x; i < C::kStages * C::kBuf / 16; i += blockDim.x)
        reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    sm90::fence_async_smem();
    if (threadIdx.x == 0) {
        for (int s = 0; s < C::kStages; ++s) {
            sm90::mbar_init(&full[s], 32);
            sm90::mbar_init(&empty[s], active * 4);   // consumer warps
        }
        sm90::mbar_init_fence();
    }
    __syncthreads();

    // the role, warp-uniform for the compiler (a shuffle of lane 0's)
    const int grp = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (grp == C::kConsumers) {
        // ---- producer warp: P_c of every symbol into the ring --------------
        if constexpr (C::kRebalance) sm90::reg_dealloc<56>();
        if (threadIdx.x >= C::kConsumers * 128 + 32) return;
        const int lane = threadIdx.x % 32;
        for (int i = 0; i < l_blk * C::kChunks; ++i) {
            const int st = i % C::kStages;
            uint8_t* buf = ring + st * C::kBuf;
            sm90::mbar_wait(&empty[st], ((i / C::kStages) & 1) ^ 1);
            if (i >= C::kStages) {
                const int ip = i - C::kStages;
                put_chunk<QP>(buf, table, Q, n_cls,
                              __ldg(sym_b + ip / C::kChunks),
                              ip % C::kChunks, 0, lane);
            }
            put_chunk<QP>(buf, table, Q, n_cls, __ldg(sym_b + i / C::kChunks),
                          i % C::kChunks, kOne, lane);
            sm90::fence_async_smem();
            sm90::mbar_arrive(&full[st]);
        }
    } else {
        // ---- consumers: one 64-row slab each, accumulator in registers ----
        if constexpr (C::kRebalance) sm90::reg_alloc<224>();
        if (grp >= active) return;
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        const int g = lane / 4, tg = lane % 4;
        const int r0 = (slab0 + grp) * 64 + warp * 16 + g, r1 = r0 + 8;

        uint32_t a[KT][4];                         // A: the map so far, bf16
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
            const int c0 = kk * 16 + tg * 2;
            a[kk][0] = ident(r0, c0, Q);
            a[kk][1] = ident(r1, c0, Q);
            a[kk][2] = ident(r0, c0 + 8, Q);
            a[kk][3] = ident(r1, c0 + 8, Q);
        }
        float d[QP / 2];
#pragma unroll
        for (int i = 0; i < QP / 2; ++i) d[i] = 0.f;

        for (int t = 0; t < l_blk; ++t) {
            const int i0 = t * C::kChunks;
            wg::wgmma_fence();
#pragma unroll
            for (int h = 0; h < C::kChunks; ++h) {
                const int st = (i0 + h) % C::kStages;
                sm90::mbar_wait(&full[st], ((i0 + h) / C::kStages) & 1);
                const uint8_t* buf = ring + st * C::kBuf;
#pragma unroll
                for (int s = 0; s < C::steps(h); ++s) {
                    const int kk = C::first_step(h) + s;
                    const uint64_t db = sm90::desc<128>(
                        buf + (s / 4) * C::kRegion + (s % 4) * 32, 16, 1024);
                    wg::WgmmaRS<QP>::template mma<0>(
                        d, a[kk][0], a[kk][1], a[kk][2], a[kk][3], db, kk > 0);
                }
                wg::wgmma_commit();
            }
            if constexpr (C::kChunks == 2) {
                wg::wgmma_wait<1>();
                if (lane == 0) sm90::mbar_arrive(&empty[i0 % C::kStages]);
                wg::wgmma_wait<0>();
                if (lane == 0)
                    sm90::mbar_arrive(&empty[(i0 + 1) % C::kStages]);
            } else {
                wg::wgmma_wait<0>();
                if (lane == 0) sm90::mbar_arrive(&empty[i0 % C::kStages]);
            }
            wg::fence_regs(d);
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
                a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
                a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
                a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
            }
        }

        // argmax of each real row: the column of its one nonzero entry
        int b0 = 0, b1 = 0;
#pragma unroll
        for (int n = 0; n < QP / 8; ++n) {
            const int c = n * 8 + tg * 2;
            if (d[4 * n] != 0.f) b0 = c;
            if (d[4 * n + 1] != 0.f) b0 = c + 1;
            if (d[4 * n + 2] != 0.f) b1 = c;
            if (d[4 * n + 3] != 0.f) b1 = c + 1;
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            b0 = max(b0, __shfl_xor_sync(0xffffffffu, b0, off));
            b1 = max(b1, __shfl_xor_sync(0xffffffffu, b1, off));
        }
        if (tg == 0) {
            if (r0 < Q) out[blk * Q + r0] = b0;
            if (r1 < Q) out[blk * Q + r1] = b1;
        }
    }
}

template <int QP>
int launch(const int* table, const int* syms, int* out, int rows, int Q,
           int n_cls, int l_blk, cudaStream_t s) {
    using C = Cfg<QP>;
    const int smem = C::kSmem + 1024;                 // + alignment slack
    auto kern = onehot_block_maps<QP>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(rows, (C::kSlabs + C::kConsumers - 1) / C::kConsumers);
    kern<<<grid, C::kThreads, smem, s>>>(table, syms, out, Q, n_cls, l_blk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows = C * nb blocks; Q <= 256
int onehot_block_maps_launch(const int* table, const int* syms, int* out,
                             int rows, int Q, int n_cls, int nb, int l_blk,
                             void* stream) {
    (void)nb;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    switch ((Q + 15) / 16) {
#define ONEHOT_CASE(kt) \
        case kt: return launch<kt * 16>(table, syms, out, rows, Q, n_cls, \
                                        l_blk, s);
        ONEHOT_CASE(1) ONEHOT_CASE(2) ONEHOT_CASE(3) ONEHOT_CASE(4)
        ONEHOT_CASE(5) ONEHOT_CASE(6) ONEHOT_CASE(7) ONEHOT_CASE(8)
        ONEHOT_CASE(9) ONEHOT_CASE(10) ONEHOT_CASE(11) ONEHOT_CASE(12)
        ONEHOT_CASE(13) ONEHOT_CASE(14) ONEHOT_CASE(15) ONEHOT_CASE(16)
#undef ONEHOT_CASE
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
