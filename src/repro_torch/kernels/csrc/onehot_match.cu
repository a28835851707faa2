// One-hot matrix-product block maps for Hopper (sm_90a), on tensor cores.
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
// Layout: one CTA per (chunk, block), Q padded to QP = 16 * KT.  Warp w
// owns rows [16w, 16w + 16) of the [QP, QP] accumulator, which sits in
// shared memory as bf16 (QP * (QP + 8) * 2 bytes: 132 KiB at QP = 256).
// Rows never mix (row q is the one-hot vector of q's current state), so
// warps run their symbols independently, with no block-wide barrier after
// the table and symbols are staged.  Per symbol a warp loads its 16 rows as
// mma.sync m16n8k16 A fragments, multiplies them by P_c on the tensor cores
// (float32 accumulate) and writes the rounded product back in place.  P_c
// is never materialised: its B fragments come from the table column,
// staged once as bytes and permuted so that one 32-bit load gives a
// thread the four states its fragments need; a byte compare against the
// output column builds the 0/1 bf16 pairs.  Padding rows k >= Q of P_c hold
// 0xFF and carry no weight: a real row's 1 never sits in a padding column.
//
// Bound on an H100 SXM: 2 * QP^3 flops per symbol at 989.4 TFLOP/s dense
// bf16 (at QP = 256 and 1 MiB of symbols, 35 ms), against the symbols and
// maps moved once at 3.35 TB/s: the products bind.  This first kernel uses
// the smaller mma.sync tiles, rebuilds the B fragments with integer
// compares per product, and stores every product to shared memory; wgmma
// and keeping the accumulator in registers come later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kOnes = 0x3F803F80u;   // two bf16 1.0 values

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    // the values are exactly 0 or 1: truncating float32 to bf16 is exact
    return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

template <int KT>
__global__ void __launch_bounds__(KT * 32)
onehot_block_maps(const int* __restrict__ table,  // [Q, n_cls]
                  const int* __restrict__ syms,   // [C, nb * l_blk]
                  int* __restrict__ out,          // [C, nb, Q]
                  int Q, int n_cls, int nb, int l_blk) {
    constexpr int QP = KT * 16;
    constexpr int AS = QP / 2 + 4;     // accumulator row stride, bf16 pairs
    extern __shared__ uint32_t smem[];
    uint32_t* acc = smem;                              // [QP, AS]
    uint32_t* tcol = acc + QP * AS;                    // [n_cls, QP / 4]
    int* s_sym = reinterpret_cast<int*>(tcol + n_cls * QP / 4);  // [l_blk]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;
    const size_t blk = blockIdx.x;                     // chunk * nb + block

    // table column bytes, permuted: byte e of word (c, kt * 4 + tg) is
    // table[k, c] for k = kt*16 + tg*2 + (e & 1) + (e & 2) * 4
    uint8_t* tb = reinterpret_cast<uint8_t*>(tcol);
    for (int i = tid; i < n_cls * QP; i += blockDim.x) {
        const int c = i / QP, k = i - c * QP;
        const int r = k & 15, e = (r & 1) + (r >> 3) * 2;
        tb[c * QP + (k >> 4) * 16 + ((r & 7) >> 1) * 4 + e] =
            k < Q ? (uint8_t)table[k * n_cls + c] : (uint8_t)0xFF;
    }
    const int* sym_b = syms + blk * l_blk;
    for (int t = tid; t < l_blk; t += blockDim.x) s_sym[t] = sym_b[t];
    // the identity map, each warp its own rows
    for (int i = lane; i < 16 * AS; i += 32) {
        const int r = warp * 16 + i / AS, w = i % AS;
        acc[r * AS + w] = (2 * w == r ? 0x3F80u : 0u) |
                          (2 * w + 1 == r ? 0x3F800000u : 0u);
    }
    __syncthreads();

    uint32_t* row0 = acc + (warp * 16 + g) * AS;
    uint32_t* row1 = row0 + 8 * AS;
    for (int t = 0; t < l_blk; ++t) {
        const uint32_t* col = tcol + s_sym[t] * (QP / 4) + tg;
        uint32_t a[KT][4];
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
            a[kt][0] = row0[kt * 8 + tg];
            a[kt][1] = row1[kt * 8 + tg];
            a[kt][2] = row0[kt * 8 + 4 + tg];
            a[kt][3] = row1[kt * 8 + 4 + tg];
        }
        __syncwarp();
        for (int j = 0; j < KT; ++j) {        // output columns 16j .. 16j+15
            float ce[4] = {0.f, 0.f, 0.f, 0.f}, co[4] = {0.f, 0.f, 0.f, 0.f};
            const uint32_t ne = (uint32_t)(16 * j + g) * 0x01010101u;
            const uint32_t no = ne + 8u * 0x01010101u;
#pragma unroll
            for (int kt = 0; kt < KT; ++kt) {
                const uint32_t w = col[kt * 4];
                const uint32_t me = __vcmpeq4(w, ne), mo = __vcmpeq4(w, no);
                mma_bf16(ce, a[kt], __byte_perm(me, 0, 0x1100) & kOnes,
                         __byte_perm(me, 0, 0x3322) & kOnes);
                mma_bf16(co, a[kt], __byte_perm(mo, 0, 0x1100) & kOnes,
                         __byte_perm(mo, 0, 0x3322) & kOnes);
            }
            row0[j * 8 + tg] = pack_bf16(ce[0], ce[1]);
            row1[j * 8 + tg] = pack_bf16(ce[2], ce[3]);
            row0[j * 8 + 4 + tg] = pack_bf16(co[0], co[1]);
            row1[j * 8 + 4 + tg] = pack_bf16(co[2], co[3]);
        }
        __syncwarp();
    }

    // argmax of each real row: the column of its one nonzero entry
    if (lane < 16) {
        const int r = warp * 16 + lane;
        if (r < Q) {
            const uint32_t* row = acc + r * AS;
            int best = 0;
            for (int w = QP / 2 - 1; w >= 0; --w) {
                const uint32_t v = row[w];
                if (v & 0xFFFFu) best = 2 * w;
                else if (v) best = 2 * w + 1;
            }
            out[blk * Q + r] = best;
        }
    }
}

template <int KT>
int launch(const int* table, const int* syms, int* out, int rows, int Q,
           int n_cls, int nb, int l_blk, cudaStream_t s) {
    constexpr int QP = KT * 16;
    const size_t smem = (size_t)QP * (QP / 2 + 4) * 4 + (size_t)n_cls * QP +
                        (size_t)l_blk * 4;
    auto kern = onehot_block_maps<KT>;
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    kern<<<rows, KT * 32, smem, s>>>(table, syms, out, Q, n_cls, nb, l_blk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows = C * nb blocks; Q <= 256
int onehot_block_maps_launch(const int* table, const int* syms, int* out,
                             int rows, int Q, int n_cls, int nb, int l_blk,
                             void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    switch ((Q + 15) / 16) {
#define ONEHOT_CASE(kt) \
        case kt: return launch<kt>(table, syms, out, rows, Q, n_cls, nb, \
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
