// Fused flash-attention forward (causal or sliding window, GQA) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   B9  repro/kernels/flash_attn.py::flash_attn_kernel
//
// What it computes, for q [BH, T, D] and k, v [BH / group, S, D] bfloat16
// (head h reads kv head h / group): out = softmax(mask(q k^T * D^-1/2)) v,
// with the mask k_pos <= q_pos (causal) and k_pos > q_pos - window
// (window > 0), through the online-softmax recurrence of the Pallas kernel:
//     m_new = max(m, rowmax(logit));  alpha = exp(m - m_new)
//     p     = bf16(exp(logit - m_new))
//     l     = l * alpha + rowsum(p);  acc = acc * alpha + p v
//     out   = bf16(acc / max(l, 1e-30))
// with m, l and acc in float32, masked logits at -1e30, and l summing the
// bf16-rounded p, as the Pallas kernel does.
//
// Layout: one CTA of four warps per (64-row q block, head).  Each warp owns
// 16 q rows and keeps their Q fragments, the running m and l and the
// [16, D] accumulator in registers for the whole kv loop.  K and V tiles of
// 64 rows are staged in shared memory (V transposed, so both products read
// their B operand as two consecutive bf16 values); both products are
// tensor-core mma.sync m16n8k16 bf16 with float32 accumulate, and the P
// fragments of the second product are the float accumulators of the first,
// rounded to bf16 in registers.  A kv tile that the causal or window mask
// kills for every row of the q block is skipped; live tiles are masked in
// the tile.  Rows past T and kv positions past S are masked in the kernel,
// so any T and S work without padding.  q blocks are issued last-first, so
// the longest causal rows start first.
//
// Bound on an H100 SXM: 4*BH*T*S*D flops (halved for causal) at 989.4
// TFLOP/s dense bf16, against Q, K, V and O moved once at 3.35 TB/s.  At
// the tinyllama prefill shape (BH = 128, T = S = 2048, D = 64, causal)
// that is 69.5 us of tensor-core work against 40 us of bytes, so the
// products bind.  This first kernel issues the smaller mma.sync tiles with
// no copy/compute overlap; wgmma, TMA and warp specialisation come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // q rows per CTA (16 per warp)
constexpr int kBlockK = 64;        // kv rows per tile
constexpr int kWarps = 4;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attn_fwd(const __nv_bfloat16* __restrict__ q,   // [BH, T, D]
               const __nv_bfloat16* __restrict__ k,   // [BH / group, S, D]
               const __nv_bfloat16* __restrict__ v,   // [BH / group, S, D]
               __nv_bfloat16* __restrict__ o,         // [BH, T, D]
               int T, int S, int group, int causal, int window, float scale) {
    constexpr int KS = D + 8;          // padded smem row strides (bf16)
    constexpr int VS = kBlockK + 8;
    constexpr int NT = kBlockK / 8;    // n-tiles of the score tile
    constexpr int DT = D / 8;          // n-tiles of the output
    constexpr int KD = D / 16;         // k-steps of q k^T
    __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * KS];
    __shared__ __align__(16) __nv_bfloat16 vt[D * VS];

    const int bh = blockIdx.y;
    const int qb = gridDim.x - 1 - blockIdx.x;
    const int q_lo = qb * kBlockQ;
    const int q_hi = q_lo + kBlockQ - 1;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = q_lo + warp * 16 + g, r1 = r0 + 8;   // this thread's rows
    const size_t kv_off = (size_t)(bh / group) * S * D;
    const __nv_bfloat16* kb = k + kv_off;
    const __nv_bfloat16* vb = v + kv_off;

    // Q fragments (A operand, row-major 16 x 16 per k-step)
    uint32_t qa[KD][4];
    {
        const __nv_bfloat16* q0 = q + ((size_t)bh * T + r0) * D;
        const __nv_bfloat16* q1 = q + ((size_t)bh * T + r1) * D;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            const int c = kk * 16 + tg * 2;
            qa[kk][0] = r0 < T ? ld32(q0 + c) : 0u;
            qa[kk][1] = r1 < T ? ld32(q1 + c) : 0u;
            qa[kk][2] = r0 < T ? ld32(q0 + c + 8) : 0u;
            qa[kk][3] = r1 < T ? ld32(q1 + c + 8) : 0u;
        }
    }
    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

    const int n_tiles = (S + kBlockK - 1) / kBlockK;
    for (int j = 0; j < n_tiles; ++j) {
        const int k_lo = j * kBlockK;
        if (causal && k_lo > q_hi) break;               // all in the future
        if (window > 0 && k_lo + kBlockK - 1 <= q_lo - window) continue;

        __syncthreads();                                 // tiles free again
        for (int idx = tid; idx < kBlockK * DT; idx += kWarps * 32) {
            const int row = idx / DT, c8 = (idx % DT) * 8;
            uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
            if (k_lo + row < S) {
                kx = __ldg(reinterpret_cast<const uint4*>(
                    kb + (size_t)(k_lo + row) * D + c8));
                vx = __ldg(reinterpret_cast<const uint4*>(
                    vb + (size_t)(k_lo + row) * D + c8));
            }
            *reinterpret_cast<uint4*>(ks + row * KS + c8) = kx;
            const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
            for (int e = 0; e < 8; ++e) vt[(c8 + e) * VS + row] = ve[e];
        }
        __syncthreads();

        // scores: s[n] holds rows (r0, r0, r1, r1) x cols (c, c + 1, c, c + 1)
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            const __nv_bfloat16* krow = ks + (n * 8 + g) * KS + tg * 2;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
                mma_bf16(s[n], qa[kk], ld32(krow + kk * 16),
                         ld32(krow + kk * 16 + 8));
        }
        float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kp = k_lo + n * 8 + tg * 2 + (e & 1);
                const int qp = e < 2 ? r0 : r1;
                bool ok = kp < S;
                if (causal) ok = ok && kp <= qp;
                if (window > 0) ok = ok && kp > qp - window;
                s[n][e] = ok ? s[n][e] * scale : kNeg;
            }
            mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
            mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
        uint32_t pa[NT / 2][4];                          // P as A fragments
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const __nv_bfloat162 p01 = __floats2bfloat162_rn(
                expf(s[n][0] - mn0), expf(s[n][1] - mn0));
            const __nv_bfloat162 p23 = __floats2bfloat162_rn(
                expf(s[n][2] - mn1), expf(s[n][3] - mn1));
            sum0 += __low2float(p01) + __high2float(p01);
            sum1 += __low2float(p23) + __high2float(p23);
            pa[n / 2][(n & 1) * 2 + 0] = *reinterpret_cast<const uint32_t*>(&p01);
            pa[n / 2][(n & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&p23);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
            sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
        }
        l0 = l0 * al0 + sum0;
        l1 = l1 * al1 + sum1;
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
            acc[dn][0] *= al0;
            acc[dn][1] *= al0;
            acc[dn][2] *= al1;
            acc[dn][3] *= al1;
            const __nv_bfloat16* vrow = vt + (dn * 8 + g) * VS + tg * 2;
#pragma unroll
            for (int kk = 0; kk < NT / 2; ++kk)
                mma_bf16(acc[dn], pa[kk], ld32(vrow + kk * 16),
                         ld32(vrow + kk * 16 + 8));
        }
    }

    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* o0 = o + ((size_t)bh * T + r0) * D;
    __nv_bfloat16* o1 = o + ((size_t)bh * T + r1) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
        const int c = dn * 8 + tg * 2;
        if (r0 < T)
            *reinterpret_cast<uint32_t*>(o0 + c) =
                pack_bf16(acc[dn][0] / d0, acc[dn][1] / d0);
        if (r1 < T)
            *reinterpret_cast<uint32_t*>(o1 + c) =
                pack_bf16(acc[dn][2] / d1, acc[dn][3] / d1);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T, int S, int group, int causal, int window, float scale,
           cudaStream_t s) {
    const dim3 grid((T + kBlockQ - 1) / kBlockQ, BH);
    flash_attn_fwd<D><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        T, S, group, causal, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                      int BH, int T, int S, int D, int group, int causal,
                      int window, float scale, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return launch<16>(q, k, v, o, BH, T, S, group, causal,
                                   window, scale, s);
        case 32: return launch<32>(q, k, v, o, BH, T, S, group, causal,
                                   window, scale, s);
        case 64: return launch<64>(q, k, v, o, BH, T, S, group, causal,
                                   window, scale, s);
        case 128: return launch<128>(q, k, v, o, BH, T, S, group, causal,
                                     window, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
