// Fused flash-attention forward (causal or sliding window, GQA) for Hopper
// (sm_90a), on warpgroup products, TMA and register-resident accumulators.
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
// bf16-rounded p.  The logits are kept in the log2 domain (the scale folded
// into log2 e, ex2.approx), which is the same recurrence.
//
// Layout: a persistent grid of one CTA of three warpgroups per SM walks the
// work items (128-row q block, head), the longest causal blocks first.
// The third warpgroup is the producer: it gives up registers (setmaxnreg)
// and one thread issues TMA loads (cp.async.bulk.tensor) of each item's Q
// block into one of two Q buffers and of its K and V tiles (128 kv rows)
// into a ring of kStages stages, each with a full and an empty mbarrier,
// so the next item's loads run under this item's tail.  The other two are
// consumers, 64 q rows each, with the registers the producer gave up:
// S = Q K^T by wgmma with both operands in shared memory (K K-major), the
// online softmax on the S accumulator in registers, then O += P V by wgmma
// with P in registers (the S accumulator rounded to bf16 is the m64k16 A
// fragment) and V read MN-major through its descriptor, so V is never
// transposed; the next tile's S is issued in the same stage as this tile's
// P V.  The two consumers take turns to issue (two named barriers), so
// one's softmax runs beside the other's products.  O, m and l live in
// registers for the whole kv loop; lane 0 of each consumer warp frees a
// stage once its products have completed.  Each 128-row tile is two steps
// of the plain version's 64-row recurrence (a running maximum per half,
// the P V product of the first half completed and rescaled before the
// second's), so p rounds against the same maxima as there.
//
// The tensor maps are 3-D, [heads, S, D]: a tile at a ragged S tail is
// zero-filled inside its own head, the kv head of head h is a TMA
// coordinate (GQA unrepeated), and Q rows past T load as zeros and are
// never stored.  Rows are swizzled by their bytes (32, 64 or 128 B; D = 128
// loads two 64-column boxes).  Tiles that the causal or window mask kills
// for the whole q block are never loaded (the producer and the consumers
// walk the same live range); a consumer skips the products of a tile dead
// for all its 64 rows and masks only tiles that cross the diagonal, the
// window edge or the S tail.
//
// Built from inline PTX (sm90.cuh, and wgmma.cuh written by gen_wgmma.py),
// no CUTLASS.  The tensor maps are encoded per call on the host by
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no -lcuda),
// and passed as __grid_constant__ parameters.
//
// Bound on an H100 SXM: 4*BH*T*S*D flops (halved for causal) at 989.4
// TFLOP/s dense bf16, against Q, K, V and O moved once at 3.35 TB/s.  At
// the tinyllama prefill shape (BH = 128, T = S = 2048, D = 64, causal)
// that is 69.5 us of tensor-core work against 40 us of bytes, so the
// products bind on paper.  At D = 64 the exponentials match the products
// (one ex2 per 256 flops, 16 ex2 per SM and clock against 4,096 flops), and
// the softmax's issue slots are what a consumer waits on: this design
// overlaps one consumer's softmax with the other's products, not yet a
// consumer's own (that needs a second S accumulator in registers).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBlockQ = 128;       // q rows per CTA (64 per consumer)
constexpr int kBlockK = 128;       // kv rows per tile
constexpr int kThreads = 384;      // two consumer warpgroups + a producer
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
    static constexpr int kSw = D * 2 < 128 ? D * 2 : 128;   // row bytes
    static constexpr int kParts = D * 2 / kSw;              // boxes per row
    static constexpr int kStepsPerPart = kSw / 32;          // k16 steps
    static constexpr int kStages = D == 128 ? 2 : 3;
    static constexpr int kQBytes = kBlockQ * D * 2;
    static constexpr int kTileBytes = kBlockK * D * 2;
    static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kTileBytes
                                 + (2 * kStages + 4) * 8;
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
    return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
    return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// named barriers of 256 threads: the two consumer warpgroups
__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

template <bool B>
struct Flag {
    static constexpr bool value = B;
};

// S = Q K^T of one tile into s (issued, not committed): q is this
// warpgroup's 64 rows of the Q block, k the tile's K, both K-major
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[kBlockK / 2],
                                        const uint8_t* q, const uint8_t* k) {
    using C = Cfg<D>;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / C::kStepsPerPart;
        const int kb = (kk % C::kStepsPerPart) * 32;
        const uint64_t da = sm90::desc<C::kSw>(q + p * kBlockQ * C::kSw + kb,
                                               16, 8 * C::kSw);
        const uint64_t db = sm90::desc<C::kSw>(k + p * kBlockK * C::kSw + kb,
                                               16, 8 * C::kSw);
        wg::WgmmaSS<kBlockK>::mma(s, da, db, kk > 0);
    }
}

// O += P V for k-step kk (kv rows 16kk .. 16kk + 15) of the tile's V, read
// MN-major: 8-row k groups SBO apart, the 64-column boxes of D = 128 LBO
// apart
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         const uint8_t* v, int kk) {
    using C = Cfg<D>;
    const uint64_t db = sm90::desc<C::kSw>(v + kk * 16 * C::kSw,
                                           kBlockK * C::kSw, 8 * C::kSw);
    wg::WgmmaRS<D>::template mma<1>(acc, a[0], a[1], a[2], a[3], db, 1);
}

template <int R>
__device__ __forceinline__ void rescale(float (&v)[R], float a0, float a1) {
#pragma unroll
    for (int n = 0; n < R / 4; ++n) {
        v[4 * n] *= a0;
        v[4 * n + 1] *= a0;
        v[4 * n + 2] *= a1;
        v[4 * n + 3] *= a1;
    }
}

// the kv tiles [j_lo, j_hi) of 128 rows that rows [lo, hi] of q attend to
__device__ __forceinline__ void live_tiles(int lo, int hi, int S, int causal,
                                           int window, int& j_lo, int& j_hi) {
    const int n_tiles = (S + kBlockK - 1) / kBlockK;
    j_hi = causal ? min(n_tiles, hi / kBlockK + 1) : n_tiles;
    const int k_first = lo - window + 1;
    j_lo = min(j_hi, window > 0 && k_first > 0 ? k_first / kBlockK : 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd(const __grid_constant__ CUtensorMap tq,   // [BH, T, D]
               const __grid_constant__ CUtensorMap tk,   // [BH / group, S, D]
               const __grid_constant__ CUtensorMap tv,   // [BH / group, S, D]
               __nv_bfloat16* __restrict__ o,            // [BH, T, D]
               int BH, int T, int S, int group, int causal, int window,
               float scale_log2) {
    using C = Cfg<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023))
                                & 1023);
    uint8_t* sq = smem;                                  // [2][parts][128][sw]
    uint8_t* sk = sq + 2 * C::kQBytes;                   // [stages][parts]..
    uint8_t* sv = sk + C::kStages * C::kTileBytes;
    uint64_t* full = reinterpret_cast<uint64_t*>(sv + C::kStages
                                                 * C::kTileBytes);
    uint64_t* empty = full + C::kStages;
    uint64_t* q_full = empty + C::kStages;               // [2]
    uint64_t* q_empty = q_full + 2;                      // [2]

    // persistent: CTA c takes work items c, c + gridDim.x, ...; item w is
    // (q block n_qb - 1 - w / BH, head w % BH), the longest causal blocks
    // first
    const int n_qb = (T + kBlockQ - 1) / kBlockQ;
    const int n_items = n_qb * BH;

    if (threadIdx.x == 0) {
        // empty barriers take lane 0 of each consumer warp
        for (int s = 0; s < C::kStages; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 2 * 4);
        }
        for (int b = 0; b < 2; ++b) {
            sm90::mbar_init(&q_full[b], 1);
            sm90::mbar_init(&q_empty[b], 2 * 4);
        }
        sm90::mbar_init_fence();
    }
    __syncthreads();

    // the role, warp-uniform for the compiler (a shuffle of lane 0's)
    const int grp = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (grp == 2) {
        // ---- producer: one thread issues every TMA load -------------------
        sm90::reg_dealloc<56>();
        if (threadIdx.x != 256) return;
        int it = 0, li = 0;                // tiles and items so far
        for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++li) {
            const int bh = w % BH, q_lo = (n_qb - 1 - w / BH) * kBlockQ;
            int j_lo, j_hi;
            live_tiles(q_lo, min(q_lo + kBlockQ, T) - 1, S, causal, window,
                       j_lo, j_hi);
            const int kvh = bh / group, qb = li & 1;
            sm90::mbar_wait(&q_empty[qb], ((li >> 1) & 1) ^ 1);
            sm90::mbar_arrive_tx(&q_full[qb], C::kQBytes);
            for (int p = 0; p < C::kParts; ++p)
                sm90::tma_load_3d(sq + qb * C::kQBytes
                                  + p * kBlockQ * C::kSw, &tq, &q_full[qb],
                                  p * C::kSw / 2, q_lo, bh);
            for (int j = j_lo; j < j_hi; ++j, ++it) {
                const int st = it % C::kStages;
                sm90::mbar_wait(&empty[st], ((it / C::kStages) & 1) ^ 1);
                sm90::mbar_arrive_tx(&full[st], 2 * C::kTileBytes);
                for (int p = 0; p < C::kParts; ++p) {
                    const int off = st * C::kTileBytes + p * kBlockK * C::kSw;
                    sm90::tma_load_3d(sk + off, &tk, &full[st],
                                      p * C::kSw / 2, j * kBlockK, kvh);
                    sm90::tma_load_3d(sv + off, &tv, &full[st],
                                      p * C::kSw / 2, j * kBlockK, kvh);
                }
            }
        }
    } else {
        // ---- consumers: 64 q rows each --------------------------------------
        sm90::reg_alloc<224>();
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        const int g = lane / 4, tg = lane % 4;
        constexpr int NS = kBlockK / 2;      // S accumulator floats
        constexpr int NO = D / 2;            // O accumulator floats
        constexpr int KH = kBlockK / 32;     // P V k-steps per 64 kv rows
        // The two consumers take turns to issue their products (named
        // barriers 3 + grp), so one's softmax runs beside the other's
        // products instead of both in step: per item j_hi - j_lo + 1 turns
        // each (one per tile, one for the first S), dead tiles included.
        // Consumer 1 opens; consumer 0 takes one last turn to close.
        auto turn_begin = [&]() { bar_sync(3 + grp); };
        auto turn_end = [&]() { bar_arrive(4 - grp); };
        auto idle_turn = [&]() {
            turn_begin();
            turn_end();
        };
        if (grp == 1) bar_arrive(3);
        int it = 0, li = 0;
        for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++li) {
            const int bh = w % BH, q_lo = (n_qb - 1 - w / BH) * kBlockQ;
            int j_lo, j_hi;
            live_tiles(q_lo, min(q_lo + kBlockQ, T) - 1, S, causal, window,
                       j_lo, j_hi);
            const int qb = li & 1;
            const uint8_t* qs = sq + qb * C::kQBytes + grp * 64 * C::kSw;
            const int wg_lo = q_lo + grp * 64, wg_hi = min(wg_lo + 63, T - 1);
            const int r0 = wg_lo + warp * 16 + g, r1 = r0 + 8;
            // this warpgroup's live tiles [wj_lo, wj_hi) of the item's; the
            // others it only waits for and frees
            int wj_lo, wj_hi;
            live_tiles(wg_lo, wg_hi, S, causal, window, wj_lo, wj_hi);
            if (wg_lo >= T) wj_hi = j_lo;
            wj_hi = min(wj_hi, j_hi);
            wj_lo = min(wj_hi, max(j_lo, wj_lo));
            const int base = it - j_lo;
            auto stage = [&](int j) { return (base + j) % C::kStages; };
            auto wait_tile = [&](int j) {
                sm90::mbar_wait(&full[stage(j)],
                                ((base + j) / C::kStages) & 1);
            };
            auto free_tile = [&](int j) {
                if (lane == 0) sm90::mbar_arrive(&empty[stage(j)]);
            };
            float acc[NO];
#pragma unroll
            for (int i = 0; i < NO; ++i) acc[i] = 0.f;
            float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
            sm90::mbar_wait(&q_full[qb], (li >> 1) & 1);
            for (int j = j_lo; j < wj_lo; ++j) {
                wait_tile(j);
                idle_turn();
                free_tile(j);
            }
            float s[NS];
            if (wj_lo < wj_hi) {
                wait_tile(wj_lo);
                wg::fence_regs(s);
                turn_begin();
                wg::wgmma_fence();
                issue_s<D>(s, qs, sk + stage(wj_lo) * C::kTileBytes);
                wg::wgmma_commit();
                turn_end();
                wg::wgmma_wait<0>();
                wg::fence_regs(s);
            } else {
                idle_turn();
            }
            // one tile: the softmax of its S, its P V and, when NEXT, the
            // next tile's S = Q K^T behind it (the last tile is a separate
            // instance, so no branch sits inside a pipeline stage: one
            // there makes the compiler serialize every wgmma)
            auto step = [&](int j, auto next) {
                constexpr bool NEXT = decltype(next)::value;
                const int k_lo = j * kBlockK;
                const bool edge = k_lo + kBlockK > S
                    || (causal && k_lo + kBlockK - 1 > wg_lo)
                    || (window > 0 && k_lo <= wg_hi - window);
                // the tile is two halves of 64 kv rows, each one step of
                // the plain version's recurrence (maxima a, then b), so p
                // rounds against the same running maximum as there.  Off
                // the edges the scale is folded into the exponent,
                // p = 2^(s * scale - m), and maxima are taken on s
                // (scale > 0); on an edge tile s is first scaled and masked
                // to -1e30, as in the Pallas kernel.
                if (edge) {
#pragma unroll
                    for (int n = 0; n < NS / 4; ++n) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int kp = k_lo + n * 8 + tg * 2 + (e & 1);
                            const int qp = e < 2 ? r0 : r1;
                            bool ok = kp < S;
                            if (causal) ok = ok && kp <= qp;
                            if (window > 0) ok = ok && kp > qp - window;
                            s[4 * n + e] = ok ? s[4 * n + e] * scale_log2
                                              : kNeg;
                        }
                    }
                }
                float ma0 = kNeg, ma1 = kNeg, mb0 = kNeg, mb1 = kNeg;
#pragma unroll
                for (int n = 0; n < NS / 4; ++n) {
                    if (n < NS / 8) {
                        ma0 = fmaxf(ma0, fmaxf(s[4 * n], s[4 * n + 1]));
                        ma1 = fmaxf(ma1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
                    } else {
                        mb0 = fmaxf(mb0, fmaxf(s[4 * n], s[4 * n + 1]));
                        mb1 = fmaxf(mb1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
                    }
                }
#pragma unroll
                for (int off = 1; off < 4; off <<= 1) {
                    ma0 = fmaxf(ma0, __shfl_xor_sync(0xffffffffu, ma0, off));
                    ma1 = fmaxf(ma1, __shfl_xor_sync(0xffffffffu, ma1, off));
                    mb0 = fmaxf(mb0, __shfl_xor_sync(0xffffffffu, mb0, off));
                    mb1 = fmaxf(mb1, __shfl_xor_sync(0xffffffffu, mb1, off));
                }
                const float k = edge ? 1.f : scale_log2;
                ma0 = fmaxf(m0, ma0 * k);
                ma1 = fmaxf(m1, ma1 * k);
                mb0 = fmaxf(ma0, mb0 * k);
                mb1 = fmaxf(ma1, mb1 * k);
                const float ala0 = ex2(m0 - ma0), ala1 = ex2(m1 - ma1);
                const float alb0 = ex2(ma0 - mb0), alb1 = ex2(ma1 - mb1);
                m0 = mb0;
                m1 = mb1;
                // P as m64k16 A fragments: k-step kk holds columns
                // 16kk .. 16kk + 15, i.e. S chunks 2kk and 2kk + 1
                uint32_t pa[kBlockK / 16][4];
                float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
                for (int n = 0; n < NS / 4; ++n) {
                    const bool hb = n >= NS / 8;
                    const float c0 = hb ? mb0 : ma0, c1 = hb ? mb1 : ma1;
                    const uint32_t u0 = pack_bf16(
                        ex2(fmaf(s[4 * n], k, -c0)),
                        ex2(fmaf(s[4 * n + 1], k, -c0)));
                    const uint32_t u1 = pack_bf16(
                        ex2(fmaf(s[4 * n + 2], k, -c1)),
                        ex2(fmaf(s[4 * n + 3], k, -c1)));
                    pa[n / 2][(n & 1) * 2 + 0] = u0;
                    pa[n / 2][(n & 1) * 2 + 1] = u1;
                    // l sums the bf16-rounded p
                    const float v0 = bf16_lo(u0) + bf16_hi(u0);
                    const float v1 = bf16_lo(u1) + bf16_hi(u1);
                    if (hb) {
                        sb0 += v0;
                        sb1 += v1;
                    } else {
                        sa0 += v0;
                        sa1 += v1;
                    }
                }
                l0 = (l0 * ala0 + sa0) * alb0 + sb0;
                l1 = (l1 * ala1 + sa1) * alb1 + sb1;
                // (acc * al_a + P_a V_a) * al_b + P_b V_b: two stages, the
                // rescale by al_b between them
                const uint8_t* vt = sv + stage(j) * C::kTileBytes;
                rescale<NO>(acc, ala0, ala1);
                if constexpr (NEXT) wait_tile(j + 1);
                wg::fence_regs(acc);
                wg::fence_regs(s);
#pragma unroll
                for (int kk = 0; kk < kBlockK / 16; ++kk)
                    wg::fence_regs(pa[kk]);
                turn_begin();
                wg::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < KH; ++kk) issue_pv<D>(acc, pa[kk], vt, kk);
                wg::wgmma_commit();
                wg::wgmma_wait<0>();
                wg::fence_regs(acc);
                rescale<NO>(acc, alb0, alb1);
                wg::fence_regs(acc);
                wg::wgmma_fence();
#pragma unroll
                for (int kk = KH; kk < 2 * KH; ++kk)
                    issue_pv<D>(acc, pa[kk], vt, kk);
                if constexpr (NEXT)
                    issue_s<D>(s, qs, sk + stage(j + 1) * C::kTileBytes);
                wg::wgmma_commit();
                turn_end();
                wg::wgmma_wait<0>();
                wg::fence_regs(acc);
                wg::fence_regs(s);
                free_tile(j);
            };
            for (int j = wj_lo; j + 1 < wj_hi; ++j) step(j, Flag<true>());
            if (wj_lo < wj_hi) step(wj_hi - 1, Flag<false>());
            for (int j = wj_hi; j < j_hi; ++j) {
                wait_tile(j);
                idle_turn();
                free_tile(j);
            }
            it += j_hi - j_lo;
            if (lane == 0) sm90::mbar_arrive(&q_empty[qb]);   // Q read

            // l is a per-thread partial sum until here: the quad holds it
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                l0 += __shfl_xor_sync(0xffffffffu, l0, off);
                l1 += __shfl_xor_sync(0xffffffffu, l1, off);
            }
            const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
            __nv_bfloat16* o0 = o + ((size_t)bh * T + r0) * D;
            __nv_bfloat16* o1 = o + ((size_t)bh * T + r1) * D;
#pragma unroll
            for (int n = 0; n < NO / 4; ++n) {
                const int c = n * 8 + tg * 2;
                if (r0 < T)
                    *reinterpret_cast<uint32_t*>(o0 + c) =
                        pack_bf16(acc[4 * n] / d0, acc[4 * n + 1] / d0);
                if (r1 < T)
                    *reinterpret_cast<uint32_t*>(o1 + c) =
                        pack_bf16(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
            }
        }
        if (grp == 0) bar_sync(3);         // consumer 1's last pass
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault) == cudaSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a 3-D map [heads, rows, D] bf16 read in boxes of [1, box_rows, sw / 2]
bool encode(CUtensorMap* map, const void* base, int heads, int rows, int D,
            int box_rows, int sw) {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                                (cuuint64_t)heads};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)rows * D * 2};
    const cuuint32_t box[3] = {(cuuint32_t)(sw / 2), (cuuint32_t)box_rows, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    const CUtensorMapSwizzle swz = sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
              const_cast<void*>(base), dims, strides, box, estr,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T, int S, int group, int causal, int window, float scale,
           cudaStream_t s) {
    using C = Cfg<D>;
    CUtensorMap tq, tk, tv;
    if (!encode(&tq, q, BH, T, D, kBlockQ, C::kSw)
        || !encode(&tk, k, BH / group, S, D, kBlockK, C::kSw)
        || !encode(&tv, v, BH / group, S, D, kBlockK, C::kSw))
        return (int)cudaErrorInvalidValue;
    const int smem = C::kSmem + 1024;                 // + alignment slack
    auto kern = flash_attn_fwd<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)) != cudaSuccess)
        return (int)err;
    const long long items = (long long)BH * ((T + kBlockQ - 1) / kBlockQ);
    const int grid = (int)(items < sms ? items : sms);   // one CTA per SM
    kern<<<grid, kThreads, smem, s>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), BH, T, S, group, causal,
        window, scale * kLog2e);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S >= 1; q, k, v 16-byte aligned
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
