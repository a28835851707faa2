// Keyed lane-map compose (the out-of-order gap-close fold) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   B3  repro/kernels/lvec_compose.py::spec_compose_lanes_kernel       (carry)
//   B4  repro/kernels/lvec_compose.py::spec_compose_lanes_tree_kernel  (tree)
//
// What it computes, per run b (one CTA each): the composition of the
// candidate-keyed [K, S] lane maps lanes[b, 0..N-1].  Element 0 seeds the
// result (its key is never read); element i folds in through the keyed
// Eq. 8 combine
//     lane = cand_index[keys[b, i], acc]
//     acc  = lane < 0 ? (sinks[k] >= 0 ? sinks[k] : acc)
//                     : lanes[b, i, k, lane]        (within pattern k's lanes)
// and a key equal to pad_key is the identity.
//   * carry (B3): the sequential left fold, each lane's accumulator in a
//     register; threads stride over the K*S lanes of the run.
//   * tree (B4): log2(N) levels of pairwise combines in place: at stride st
//     slot i (a multiple of 2*st) becomes combine(slot i, slot i + st) with
//     the right slot's own key, so a combined pair keeps the left key and a
//     miss with no sink falls back to the left operand, as in the Pallas
//     tree.  The run sits in shared memory when N*K*S*4 bytes fit, else the
//     levels work in a global scratch copy of the row; __syncthreads()
//     separates the levels.  A slot written at one level is read at that
//     level only by the thread that writes it, so no level needs a second
//     buffer.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move are the maps
// (B*N*K*S*4) and keys read once, the output written once, and at most one
// cand_index entry per lane-combine.  For PCRE-14 under r = 2 (K*S = 210
// lanes) at B = 1024 runs of N = 32 that is ~28 MB, about 8-9 us; the work,
// two dependent loads per lane-combine (~6.9e6 combines), is a few
// microseconds at the card's shared-memory load rate, so bytes bind.  The
// carry is a chain of 2*(N-1) dependent loads per lane, so it is
// latency-bound unless enough runs are in flight: one CTA per run and up to
// 1024 CTAs keep every SM busy at that shape.  cand_index ([1370, 194]
// int32 = 1.06 MB under r = 2) is read through the read-only path and
// stays in L2; it never goes to shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int combine(int a, const int* __restrict__ right,
                                       int key, const int* __restrict__ cidx,
                                       int q, int sink) {
    // right points at pattern k's S lanes of the right map
    const int lane = __ldg(cidx + (size_t)key * q + a);
    if (lane < 0) return sink >= 0 ? sink : a;
    return right[lane];
}

__global__ void compose_carry(const int* __restrict__ lanes,  // [B, N, K*S]
                              const int* __restrict__ keys,   // [B, N]
                              const int* __restrict__ cidx,   // [nk, Q]
                              const int* __restrict__ sinks,  // [K]
                              int* __restrict__ out,          // [B, K*S]
                              int N, int Q, int K, int S, int pad_key) {
    const int b = blockIdx.x;
    const int ks = K * S;
    const int* lanes_b = lanes + (size_t)b * N * ks;
    const int* keys_b = keys + (size_t)b * N;
    for (int o = threadIdx.x; o < ks; o += blockDim.x) {
        const int k = o / S;
        const int sink = __ldg(sinks + k);
        int acc = lanes_b[o];
        for (int i = 1; i < N; ++i) {
            const int key = __ldg(keys_b + i);
            if (key == pad_key) continue;
            acc = combine(acc, lanes_b + (size_t)i * ks + k * S, key, cidx,
                          Q, sink);
        }
        out[(size_t)b * ks + o] = acc;
    }
}

template <bool IN_SMEM>
__global__ void compose_tree(const int* __restrict__ lanes,  // [B, N, K*S]
                             const int* __restrict__ keys,   // [B, N]
                             const int* __restrict__ cidx,   // [nk, Q]
                             const int* __restrict__ sinks,  // [K]
                             int* __restrict__ out,          // [B, K*S]
                             int* __restrict__ scratch,      // [B, N, K*S]
                             int N, int Q, int K, int S, int pad_key) {
    extern __shared__ int smem[];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int ks = K * S;
    const int* lanes_b = lanes + (size_t)b * N * ks;
    const int* keys_b = keys + (size_t)b * N;
    int* buf = IN_SMEM ? smem : scratch + (size_t)b * N * ks;
    if (IN_SMEM) {
        for (int i = tid; i < N * ks; i += blockDim.x) buf[i] = lanes_b[i];
        __syncthreads();
    }
    for (int st = 1; st < N; st *= 2) {
        // level 0 of the global placement reads the input row and writes
        // the scratch row; every later level works in buf
        const int* src = (IN_SMEM || st > 1) ? buf : lanes_b;
        const int pairs = N / (2 * st);
        for (int idx = tid; idx < pairs * ks; idx += blockDim.x) {
            const int p = idx / ks;
            const int o = idx - p * ks;
            const int k = o / S;
            const size_t left = (size_t)(2 * p) * st;
            const size_t right = left + st;
            const int a = src[left * ks + o];
            const int key = __ldg(keys_b + right);
            buf[left * ks + o] =
                key == pad_key ? a
                               : combine(a, src + right * ks + k * S, key,
                                         cidx, Q, __ldg(sinks + k));
        }
        __syncthreads();
    }
    const int* res = (IN_SMEM || N > 1) ? buf : lanes_b;
    for (int o = tid; o < ks; o += blockDim.x)
        out[(size_t)b * ks + o] = res[o];
}

int threads_for(int work) {
    int t = ((work + 31) / 32) * 32;
    if (t > 1024) t = 1024;
    if (t < 32) t = 32;
    return t;
}

}  // namespace

extern "C" {

int spec_compose_lanes_launch(const int* lanes, const int* keys,
                              const int* cidx, const int* sinks, int* out,
                              int B, int N, int Q, int K, int S, int pad_key,
                              void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    compose_carry<<<B, threads_for(K * S), 0, s>>>(lanes, keys, cidx, sinks,
                                                   out, N, Q, K, S, pad_key);
    return (int)cudaGetLastError();
}

int spec_compose_lanes_tree_launch(const int* lanes, const int* keys,
                                   const int* cidx, const int* sinks,
                                   int* out, int* scratch, int B, int N,
                                   int Q, int K, int S, int pad_key,
                                   int in_smem, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int threads = threads_for((N / 2 > 0 ? N / 2 : 1) * K * S);
    if (in_smem) {
        auto kern = compose_tree<true>;
        const size_t smem = (size_t)N * K * S * sizeof(int);
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        kern<<<B, threads, smem, s>>>(lanes, keys, cidx, sinks, out, scratch,
                                      N, Q, K, S, pad_key);
    } else {
        auto kern = compose_tree<false>;
        kern<<<B, threads, 0, s>>>(lanes, keys, cidx, sinks, out, scratch, N,
                                   Q, K, S, pad_key);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
