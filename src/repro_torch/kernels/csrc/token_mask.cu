// Grammar-constrained decoding logit mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   B5  repro/kernels/token_mask.py::token_mask_kernel
//
// What it computes: out[b, v] = allowed[states[b], v] ? logits[b, v] : neg,
// for states [B] int32, allowed [Q, V] uint8 and logits [B, V] float32 or
// bfloat16; neg is the logits dtype's rounding of -1e30, handed in as its bit
// pattern.  The select moves bits and does no arithmetic, so the output is
// bit-identical to the plain version for either dtype.  The [B, V] mask
// never exists in device memory: each block gathers its state's row of
// `allowed` and applies it to the logits in one pass.
//
// Layout: one block of 256 threads per (vocab tile, row b); a thread owns
// VEC = 16 / sizeof(element) consecutive tokens, so a tile is 256 * VEC
// tokens and each logits load and store is 16 bytes (the allowed row is read
// VEC bytes at a time).  The vocab tail is masked in the kernel: a thread
// whose VEC tokens straddle V, or a row whose pointers are not vector
// aligned, falls back to element loads, so no padded copy is ever made.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move, B*V*(1 + 2 *
// itemsize) (one allowed row byte and one logit per token read, one logit
// written).  At decode shapes (B = 8, V = 32000 bf16: 1.28 MB, 0.38 us)
// a launch costs more than its bytes; at B = 128, V = 128256 it streams
// ~82 MB (f32), ~25 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Vec;                   // VEC allowed bytes
template <> struct Vec<uint32_t> { using A = uint32_t; static constexpr int n = 4; };
template <> struct Vec<uint16_t> { using A = uint2; static constexpr int n = 8; };

template <typename T>
__global__ void token_mask(const int* __restrict__ states,     // [B]
                           const uint8_t* __restrict__ allowed, // [Q, V]
                           const T* __restrict__ logits,        // [B, V]
                           T* __restrict__ out,                 // [B, V]
                           int V, T neg, int aligned) {
    constexpr int VEC = Vec<T>::n;
    const int b = blockIdx.y;
    const int s = __ldg(states + b);
    const uint8_t* arow = allowed + (size_t)s * V;
    const T* lrow = logits + (size_t)b * V;
    T* orow = out + (size_t)b * V;
    const int v0 = (blockIdx.x * kThreads + threadIdx.x) * VEC;
    if (v0 >= V) return;
    if (aligned && v0 + VEC <= V) {
        union { uint4 u; T e[VEC]; } x;
        union { typename Vec<T>::A u; uint8_t e[VEC]; } a;
        x.u = __ldg(reinterpret_cast<const uint4*>(lrow + v0));
        a.u = __ldg(reinterpret_cast<const typename Vec<T>::A*>(arow + v0));
#pragma unroll
        for (int i = 0; i < VEC; ++i) x.e[i] = a.e[i] ? x.e[i] : neg;
        *reinterpret_cast<uint4*>(orow + v0) = x.u;
    } else {
        const int end = v0 + VEC < V ? v0 + VEC : V;
        for (int v = v0; v < end; ++v) orow[v] = arow[v] ? lrow[v] : neg;
    }
}

template <typename T>
int launch(const int* states, const uint8_t* allowed, const void* logits,
           void* out, int B, int V, uint32_t neg_bits, int aligned,
           cudaStream_t s) {
    constexpr int VEC = Vec<T>::n;
    const dim3 grid((V + kThreads * VEC - 1) / (kThreads * VEC), B);
    token_mask<T><<<grid, kThreads, 0, s>>>(
        states, allowed, static_cast<const T*>(logits), static_cast<T*>(out),
        V, static_cast<T>(neg_bits), aligned);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// itemsize 4: float32 logits, 2: bfloat16; neg_bits is the dtype's bit
// pattern of the masked value; aligned != 0 when every row of logits, out
// and allowed starts on a vector boundary.
int token_mask_launch(const int* states, const uint8_t* allowed,
                      const void* logits, void* out, int B, int V,
                      int itemsize, unsigned int neg_bits, int aligned,
                      void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (itemsize == 4)
        return launch<uint32_t>(states, allowed, logits, out, B, V, neg_bits,
                                aligned, s);
    if (itemsize == 2)
        return launch<uint16_t>(states, allowed, logits, out, B, V, neg_bits,
                                aligned, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
