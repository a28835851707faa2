// Hopper (sm_90a) building blocks of the warp-specialised kernels
// (flash_attn.cu, onehot_match.cu, dfa_match.cu, lvec_compose.cu), written as
// inline PTX: shared-memory barriers (mbarrier), tensor-memory-accelerator
// loads (TMA, plain bulk copies) and cp.async copies, thread-block
// clusters and their distributed shared memory, and the shared-memory matrix
// descriptors that wgmma reads its operands through.

#pragma once

#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the barriers' initialisation visible (async proxy included)
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// add `bytes` to the transaction count of the current phase (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that lasts
// longer than ~2^34 cycles (about ten seconds) traps, so a broken pipeline
// fails its launch instead of hanging the card
__device__ __forceinline__ bool mbar_try(uint32_t a, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    if (mbar_try(a, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try(a, parity))
        if (clock64() - t0 > (1ll << 34)) __trap();
}

// wait with cluster-scope acquire: for a barrier that peer CTAs arrive on
// (their writes before the arrival become visible)
__device__ __forceinline__ bool mbar_try_cluster(uint32_t a, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
    const uint32_t a = smem_addr(bar);
    if (mbar_try_cluster(a, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_cluster(a, parity))
        if (clock64() - t0 > (1ll << 34)) __trap();
}

// generic-proxy shared-memory writes -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- TMA ----------------------------------------------------------------------

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// into this CTA's shared memory; completes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(smem_addr(bar))
        : "memory");
}

// one 4-byte asynchronous copy from global into shared memory (for rows that
// are not whole aligned 16-byte units; cp_async_arrive tracks it)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src))
                 : "memory");
}

// hold the current phase of `bar` open until this thread's earlier cp.async
// copies have landed (no net arrival: the thread still arrives itself)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// -- shared-memory loads by address -------------------------------------------

__device__ __forceinline__ uint32_t lds(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ void sts(uint32_t a, uint32_t v) {
    asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(a), "r"(v));
}

__device__ __forceinline__ uint4 lds4(uint32_t a) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
    return v;
}

// -- named barriers -------------------------------------------------------------

// the `n` threads (whole warps) that meet at barrier `id` (1..15; 0 is
// __syncthreads); orders their shared-memory accesses
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// AND of `pred` over the `n` threads (whole warps) that meet at barrier `id`
__device__ __forceinline__ bool bar_and(int id, int n, bool pred) {
    uint32_t r;
    asm volatile(
        "{\n.reg .pred p, q;\n"
        "setp.ne.u32 q, %1, 0;\n"
        "bar.red.and.pred p, %2, %3, q;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(r) : "r"((uint32_t)pred), "r"(id), "r"(n) : "memory");
    return r != 0;
}

// -- thread-block clusters and distributed shared memory ----------------------

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// every thread of every CTA of the cluster; orders all memory operations
// before it (release) against all after it (acquire), cluster-wide
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of this CTA's shared word `a` in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_map(uint32_t a, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
                 : "=r"(v) : "r"(a) : "memory");
    return v;
}

__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t v) {
    asm volatile("st.shared::cluster.u32 [%0], %1;\n"
                 :: "r"(a), "r"(v) : "memory");
}

// arrive (release, cluster scope) on a barrier of any CTA of the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint32_t a) {
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
        :: "r"(a) : "memory");
}

// -- wgmma shared-memory descriptors ------------------------------------------
//
// Swizzle modes, by the bytes of one swizzled row: 128, 64 or 32.  The
// descriptor's layout field is 1, 2 or 3; a TMA box with the same swizzle
// writes exactly the layout the descriptor reads, as long as the tile
// starts on a multiple of 8 rows x the row's bytes (1024 B at 128).

template <int ROW_BYTES>
struct Swizzle;
template <> struct Swizzle<128> { static constexpr uint64_t kMode = 1; };
template <> struct Swizzle<64> { static constexpr uint64_t kMode = 2; };
template <> struct Swizzle<32> { static constexpr uint64_t kMode = 3; };

// start address, leading and stride byte offsets (bytes, multiples of 16)
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
    return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF)
           | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
           | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
           | Swizzle<ROW_BYTES>::kMode << 62;
}

// -- warp specialisation ---------------------------------------------------------

template <int N>
__device__ __forceinline__ void reg_alloc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// byte offset of bf16 element (row, col) of a tile stored as the TMA box
// with a ROW_BYTES swizzle writes it: rows at ROW_BYTES pitch, the 16-byte
// chunks of row r XOR-ed with (address bits 7..9 of the row's start)
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
    const uint32_t off = (uint32_t)row * ROW_BYTES + (uint32_t)col * 2;
    constexpr uint32_t mask = ROW_BYTES == 128 ? 7 : ROW_BYTES == 64 ? 3 : 1;
    return off ^ (((off >> 7) & mask) << 4);
}

}  // namespace sm90
