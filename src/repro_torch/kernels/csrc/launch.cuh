// Host-side launches through cudaLaunchKernelEx, shared by dfa_match.cu and
// lvec_compose.cu: launch_ex, and the preparation it runs first -- the
// dynamic shared-memory limit, raised once per device and kernel to the
// whole budget (the attribute belongs to the function, so a smaller launch
// must not lower it under a larger one), and the cluster occupancy check,
// kept for the last configurations seen.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace launch {

constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory of a block

using KernelFn = const void*;

struct Raised {
    int dev;
    KernelFn kern;
};
struct Fits {
    int dev, cluster, threads;
    KernelFn kern;
    size_t smem;
};

inline std::mutex prepare_mu;
inline Raised raised[64];
inline int n_raised = 0;
inline Fits fits[64];
inline int n_fits = 0;

// cluster == 0 (or 1): no cluster attribute, no occupancy check
inline cudaError_t prepare(KernelFn kern, const cudaLaunchConfig_t& cfg,
                           int cluster) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const int threads = (int)cfg.blockDim.x;
    std::lock_guard<std::mutex> lock(prepare_mu);
    bool done = false;
    for (int i = 0; i < n_raised && !done; ++i)
        done = raised[i].dev == dev && raised[i].kern == kern;
    if (!done) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (err != cudaSuccess) return err;
        if (n_raised < 64) raised[n_raised++] = {dev, kern};
    }
    if (cluster <= 1) return cudaSuccess;
    const int seen = n_fits < 64 ? n_fits : 64;
    for (int i = 0; i < seen; ++i) {
        const Fits& f = fits[i];
        if (f.dev == dev && f.kern == kern && f.cluster == cluster
            && f.threads == threads && f.smem == cfg.dynamicSmemBytes)
            return cudaSuccess;
    }
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;   // no SM set fits it
    fits[n_fits++ % 64] = {dev, cluster, threads, kern, cfg.dynamicSmemBytes};
    return cudaSuccess;
}

// launch `kern(p)` on `grid` x `threads` with `smem` bytes of dynamic shared
// memory and, when cluster > 1, clusters of `cluster` CTAs along x, after
// prepare(); a CUDA error code, 0 on success
template <class P>
int launch_ex(void (*kern)(P), const P& p, dim3 grid, int threads,
              size_t smem, int cluster, void* stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = reinterpret_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    if (cluster > 1) {
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = (unsigned)cluster;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    cudaError_t err =
        prepare(reinterpret_cast<const void*>(kern), cfg, cluster);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, kern, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace launch
