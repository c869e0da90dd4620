// Shared definitions of the port's CUDA kernels.
//
// The per-lane bodies are `HD`: device functions under nvcc, plain inline
// functions under a host C++ compiler, so the same source also builds on a
// machine without CUDA for checking the lane logic.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define HD __device__ __forceinline__
#define HD_NOINLINE __device__ __noinline__
#define EVM_TABLE static __constant__
// a table read by data-dependent indexes: global memory, read with __ldg
// (constant memory serialises a warp's differing addresses)
#define EVM_GTABLE static __device__ const
#else
#define HD static inline
#define HD_NOINLINE static
#define EVM_TABLE static const
#define EVM_GTABLE static const
#endif

#include "eravm_gen.h"   // generated from the port's isa/ by _build.py

#ifdef __CUDACC__
// The block size of a one-thread-a-lane kernel: the largest of max_threads,
// max_threads / 2, ... 32 whose grid of `batch` lanes still spans every SM
// of the card, so that a small batch does not leave SMs idle.
static int sm_block_threads(int batch, int max_threads) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        return max_threads;
    int threads = max_threads;
    while (threads > 32 && (batch + threads - 1) / threads < sms) threads /= 2;
    return threads;
}
#endif
