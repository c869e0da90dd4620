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

// The round-witness emit word that K1's precompile instances write a lane a
// cycle (pq_emit_blk) and the splice (pq_splice.cu) reads: 0 where the lane
// ran no unit, else the rows of its block that carry data: its n_in mem_in
// rows (rows 0 .. n_in - 1, n_in <= PS_IN) in the low 16 bits and its n_out
// >= 1 mem_out rows (rows PS_IN .. PS_IN + n_out - 1: two for an ecrecover
// call, else one) above them.  K1 stores only those rows; the splice writes
// the block's other rows as zeros and never reads them.
#define PQ_EMIT(n_in, n_out) ((uint32_t)(n_in) | ((uint32_t)(n_out) << 16))

// whether row i of a block whose emit word is e carries data
HD bool pq_data_row(uint32_t e, uint32_t i, uint32_t ps_in) {
    return i < (e & 0xffffu) || i - ps_in < (e >> 16);
}

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
