// K3: chained keccak-f[1600] over a batch of states, one thread per state
// (CUDA C++, sm_90a).
//
// Replaces both TPU kernels era_zk_evm_tpu/ops/keccak.py::
// keccak_f1600_bitsliced (K3: 32 states per u32 bit-plane, [1600, 8, G8])
// and keccak_f1600_pallas (K4: the u32-pair layout [B, 25, 2]).  They
// compute the same function, `iters` chained permutations of each state; the
// port keeps K4's layout, int32[N, 25, 2] (low, high u32 of each u64 lane,
// flat index x + 5y), and drops the bit-plane converters, which exist for the
// TPU's vector lanes.  Its plain version is
// era_zk_evm_tpu_torch/ops/keccak.py::keccak_f1600_array, chained.
//
// What bounds it on an H100: the 24 rounds of 64-bit XOR, AND-NOT and
// rotate, 180 int32 operations a round (4320 a permutation) against 400
// bytes in and out a state, ~11 operations a byte where the card gives
// ~5: operations, even at iters = 1.
//
// Design.  A warp's 32 states are one contiguous span of 6400 bytes.  The
// warp stages it into shared memory with 16-byte loads, neighbouring lanes
// on neighbouring addresses (4-byte ones where the tensor is not 16-byte
// aligned, and for a ragged last warp's tail); each thread then reads its
// 25 lanes as 8-byte words at a stride of 25 words, which is odd, so a
// half-warp's reads fall in 16 distinct bank pairs.  The thread runs
// keccak.cuh's permutation `iters` times on its lanes in registers
// (immediate rotations, four rounds a loop trip), writes them back, and
// the warp stores the span the way it came.  Warps synchronise only within
// themselves, so one warp's loads overlap another's rounds.  Before this
// design each thread read and wrote its state as 50 scalar accesses 200
// bytes apart across a warp, and at iters = 1 those accesses were the
// kernel's time.

#include "common.cuh"
#include "keccak.cuh"

HD void k3_permute(uint64_t a[25], int iters) {
    for (int t = 0; t < iters; t++) keccak_f1600(a);
}

// state i of int32[N, 25, 2], read and written in place (the host build)
HD void k3_run_state(int32_t *states, int i, int iters) {
    int32_t *s = states + (uint64_t)i * 50;
    uint64_t a[25];
    for (int k = 0; k < 25; k++)
        a[k] = (uint64_t)(uint32_t)s[2 * k] |
               ((uint64_t)(uint32_t)s[2 * k + 1] << 32);
    k3_permute(a, iters);
    for (int k = 0; k < 25; k++) {
        s[2 * k] = (int32_t)(uint32_t)a[k];
        s[2 * k + 1] = (int32_t)(uint32_t)(a[k] >> 32);
    }
}

#ifdef __CUDACC__
#define K3_THREADS 128

// n u32 words from src to dst by a warp's lanes, 16 bytes a lane where
// both are 16-byte aligned (vec), the rest a word a lane
__device__ __forceinline__ void k3_copy(uint32_t *dst, const uint32_t *src,
                                        int n, bool vec, int lane) {
    int done = 0;
    if (vec) {
        const int n4 = n / 4;
        for (int i = lane; i < n4; i += 32)
            reinterpret_cast<uint4 *>(dst)[i] =
                reinterpret_cast<const uint4 *>(src)[i];
        done = 4 * n4;
    }
    for (int i = done + lane; i < n; i += 32) dst[i] = src[i];
}

__global__ void __launch_bounds__(K3_THREADS) k3_kernel(uint32_t *states,
                                                        int n, int iters,
                                                        int vec) {
    __shared__ __align__(16) uint32_t tile[K3_THREADS * 50];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int first = blockIdx.x * K3_THREADS + warp * 32;
    if (first >= n) return;                          // the whole warp
    const int m = min(32, n - first);                // the warp's states
    uint32_t *span = states + (uint64_t)first * 50;
    uint32_t *staged = tile + warp * 32 * 50;
    k3_copy(staged, span, m * 50, vec, lane);
    __syncwarp();
    if (lane < m) {
        uint64_t *own = reinterpret_cast<uint64_t *>(staged + lane * 50);
        uint64_t a[25];
#pragma unroll
        for (int k = 0; k < 25; k++) a[k] = own[k];
        k3_permute(a, iters);
#pragma unroll
        for (int k = 0; k < 25; k++) own[k] = a[k];
    }
    __syncwarp();
    k3_copy(span, staged, m * 50, vec, lane);
}

extern "C" int eravm_k3_launch(void *states, int n, int iters, void *stream) {
    const int blocks = (n + K3_THREADS - 1) / K3_THREADS;
    // a warp's span starts 6400 bytes after the last: 16-byte aligned
    // wherever the tensor is
    const int vec = ((uintptr_t)states & 15) == 0;
    k3_kernel<<<blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)states, n, iters, vec);
    return (int)cudaGetLastError();
}
#endif
