// K3 as the witness commitments drive it: keccak256 over many ragged word
// streams in one launch, one thread per stream (CUDA C++, sm_90a).
//
// Replaces era_zk_evm_tpu/ops/keccak.py::keccak_f1600_bitsliced (K3) and
// keccak_f1600_pallas (K4) as era_zk_evm_tpu/witness/packed.py::
// _absorb_ragged drives them: a scan over the rate blocks of streams padded
// to a power-of-two block count, one permutation of every state a step,
// with the state kept or replaced by a mask.  Here each thread absorbs its
// own stream from start to end with the state in registers, so nothing is
// padded, masked or stored between blocks.  Its plain version is
// era_zk_evm_tpu_torch/ops/keccak.py::keccak256_ragged_plain.
//
// Inputs: the streams concatenated into one u32 word buffer (the packed
// records' little-endian words), int64 word offsets [T + 1], and a launch
// order int32[T]; output: int32[T, 8], the 32-byte digest of each stream as
// little-endian u32 words.  A stream of n words absorbs nb = n / 34 + 1
// blocks of 34 words (136 bytes); its last block holds the j = n - 34 (nb -
// 1) remaining words (0 <= j <= 33), then keccak256's padding: 0x01 at word
// j and 0x80000000 at word 33 (both in word 33 when j = 33; a block of
// padding alone when n % 34 == 0).
//
// What bounds it on an H100: the permutations.  A block is ~4320 int32
// operations against 136 bytes read, ~32 operations a byte where the card
// gives ~5 (1.67e13 int32 operations/s against 3.35e12 bytes/s), so the
// kernel is bound by operations, and each stream is a serial chain of
// permutations: no launch finishes before its longest stream's nb
// permutations at one thread's latency.  That latency is keccak.cuh's
// permutation on one warp (24 rounds unrolled, immediate rotations), set
// by the int32 pipe, which takes one of its instructions every second
// cycle: its SASS count is the floor's unit.  The design answers both: the
// launch order puts the longest streams first, so that a warp's lanes run
// streams of similar length and the longest chains start at once, and
// one-warp blocks spread the warps over every SM.  A thread reads its stream
// straight from device memory (its words are contiguous, so the L1 cache
// serves the rest of each 128-byte line); no shared-memory staging, since
// the bytes are a sixth of the time the operations take.

#include "common.cuh"
#include "keccak.cuh"

HD void k3s_run_stream(const uint32_t *words, const int64_t *offsets, int t,
                       int32_t *digests) {
    const int64_t start = offsets[t];
    const int64_t n = offsets[t + 1] - start;
    const int64_t nb = n / 34 + 1;
    const uint32_t *w = words + start;
    uint64_t a[25];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 25; k++) a[k] = 0;
    for (int64_t b = 0; b + 1 < nb; b++, w += 34) {
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int k = 0; k < 17; k++)
            a[k] ^= (uint64_t)w[2 * k] | ((uint64_t)w[2 * k + 1] << 32);
        keccak_f1600(a);
    }
    // the last block: j words of the stream, then the padding
    const int j = (int)(n - 34 * (nb - 1));
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 17; k++) {
        uint32_t lo = 2 * k < j ? w[2 * k] : 0u;
        uint32_t hi = 2 * k + 1 < j ? w[2 * k + 1] : 0u;
        if (2 * k == j) lo ^= 0x01u;
        if (2 * k + 1 == j) hi ^= 0x01u;
        a[k] ^= (uint64_t)lo | ((uint64_t)hi << 32);
    }
    a[16] ^= 0x8000000000000000ull;
    keccak_f1600(a);
    int32_t *out = digests + (int64_t)t * 8;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 4; k++) {
        out[2 * k] = (int32_t)(uint32_t)a[k];
        out[2 * k + 1] = (int32_t)(uint32_t)(a[k] >> 32);
    }
}

#ifdef __CUDACC__
// one warp a block: the streams' chains are long and few, so the warps are
// spread over the SMs rather than packed onto some of them
#define K3S_THREADS 32

__global__ void __launch_bounds__(K3S_THREADS) k3s_kernel(
        const uint32_t *__restrict__ words,
        const int64_t *__restrict__ offsets,
        const int32_t *__restrict__ order, int32_t *__restrict__ digests,
        int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) k3s_run_stream(words, offsets, order[i], digests);
}

extern "C" int eravm_k3s_launch(const void *words, const void *offsets,
                                const void *order, void *digests, int n,
                                void *stream) {
    const int blocks = (n + K3S_THREADS - 1) / K3S_THREADS;
    k3s_kernel<<<blocks, K3S_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)words, (const int64_t *)offsets,
        (const int32_t *)order, (int32_t *)digests, n);
    return (int)cudaGetLastError();
}
#endif
