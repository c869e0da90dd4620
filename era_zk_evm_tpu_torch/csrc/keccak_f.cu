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
// Design.  A thread loads its state's 25 lanes into registers, runs the
// register permutation of keccak.cuh (the one K2 uses) `iters` times and
// stores the state back in place.  What bounds it on an H100: the 24 rounds
// of 64-bit XOR, AND-NOT and rotate, done as pairs of 32-bit integer
// operations — not memory, from iters >= 2 on (200 bytes in and out per
// state against ~24 x 25 x 10 integer operations per permutation).  The
// layout is lane-major per state: a thread's 200 bytes are contiguous, so a
// warp's loads are strided by 200 bytes and coalesce poorly; at iters >= 2
// that cost is paid once against many permutations.

#include "common.cuh"
#include "keccak.cuh"

HD void k3_run_state(int32_t *states, int i, int iters) {
    int32_t *s = states + (uint64_t)i * 50;
    uint64_t a[25];
    for (int k = 0; k < 25; k++)
        a[k] = (uint64_t)(uint32_t)s[2 * k] |
               ((uint64_t)(uint32_t)s[2 * k + 1] << 32);
    for (int t = 0; t < iters; t++) keccak_f1600(a);
    for (int k = 0; k < 25; k++) {
        s[2 * k] = (int32_t)(uint32_t)a[k];
        s[2 * k + 1] = (int32_t)(uint32_t)(a[k] >> 32);
    }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) k3_kernel(int32_t *states, int n,
                                                 int iters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) k3_run_state(states, i, iters);
}

extern "C" int eravm_k3_launch(void *states, int n, int iters, void *stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    k3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (int32_t *)states, n, iters);
    return (int)cudaGetLastError();
}
#endif
