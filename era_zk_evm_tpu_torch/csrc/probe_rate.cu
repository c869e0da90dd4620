// The instruction-rate probes P3 and P4 (CUDA C++, sm_90a).
//
// Replace the TPU kernels of tools/probe_keccak.py:
//   P3 probe_vpu_rate    `iters` x (inner / rows) steps of one u32 op over
//                        `rows` values a column: xor r[j] ^ r[j+1], mix
//                        rotl1(r[j]) ^ r[j+1], andnot r[j] ^ (~r[j+1] &
//                        r[j+2]) (indices mod rows, every row from the old
//                        values);
//   P4 probe_round_rate  `iters` single keccak rounds with one fixed round
//                        constant.
// Their plain versions are in era_zk_evm_tpu_torch/tools/probe_keccak.py.
//
// P3.  A thread per column with its `rows` values in registers (the op and
// rows are template parameters), the step count a runtime argument and the
// inputs random, so that nothing folds into constants; kP3Unroll steps a
// loop trip, whatever the compiler makes of them (at 8 rows it folds four
// xor steps into one, (I + S)^4 = I + S^4 over GF(2)): the probe's readout
// is the instructions of that loop (cuobjdump -sass) over its time, against
// the card's int32 instruction rate.  Bound: integer operations, by
// construction.
//
// P4.  A thread per state over int32[N, 25, 2] (K3's layout), the 25 lanes
// in registers, keccak.cuh's keccak_round `iters` times.  Bound: integer
// operations.

#include "common.cuh"
#include "keccak.cuh"

constexpr int kP3Unroll = 4;
constexpr uint64_t kP4RoundConstant = 0x9ABCDEF012345678ull;

enum P3Op { kXor = 0, kMix = 1, kAndNot = 2 };

template <int kOp, int kRows>
HD void p3_step(uint32_t r[kRows]) {
    uint32_t t[kRows];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int j = 0; j < kRows; j++) {
        const uint32_t a = r[j], b = r[(j + 1) % kRows], c = r[(j + 2) % kRows];
        t[j] = kOp == kXor ? a ^ b
             : kOp == kMix ? ((a << 1) | (a >> 31)) ^ b
             : a ^ (~b & c);
    }
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int j = 0; j < kRows; j++) r[j] = t[j];
}

// `steps` steps of column i of st (u32[rows, n])
template <int kOp, int kRows>
HD void p3_run_column(uint32_t *st, int n, int i, int steps) {
    uint32_t r[kRows];
    for (int j = 0; j < kRows; j++) r[j] = st[(uint64_t)j * n + i];
    int s = 0;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (; s + kP3Unroll <= steps; s += kP3Unroll) {
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int u = 0; u < kP3Unroll; u++) p3_step<kOp, kRows>(r);
    }
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (; s < steps; s++) p3_step<kOp, kRows>(r);
    for (int j = 0; j < kRows; j++) st[(uint64_t)j * n + i] = r[j];
}

HD void p4_run_state(int32_t *states, int i, int iters) {
    int32_t *s = states + (uint64_t)i * 50;
    uint64_t a[25];
    for (int k = 0; k < 25; k++)
        a[k] = (uint64_t)(uint32_t)s[2 * k] |
               ((uint64_t)(uint32_t)s[2 * k + 1] << 32);
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int t = 0; t < iters; t++) keccak_round(a, kP4RoundConstant);
    for (int k = 0; k < 25; k++) {
        s[2 * k] = (int32_t)(uint32_t)a[k];
        s[2 * k + 1] = (int32_t)(uint32_t)(a[k] >> 32);
    }
}

#ifdef __CUDACC__
template <int kOp, int kRows>
__global__ void __launch_bounds__(256) p3_kernel(uint32_t *st, int n,
                                                 int steps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) p3_run_column<kOp, kRows>(st, n, i, steps);
}

// st: u32[rows, n], stepped in place; op 0 xor, 1 mix, 2 andnot; rows 8
// (the tools' only row count)
extern "C" int eravm_p3_launch(void *st, int rows, int n, int steps, int op,
                               void *stream) {
    const int threads = 256, blocks = (n + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    uint32_t *p = (uint32_t *)st;
#define P3_LAUNCH(OP, ROWS) \
    if (op == OP && rows == ROWS) { \
        p3_kernel<OP, ROWS><<<blocks, threads, 0, s>>>(p, n, steps); \
        return (int)cudaGetLastError(); }
    P3_LAUNCH(kXor, 8) P3_LAUNCH(kMix, 8) P3_LAUNCH(kAndNot, 8)
#undef P3_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// steps a loop trip of P3's main loop (for reading its SASS)
extern "C" int eravm_p3_unroll() { return kP3Unroll; }

__global__ void __launch_bounds__(128) p4_kernel(int32_t *states, int n,
                                                 int iters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) p4_run_state(states, i, iters);
}

extern "C" int eravm_p4_launch(void *states, int n, int iters, void *stream) {
    const int threads = 128, blocks = (n + threads - 1) / threads;
    p4_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (int32_t *)states, n, iters);
    return (int)cudaGetLastError();
}
#endif
