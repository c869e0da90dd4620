// K1's ecrecover instance (kEc): cycle_kernel.cu's interpreter with the
// ecrecover unit of secp256k1.cuh, in a source of its own so that nvcc builds
// it in a process beside the other three instances' (it is the largest).
// eravm_k1_launch (cycle_kernel.cu) calls it for ecrecover configs.  The
// units alone serve their checks and their timing apart from K1's
// interpreter: the ecrecover unit a signature a thread (ec_unit_kernel,
// ops/secp256k1.py::ecrecover_unit) and the keccak256 / sha256 units a call
// a thread (units_kernel, models/fused_cycle.py::precompile_units).

#define K1_EC_INSTANCE
#include "cycle_kernel.cu"

#ifdef __CUDACC__
extern "C" int eravm_k1_ec_launch(const K1Args *args, void *stream) {
    return k1_launch<true, true, true>(args, (cudaStream_t)stream);
}

// digest, r, s, addr int32[n, 8] (u32 limbs), v and ok int32[n]
__global__ void __launch_bounds__(128) ec_unit_kernel(
        const int32_t *digest, const int32_t *v, const int32_t *r,
        const int32_t *s, int32_t *ok, int32_t *addr, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    U256 out;
    ok[i] = ecrecover_unit(load_u256(digest + 8 * (uint64_t)i),
                           (uint32_t)v[i], load_u256(r + 8 * (uint64_t)i),
                           load_u256(s + 8 * (uint64_t)i), &out);
    store_u256(addr + 8 * (uint64_t)i, out);
}

extern "C" int eravm_ecrecover_launch(const void *digest, const void *v,
                                      const void *r, const void *s, void *ok,
                                      void *addr, int n, void *stream) {
    if (n <= 0) return 0;
    ec_unit_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t *)digest, (const int32_t *)v, (const int32_t *)r,
        (const int32_t *)s, (int32_t *)ok, (int32_t *)addr, n);
    return (int)cudaGetLastError();
}

// The keccak256 / sha256 units alone, a call a thread (units_lane: the
// window, sponge and compression of K1's unit), the window in dynamic
// shared memory, lane-last, as in K1.  Bound by operations: a keccak-f a
// 136-byte block, a compression a round.
__global__ void __launch_bounds__(128) units_kernel(const UnitsArgs a) {
    extern __shared__ uint32_t units_win[];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < a.n) units_lane(a, i, units_win + threadIdx.x, blockDim.x);
}

extern "C" int eravm_units_launch(const UnitsArgs *args, void *stream) {
    if (args->n <= 0) return 0;
    const int threads = 128;
    const int smem = threads * 8 * args->ps_in * (int)sizeof(uint32_t);
    const cudaError_t e = cudaFuncSetAttribute(
        units_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    units_kernel<<<(args->n + threads - 1) / threads, threads, smem,
                   (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
#endif
