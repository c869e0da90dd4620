// K1's ecrecover instance (kEc): cycle_kernel.cu's interpreter with the
// ecrecover unit of secp256k1.cuh, in a source of its own so that nvcc builds
// it in a process beside the other three instances' (it is the largest).
// eravm_k1_launch (cycle_kernel.cu) calls it for ecrecover configs.  The
// unit alone, a signature a thread (ec_unit_kernel), serves its checks and
// its timing apart from K1 (ops/secp256k1.py::ecrecover_unit).

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
#endif
