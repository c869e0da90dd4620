// K1's ecrecover instance (kEc): cycle_kernel.cu's interpreter with the
// ecrecover unit of secp256k1.cuh, in a source of its own so that nvcc builds
// it in a process beside the other three instances' (it is the largest).
// eravm_k1_launch (cycle_kernel.cu) calls it for ecrecover configs.

#define K1_EC_INSTANCE
#include "cycle_kernel.cu"

#ifdef __CUDACC__
extern "C" int eravm_k1_ec_launch(const K1Args *args, void *stream) {
    const int threads = 128;
    const int blocks = (args->batch + threads - 1) / threads;
    k1_kernel<true, true, true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        *args);
    return (int)cudaGetLastError();
}
#endif
