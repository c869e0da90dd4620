// The uniform-index probe P6 (CUDA C++, sm_90a).
//
// Replaces the TPU kernel of tools/probe_mosaic_uniform.py (`kernel`, run
// by `main`): out[k, t] = REPS x arena[k, idx[t], t] mod 2^32 for arena
// u32[8, W, TB] and idx u32[TB] (0 where idx[t] >= W, as the TPU's one-hot
// sweep gives), summed over REPS gathers.  Its plain version is
// era_zk_evm_tpu_torch/tools/probe_uniform.py::uniform_gather_plain.
//
// Design.  A thread per (k, t).  Mode 0 is the per-lane load that replaces
// the TPU's one-hot sweep on this card: each thread loads its own element.
// Mode 1 is the lockstep fast path the TPU probe tested, per warp: when
// every lane of the warp holds the same index (__all_sync against lane 0's,
// broadcast with __shfl_sync), the warp reads by that uniform index;
// otherwise it takes mode 0.  Each lane's element is its own address in
// either mode, so mode 1 issues the loads of mode 0 plus a shuffle and a
// vote: on this card it can only equal mode 0, and it is kept as the
// port of the TPU's branch.  What the probe measures is the layout:
// batch-last (arena u32[8, W, TB], the TPU's, lanes contiguous) against
// lane-major (arena u32[TB, 8, W], each lane's arena contiguous, as K1's
// stack, heap and registers are), each with a warp-uniform and a random
// index.  A warp-uniform index in the batch-last layout reads 128
// contiguous bytes a warp; a random one, and any index in the lane-major
// layout, a 32-byte sector a lane.  The REPS loads are volatile, so that
// the compiler emits every one of them (a plain load would be hoisted out
// of the loop and the probe would time one load).  Bound: the bytes of the
// gathered elements, the index and the output (REPS a power of two, the
// product is one shift an output).

#include "common.cuh"

HD uint32_t p6_sum(const uint32_t *arena, int W, int TB, int k, uint32_t i,
                   int t, int reps, int lane_major) {
    if (i >= (uint32_t)W) return 0;
    const volatile uint32_t *p =
        arena + (lane_major ? ((uint64_t)t * 8 + k) * W + i
                            : ((uint64_t)k * W + i) * TB + t);
    uint32_t acc = 0;
    for (int r = 0; r < reps; r++) acc += *p;
    return acc;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(256) p6_kernel(const uint32_t *arena,
                                                 const uint32_t *idx,
                                                 uint32_t *out, int W, int TB,
                                                 int reps, int mode,
                                                 int lane_major) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int k = blockIdx.y;
    const bool live = t < TB;
    const uint32_t i = live ? idx[t] : 0;
    uint32_t acc;
    // every lane of the warp reaches the votes (no early return above)
    const uint32_t i0 = __shfl_sync(0xffffffffu, i, 0);
    if (mode == 1 && __all_sync(0xffffffffu, !live || i == i0))
        acc = live ? p6_sum(arena, W, TB, k, i0, t, reps, lane_major) : 0;
    else
        acc = live ? p6_sum(arena, W, TB, k, i, t, reps, lane_major) : 0;
    if (live) out[(uint64_t)k * TB + t] = acc;
}

// arena u32[8, W, TB] (lane_major 0) or u32[TB, 8, W] (lane_major 1), idx
// u32[TB], out u32[8, TB]; mode 0 per-lane, 1 warp-uniform fast path
extern "C" int eravm_p6_launch(const void *arena, const void *idx, void *out,
                               int W, int TB, int reps, int mode,
                               int lane_major, void *stream) {
    const int threads = 256;
    const dim3 grid((TB + threads - 1) / threads, 8);
    p6_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)arena, (const uint32_t *)idx, (uint32_t *)out, W,
        TB, reps, mode, lane_major);
    return (int)cudaGetLastError();
}
#endif
