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
//
// The word reads (p6w_kernel) price K1's own access: a thread per lane reads
// a whole 256-bit word, arena word (t, idx[t]), REPS times, in one of three
// layouts: K1's lane-major word arena [TB, W, 8] (a lane's 8 limbs are 32
// contiguous bytes) with 8 x 32-bit loads, the same with 2 x 128-bit (int4)
// loads, and the batch-last word arena [W, 8, TB] (limb l of the lanes at
// one word index contiguous), with 8 x 32-bit loads.  out[l, t] = REPS x
// limb l of the word, the same function as the element reads on the
// canonical arena [8, W, TB].

#include "common.cuh"

enum { kLaneWords = 0, kLaneWordsV4 = 1, kWordsBatchLast = 2 };

// limb l of word (t, i) of the three word layouts
HD uint64_t p6w_offset(int W, int TB, int layout, int t, uint32_t i, int l) {
    return layout == kWordsBatchLast ? ((uint64_t)i * 8 + l) * TB + t
                                     : ((uint64_t)t * W + i) * 8 + l;
}

// REPS x word (t, idx) into acc[8]; a word index past the arena reads zero
HD void p6w_sum(const uint32_t *arena, int W, int TB, int layout, uint32_t i,
                int t, int reps, uint32_t acc[8]) {
    for (int l = 0; l < 8; l++) acc[l] = 0;
    if (i >= (uint32_t)W) return;
    for (int r = 0; r < reps; r++) {
#ifdef __CUDA_ARCH__
        if (layout == kLaneWordsV4) {
            const uint32_t *p = arena + p6w_offset(W, TB, layout, t, i, 0);
            uint32_t v[8];
            asm volatile("ld.volatile.global.v4.u32 {%0,%1,%2,%3}, [%4];"
                         : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                         : "l"(p));
            asm volatile("ld.volatile.global.v4.u32 {%0,%1,%2,%3}, [%4];"
                         : "=r"(v[4]), "=r"(v[5]), "=r"(v[6]), "=r"(v[7])
                         : "l"(p + 4));
            for (int l = 0; l < 8; l++) acc[l] += v[l];
            continue;
        }
#endif
        for (int l = 0; l < 8; l++)
            acc[l] += *(const volatile uint32_t *)(
                arena + p6w_offset(W, TB, layout, t, i, l));
    }
}

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

// P6's bound.  P6's loads are strong (volatile: LDG.E.STRONG.SYS, served
// by L2) and its loop issues 16 before it reads the first, so a lane waits
// at least REPS / 16 times for one load's latency: that floor, or the
// bytes', whichever is larger, bounds it.  Two measurements, neither a port
// of a TPU kernel:
//   chain (p6c_kernel, `blocks` = 0): one block of n lanes, each chasing
//     `reps` dependent volatile loads through an arena of u32 indices (i =
//     arena[i], from start[t]); with arena[i] = i each lane reads its own
//     word again and each address waits on the load before it: the time a
//     load is one load's latency, the floor's;
//   lines (p6r_kernel, `blocks` > 0): P6's launch shape, `blocks` blocks of
//     n lanes, lane t of block b summing `reps` volatile loads that cycle
//     over 16 lines of n words, arena[(16 b + r % 16) * n + t] (start
//     unused), issued 16 at a time as P6's are: P6's count of loads, none
//     to the line of the 15 before it.  A comparison, not a bound: P6's
//     re-reads of one address are served faster than these.
HD uint32_t p6c_chase(const uint32_t *arena, uint32_t i, int reps) {
    for (int r = 0; r < reps; r++) i = *(const volatile uint32_t *)(arena + i);
    return i;
}

// the lines' sum, 16 loads issued before they are summed (as P6's loop
// issues its own), then the rest one at a time
HD uint32_t p6r_sum(const uint32_t *arena, int n, int b, int t, int reps) {
    const volatile uint32_t *line = arena + (uint64_t)16 * b * n + t;
    uint32_t acc = 0;
    int r = 0;
    for (; r + 16 <= reps; r += 16) {
        uint32_t v[16];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int j = 0; j < 16; j++) v[j] = line[(uint64_t)j * n];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int j = 0; j < 16; j++) acc += v[j];
    }
    for (; r < reps; r++) acc += line[(uint64_t)(r & 15) * n];
    return acc;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(1024) p6c_kernel(const uint32_t *arena,
                                                   const uint32_t *start,
                                                   uint32_t *out, int n,
                                                   int reps) {
    const int t = threadIdx.x;
    if (t < n) out[t] = p6c_chase(arena, start[t], reps);
}

__global__ void __launch_bounds__(1024) p6r_kernel(const uint32_t *arena,
                                                   uint32_t *out, int n,
                                                   int reps) {
    const int t = threadIdx.x, b = blockIdx.x;
    if (t < n) out[(uint64_t)b * n + t] = p6r_sum(arena, n, b, t, reps);
}

// n <= 1024 lanes a block; blocks = 0: the chain, out u32[n]; blocks > 0:
// the lines, arena u32[16 * blocks * n], out u32[blocks, n]
extern "C" int eravm_p6c_launch(const void *arena, const void *start,
                                void *out, int n, int reps, int blocks,
                                void *stream) {
    if (n < 1 || n > 1024 || blocks < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (blocks == 0)
        p6c_kernel<<<1, n, 0, s>>>((const uint32_t *)arena,
                                   (const uint32_t *)start, (uint32_t *)out,
                                   n, reps);
    else
        p6r_kernel<<<blocks, n, 0, s>>>((const uint32_t *)arena,
                                        (uint32_t *)out, n, reps);
    return (int)cudaGetLastError();
}

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

__global__ void __launch_bounds__(256) p6w_kernel(const uint32_t *arena,
                                                  const uint32_t *idx,
                                                  uint32_t *out, int W, int TB,
                                                  int reps, int layout) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= TB) return;
    uint32_t acc[8];
    p6w_sum(arena, W, TB, layout, idx[t], t, reps, acc);
    for (int l = 0; l < 8; l++) out[(uint64_t)l * TB + t] = acc[l];
}

// arena u32[TB, W, 8] (layout 0, 1) or u32[W, 8, TB] (layout 2), idx
// u32[TB], out u32[8, TB]
extern "C" int eravm_p6w_launch(const void *arena, const void *idx, void *out,
                                int W, int TB, int reps, int layout,
                                void *stream) {
    const int threads = 256;
    p6w_kernel<<<(TB + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>((const uint32_t *)arena,
                                         (const uint32_t *)idx,
                                         (uint32_t *)out, W, TB, reps, layout);
    return (int)cudaGetLastError();
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
