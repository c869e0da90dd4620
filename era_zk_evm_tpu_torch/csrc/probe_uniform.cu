// The uniform-index probe P6 (CUDA C++, sm_90a).
//
// Replaces the TPU kernel of tools/probe_mosaic_uniform.py (`kernel`, run
// by `main`): out[k, t] = the sum over REPS gathers of arena[k, idx[t], t]
// mod 2^32 for arena u32[8, W, TB] and idx u32[TB] (0 where idx[t] >= W,
// as the TPU's one-hot sweep gives).  Its plain version is
// era_zk_evm_tpu_torch/tools/probe_uniform.py::uniform_gather_plain.
//
// What it prices.  The TPU kernel holds the whole arena in VMEM, so each of
// its REPS gathers reads on-chip memory.  Here each gather is one load of a
// lane's element, a warp load of 32 lanes, and the loads are weak, so the
// SM's L1 serves every repetition after the first: the probe prices a
// gather from on-chip memory in each arena layout that K1's redesigns are
// priced against: batch-last (arena u32[8, W, TB], the TPU's, lanes
// contiguous) against lane-major (arena u32[TB, 8, W], each lane's arena
// contiguous), each with a warp-uniform and a random index.
//
// Design.
//   Loads: weak global loads (`ld.global`: LDG.E, cached in L1), one a
//     gather, kP6InFlight issued a loop trip before the first is summed,
//     so that a warp keeps that many in flight.  ptxas folds weak loads of
//     one address into one and hoists them out of the loop, `asm volatile`
//     or not, so load j of a trip reads (j + 1) z words past the element,
//     z = `zero`, a kernel argument the wrapper passes as 0, squared each
//     trip: every load reads the element, and no compiler can prove two of
//     them read one word, nor hoist one out of the loop.  Each address is
//     one mad.wide (z x 4 (j + 1) + the element's address, j an immediate)
//     in the load's own PTX (P6_LD_OP, kP6Offset; tools/unit_variants.py
//     --design uniform prices the other kinds and forms).
//   Spread: a warp sums the gathers of 32 lanes at one k.  S warps (the
//     split, chosen by the wrapper from TB: probe_uniform.split_for) share
//     a lane group's REPS gathers, REPS / S each and one more for the first
//     REPS % S, and meet in shared memory, where the group's first warp
//     adds the others' sums mod 2^32.  A block holds max(1, 8 / S) lane
//     groups of S warps, so a small TB still spreads over the card.
//   Modes: mode 0 is the per-lane load that replaces the TPU's one-hot
//     sweep on this card; mode 1 the TPU's lockstep branch (lax.cond), per
//     warp: where every live lane holds lane 0's index (__all_sync), the
//     warp gathers by that index.  Each lane's element is its own address
//     in either mode, so mode 1 issues mode 0's loads plus a shuffle and a
//     vote.
// Bound: a warp load moves the 32-byte sectors its lanes touch through L1
// at 128 bytes a clock an SM; the floor is every warp load's sectors over
// the card's 132 SMs at that rate, or the compulsory bytes (the gathered
// elements, the index, the output) over device memory's rate where that is
// larger (tools/k1_times.py: p6_sectors, p6_floor_ms).  A warp-uniform
// index in the batch-last layout touches one 128-byte line a warp load (4
// sectors); a random one, and any index in the lane-major layout, a sector
// a lane (32).
//
// The word reads (p6w_kernel) price K1's own access: a thread per lane reads
// a whole 256-bit word, arena word (t, idx[t]), REPS times, in one of three
// layouts: K1's lane-major word arena [TB, W, 8] (a lane's 8 limbs are 32
// contiguous bytes) with 8 x 32-bit loads, the same with 2 x 128-bit (v4)
// loads, and the batch-last word arena [W, 8, TB] (limb l of the lanes at
// one word index contiguous), with 8 x 32-bit loads.  out[l, t] = the sum
// of limb l of the word over REPS, the same function as the element reads
// on the canonical arena [8, W, TB]; the same loads, loop and split.

#include "common.cuh"

#ifdef __CUDACC__
#define P6_PRAGMA(x) _Pragma(#x)
#else
#define P6_PRAGMA(x)
#endif

enum { kLaneWords = 0, kLaneWordsV4 = 1, kWordsBatchLast = 2 };

// the gathers' load: weak (LDG.E, cached in L1)
#define P6_LD_OP "ld.global"
// the loads a loop trip issues before it sums the first
constexpr int kP6InFlight = 16;
// true: each load's address offset by `zero`, a kernel argument the
// wrapper passes as 0 (p6_reps), so that no compiler can prove two
// repetitions read one word (ptxas folds weak loads of one address into
// one and hoists them out of the loop); false: every load at the
// element's own address
constexpr bool kP6Offset = true;
// warps a block at S <= 8 (lane groups x splits), and the largest S
constexpr int kP6BlockWarps = 8;
constexpr int kP6MaxSplit = 16;

// the gathers that warp s of a split of S takes of reps
HD int p6_share(int reps, int S, int s) {
    return reps / S + (s < reps % S ? 1 : 0);
}

// the word at q + (j + 1) x z words: one P6_LD_OP load, in the same PTX
// as its address, which nvcc leaves as written.  The offset, z x 4 (j + 1)
// bytes, is added to the address's low word alone (one mad.lo; j an
// immediate): z = 0, so no carry is lost.
HD uint32_t p6_load(const uint32_t *q, uint32_t z, uint32_t j) {
#ifdef __CUDA_ARCH__
    uint32_t v;
    asm volatile("{ .reg .u32 lo, hi; .reg .u64 a; mov.b64 {lo, hi}, %3; "
                 "mad.lo.u32 lo, %1, %2, lo; mov.b64 a, {lo, hi}; " P6_LD_OP
                 ".u32 %0, [a]; }"
                 : "=r"(v) : "r"(z), "r"(4 * (j + 1)), "l"(q));
    return v;
#else
    return q[(uint64_t)z * (j + 1)];
#endif
}

// the four words at q + (j + 1) x z words (16-byte aligned) in one load
HD void p6_load4(const uint32_t *q, uint32_t z, uint32_t j, uint32_t v[4]) {
#ifdef __CUDA_ARCH__
    asm volatile("{ .reg .u32 lo, hi; .reg .u64 a; mov.b64 {lo, hi}, %6; "
                 "mad.lo.u32 lo, %4, %5, lo; mov.b64 a, {lo, hi}; " P6_LD_OP
                 ".v4.u32 {%0,%1,%2,%3}, [a]; }"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(z), "r"(4 * (j + 1)), "l"(q));
#else
    for (int l = 0; l < 4; l++) v[l] = q[(uint64_t)z * (j + 1) + l];
#endif
}

// the element (k, i) of lane t in the batch-last or the lane-major arena
HD uint64_t p6_offset(int W, int TB, int k, uint32_t i, int t,
                      int lane_major) {
    return lane_major ? ((uint64_t)t * 8 + k) * W + i
                      : ((uint64_t)k * W + i) * TB + t;
}

// limb 0 of word (t, i) of the three word layouts
HD uint64_t p6w_offset(int W, int TB, int layout, int t, uint32_t i) {
    return layout == kWordsBatchLast ? (uint64_t)i * 8 * TB + t
                                     : ((uint64_t)t * W + i) * 8;
}

// n gathers of the element at p, mod 2^32: a trip issues kP6InFlight
// loads before it sums the first, then the rest go one at a time.  Load j
// of a trip reads p + (j + 1) z, and z = z x z a trip: z is `zero` (0) at
// every step, but no compiler can prove any two loads read one word, nor
// hoist one out of the loop
HD uint32_t p6_reps(const uint32_t *p, int n, uint32_t zero) {
    uint32_t z = kP6Offset ? zero : 0;
    uint32_t acc = 0;
    int r = 0;
    P6_PRAGMA(unroll 1)
    for (; r + kP6InFlight <= n; r += kP6InFlight, z *= z) {
        uint32_t v[kP6InFlight];
        P6_PRAGMA(unroll)
        for (int j = 0; j < kP6InFlight; j++) v[j] = p6_load(p, z, j);
        P6_PRAGMA(unroll)
        for (int j = 0; j < kP6InFlight; j++) acc += v[j];
    }
    P6_PRAGMA(unroll 1)
    for (; r < n; r++, z *= z) acc += p6_load(p, z, 0);
    return acc;
}

// n gathers of the word whose limb l is at p + l * stride (stride 1 or
// TB), added into acc[8], mod 2^32: 8 loads a gather, or 2 of 4 limbs
// (kLaneWordsV4); kP6InFlight loads (or one gather's, where that is more)
// issued a trip before the first is summed, each offset as p6_reps's
template <int kLayout>
HD void p6w_reps(const uint32_t *p, int TB, int n, uint32_t zero,
                 uint32_t acc[8]) {
    constexpr bool kV4 = kLayout == kLaneWordsV4;
    constexpr int kLoads = kV4 ? 2 : 8;
    constexpr int kTrip = kP6InFlight / kLoads > 0 ? kP6InFlight / kLoads : 1;
    uint32_t z = kP6Offset ? zero : 0;
    const uint64_t stride = kLayout == kWordsBatchLast ? TB : 1;
    int r = 0;
    P6_PRAGMA(unroll 1)
    for (; r + kTrip <= n; r += kTrip, z *= z) {
        uint32_t v[kTrip][8];
        P6_PRAGMA(unroll)
        for (int h = 0; h < kLoads; h++) {
            const uint32_t *q = p + (kV4 ? 4 * h : h * stride);
            P6_PRAGMA(unroll)
            for (int j = 0; j < kTrip; j++) {
                if (kV4) p6_load4(q, z, j, &v[j][4 * h]);
                else v[j][h] = p6_load(q, z, j);
            }
        }
        P6_PRAGMA(unroll)
        for (int j = 0; j < kTrip; j++)
            P6_PRAGMA(unroll)
            for (int l = 0; l < 8; l++) acc[l] += v[j][l];
    }
    P6_PRAGMA(unroll 1)
    for (; r < n; r++, z *= z) {
        uint32_t v[8];
        P6_PRAGMA(unroll)
        for (int h = 0; h < kLoads; h++) {
            const uint32_t *q = p + (kV4 ? 4 * h : h * stride);
            if (kV4) p6_load4(q, z, 0, &v[4 * h]);
            else v[h] = p6_load(q, z, 0);
        }
        P6_PRAGMA(unroll)
        for (int l = 0; l < 8; l++) acc[l] += v[l];
    }
}

// word layout `layout`'s n gathers of word (t, i) into acc[8]; a word
// index past the arena reads zero
HD void p6w_sum(const uint32_t *arena, int W, int TB, int layout, uint32_t i,
                int t, int n, uint32_t zero, uint32_t acc[8]) {
    for (int l = 0; l < 8; l++) acc[l] = 0;
    if (i >= (uint32_t)W) return;
    const uint32_t *p = arena + p6w_offset(W, TB, layout, t, i);
    if (layout == kLaneWords) p6w_reps<kLaneWords>(p, TB, n, zero, acc);
    else if (layout == kLaneWordsV4)
        p6w_reps<kLaneWordsV4>(p, TB, n, zero, acc);
    else p6w_reps<kWordsBatchLast>(p, TB, n, zero, acc);
}

// the old design's latency floor.  Its loads were strong (volatile:
// LDG.E.STRONG.SYS, served by L2), 16 issued before the first was read, so
// a lane waited at least REPS / 16 times for one load's latency.  Two
// measurements explain that design and bound nothing now:
//   chain (p6c_kernel, `blocks` = 0): one block of n lanes, each chasing
//     `reps` dependent volatile loads through an arena of u32 indices (i =
//     arena[i], from start[t]); with arena[i] = i each lane reads its own
//     word again and each address waits on the load before it: the time a
//     load is one load's latency;
//   lines (p6r_kernel, `blocks` > 0): `blocks` blocks of n lanes, lane t of
//     block b summing `reps` volatile loads that cycle over 16 lines of n
//     words, arena[(16 b + r % 16) * n + t] (start unused), issued 16 at a
//     time: the old loop's count of loads, none to the line of the 15
//     before it.
HD uint32_t p6c_chase(const uint32_t *arena, uint32_t i, int reps) {
    for (int r = 0; r < reps; r++) i = *(const volatile uint32_t *)(arena + i);
    return i;
}

// the lines' sum, 16 loads issued before they are summed, then the rest
// one at a time
HD uint32_t p6r_sum(const uint32_t *arena, int n, int b, int t, int reps) {
    const volatile uint32_t *line = arena + (uint64_t)16 * b * n + t;
    uint32_t acc = 0;
    int r = 0;
    for (; r + 16 <= reps; r += 16) {
        uint32_t v[16];
        P6_PRAGMA(unroll)
        for (int j = 0; j < 16; j++) v[j] = line[(uint64_t)j * n];
        P6_PRAGMA(unroll)
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

// An empty kernel, launched as P6 is: what a launch costs alone, beside P6
// at the tool's shape, whose work is shorter than a launch
__global__ void p6_empty_kernel() {}

extern "C" int eravm_p6_empty_launch(void *stream) {
    p6_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// the index lane t gathers by: its own (mode 0), or lane 0's where every
// live lane of the warp holds it (mode 1); every lane of the warp calls it
__device__ __forceinline__ uint32_t p6_index(uint32_t i, bool live,
                                             int mode) {
    const uint32_t i0 = __shfl_sync(0xffffffffu, i, 0);
    return mode == 1 && __all_sync(0xffffffffu, !live || i == i0) ? i0 : i;
}

// A block is G lane groups (threadIdx.x / 32) of S warps each
// (threadIdx.y, the split): lane t's gathers, split S ways, meet in
// shared memory, where the group's first warp adds them.
__global__ void __launch_bounds__(32 * kP6MaxSplit, 4)
    p6_kernel(const uint32_t *arena, const uint32_t *idx, uint32_t *out,
              int W, int TB, int reps, int mode, int lane_major,
              uint32_t zero) {
    __shared__ uint32_t part[32 * kP6MaxSplit];
    const int S = blockDim.y, s = threadIdx.y;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int k = blockIdx.y;
    const bool live = t < TB;
    const uint32_t i = p6_index(live ? idx[t] : 0, live, mode);
    uint32_t acc = 0;
    if (live && i < (uint32_t)W)
        acc = p6_reps(arena + p6_offset(W, TB, k, i, t, lane_major),
                      p6_share(reps, S, s), zero);
    if (S > 1) {
        part[s * blockDim.x + threadIdx.x] = acc;
        __syncthreads();
        if (s == 0)
            for (int q = 1; q < S; q++) acc += part[q * blockDim.x + threadIdx.x];
    }
    if (s == 0 && live) out[(uint64_t)k * TB + t] = acc;
}

__global__ void __launch_bounds__(32 * kP6MaxSplit, 2)
    p6w_kernel(const uint32_t *arena, const uint32_t *idx, uint32_t *out,
               int W, int TB, int reps, int layout, uint32_t zero) {
    __shared__ uint32_t part[8][32 * kP6MaxSplit];
    const int S = blockDim.y, s = threadIdx.y;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = t < TB;
    uint32_t acc[8];
    p6w_sum(arena, W, TB, layout, live ? idx[t] : (uint32_t)W, t,
            p6_share(reps, S, s), zero, acc);
    if (S > 1) {
        for (int l = 0; l < 8; l++) part[l][s * blockDim.x + threadIdx.x] = acc[l];
        __syncthreads();
        if (s == 0)
            for (int q = 1; q < S; q++)
                for (int l = 0; l < 8; l++)
                    acc[l] += part[l][q * blockDim.x + threadIdx.x];
    }
    if (s == 0 && live)
        for (int l = 0; l < 8; l++) out[(uint64_t)l * TB + t] = acc[l];
}

// the blocks of TB lanes at split S: max(1, 8 / S) lane groups of S warps
static void p6_shape(int TB, int S, int rows, dim3 *grid, dim3 *block) {
    const int G = S < kP6BlockWarps ? kP6BlockWarps / S : 1;
    *block = dim3(32 * G, S);
    *grid = dim3((TB + 32 * G - 1) / (32 * G), rows);
}

// arena u32[TB, W, 8] (layout 0, 1) or u32[W, 8, TB] (layout 2), idx
// u32[TB], out u32[8, TB]; S warps share a lane's gathers (1 <= S <= 16);
// zero: 0 (the opaque offset)
extern "C" int eravm_p6w_launch(const void *arena, const void *idx, void *out,
                                int W, int TB, int reps, int layout, int S,
                                int zero, void *stream) {
    if (S < 1 || S > kP6MaxSplit || TB < 1) return (int)cudaErrorInvalidValue;
    dim3 grid, block;
    p6_shape(TB, S, 1, &grid, &block);
    p6w_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)arena, (const uint32_t *)idx, (uint32_t *)out, W,
        TB, reps, layout, (uint32_t)zero);
    return (int)cudaGetLastError();
}

// arena u32[8, W, TB] (lane_major 0) or u32[TB, 8, W] (lane_major 1), idx
// u32[TB], out u32[8, TB]; mode 0 per-lane, 1 warp-uniform branch; S warps
// share a lane's gathers (1 <= S <= 16); zero: 0 (the opaque offset)
extern "C" int eravm_p6_launch(const void *arena, const void *idx, void *out,
                               int W, int TB, int reps, int mode,
                               int lane_major, int S, int zero,
                               void *stream) {
    if (S < 1 || S > kP6MaxSplit || TB < 1) return (int)cudaErrorInvalidValue;
    dim3 grid, block;
    p6_shape(TB, S, 8, &grid, &block);
    p6_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)arena, (const uint32_t *)idx, (uint32_t *)out, W,
        TB, reps, mode, lane_major, (uint32_t)zero);
    return (int)cudaGetLastError();
}
#endif
