// The round-witness splice of K1's precompile instances (kPrecomp, kEc):
// the rows that K1 wrote into a chunk's scratch block go into the state's
// precompile queue at the batch-global block clock.
//
// Replaces the TPU wrapper's splice in
// era_zk_evm_tpu/models/fused_cycle.py (:3529-3588), which the port first
// ran as torch ops (models/fused_cycle.py::splice_precompile_rows, now this
// kernel's plain version).  It computes the same thing: a cycle in which any
// lane emitted is flagged, and flagged cycles take consecutive blocks of PS
// rows from P = min(pq_blocks); cycle c's block is at base(c) = min(pos(c)
// PS, cap - PS) with pos(c) = P + (flagged cycles before c); of the cycles
// that share a base the last one's rows are written, zero rows for the
// lanes that did not emit in it or when its block overflowed (pos PS >
// cap - PS); an overflowed cycle sets lane_error on its emitting lanes and
// credits no pq_count; pq_blocks advances by the flagged cycles.
//
// Design.  The torch version wrote all n x PS rows of every lane through a
// gather, a multiply and a transposing copy, each the full size (about
// 1.7 GB at B = 32768, n = 128, PS = 8), though only one block of PS rows
// per distinct base survives: one per flagged cycle and the trailing
// unflagged cycles' block.  Here:
//  * pq_flag_kernel reads emit once (int32[n, B], batch-last: coalesced),
//    a block 256 lanes of 16 cycles, and writes the OR of its lanes'
//    per-cycle flags (n <= 128 cycles: four 32-bit masks) and the min of
//    their pq_blocks into a partial a block; no atomics, no memset.
//  * pq_move_kernel combines the partials (every block, from L2), so that
//    each cycle's pos, base, overflow and "last at its base" are popcounts
//    of the masks (a table in shared memory), and moves only the surviving
//    blocks, a block a tile of 32 lanes and a slice of the cycles: the
//    scratch is batch-last ([K, PS, ., B]: a warp reads 128 contiguous
//    bytes of one row) and the queue lane-major ([B, cap, .]: a lane's PS
//    rows are contiguous), so the rows go through a shared-memory tile
//    (padded to a stride of 33 words, free of bank conflicts) and both the
//    reads and the writes coalesce.  Lanes that do not keep the rows read
//    nothing and write zeros.  A block writes its rows only below the next
//    block's base, so no two blocks overlap (the clamped block at cap - PS
//    wins, as the sequential engine's later write does) and the slices need
//    no order.  Then, in slice 0, the lane scalars: pq_count, lane_error,
//    pq_blocks.
// What bounds it on an H100: bytes.  It reads emit and nslots (2 n B int32)
// and the kept rows, and writes each surviving block: at B = 32768, 854 MB
// with kPrecomp's 35 flagged cycles and PS = 11 (0.25 ms at 3.35 TB/s),
// 95 MB with kEc's one flagged cycle and PS = 12 (0.03 ms; there the two
// launches' latency is of the same order).

#include "common.cuh"

struct SpliceArgs {
    const int32_t *meta_blk;    // [K, PS, 4, B]
    const int32_t *value_blk;   // [K, PS, 8, B]
    const int32_t *flags_blk;   // [K, PS, B]
    const int32_t *emit;        // [K, B]
    const int32_t *nslots;      // [K, B]
    int32_t *pq_meta;           // [B, cap, 4]
    int32_t *pq_value;          // [B, cap, 8]
    int32_t *pq_flags;          // [B, cap]
    int32_t *pq_count;          // [B]
    int32_t *pq_blocks;         // [B], >= 0
    uint8_t *lane_error;        // [B]
    int32_t *partial;           // [pq_flag_blocks(B), 5]
    int n, ps, cap, batch;
};

#define PQ_MASK_WORDS 4          // n <= 128 cycles
#define PQ_FLAG_LANES 256        // lanes of one pq_flag_kernel block
#define PQ_FLAG_CYCLES 16        // cycles of one pq_flag_kernel block
#define PQ_FLAG_GROUPS (32 * PQ_MASK_WORDS / PQ_FLAG_CYCLES)
#define PQ_TILE 32               // lanes of one pq_move_kernel block
#define PQ_MOVE_THREADS 256
#define PQ_MOVE_SLICES 4         // pq_move_kernel blocks a tile of lanes

// The clock of one launch: the flagged-cycle mask, P = min(pq_blocks), n
// cycles of PS rows into a queue of cap rows.
struct SpliceClock {
    uint32_t mask[PQ_MASK_WORDS];
    int32_t p0;
    int n, ps, cap;
};

HD bool splice_flagged(const SpliceClock &k, int c) {
    return (k.mask[c >> 5] >> (c & 31)) & 1u;
}

// pos(c): P plus the flagged cycles before c
HD int64_t splice_pos(const SpliceClock &k, int c) {
    int64_t before = 0;
    for (int w = 0; w < PQ_MASK_WORDS; w++) {
        const int lo = w * 32;
        const uint32_t m = c >= lo + 32 ? k.mask[w]
            : (c > lo ? k.mask[w] & ((1u << (c - lo)) - 1u) : 0u);
#ifdef __CUDA_ARCH__
        before += __popc(m);
#else
        before += __builtin_popcount(m);
#endif
    }
    return k.p0 + before;
}

HD bool splice_overflow(const SpliceClock &k, int c) {
    return splice_pos(k, c) * k.ps > (int64_t)(k.cap - k.ps);
}

HD int64_t splice_base(const SpliceClock &k, int c) {
    const int64_t at = splice_pos(k, c) * k.ps, last = k.cap - k.ps;
    return at < last ? at : last;
}

// whether cycle c's rows are the ones written at its base: no later cycle
// shares it (the base does not decrease with c)
HD bool splice_last(const SpliceClock &k, int c) {
    return c == k.n - 1 || splice_base(k, c + 1) != splice_base(k, c);
}

// the rows of cycle c's block that are written: PS, but where the clamped
// block at cap - PS overlaps this one (cap - PS no multiple of PS), only
// those below it, so that the later block's rows win whatever the order
// of the writes
HD int splice_rows_written(const SpliceClock &k, int c) {
    if (c == k.n - 1) return k.ps;
    const int64_t gap = splice_base(k, c + 1) - splice_base(k, c);
    return gap < k.ps ? (int)gap : k.ps;
}

HD int splice_flagged_count(const SpliceClock &k) {
    int f = 0;
    for (int c = 0; c < k.n; c++) f += splice_flagged(k, c);
    return f;
}

// the clock from the partials of the flag blocks (5 words each: the four
// masks, the min), those of blocks i0, i0 + step, ..
HD SpliceClock splice_clock(const SpliceArgs &a, int blocks, int i0,
                            int step) {
    SpliceClock k;
    for (int w = 0; w < PQ_MASK_WORDS; w++) k.mask[w] = 0;
    k.p0 = 0x7fffffff;
    for (int i = i0; i < blocks; i += step) {
        for (int w = 0; w < PQ_MASK_WORDS; w++)
            k.mask[w] |= (uint32_t)a.partial[i * 5 + w];
        const int32_t m = a.partial[i * 5 + 4];
        k.p0 = m < k.p0 ? m : k.p0;
    }
    k.n = a.n;
    k.ps = a.ps;
    k.cap = a.cap;
    return k;
}

// lane b's pq_count credit and lane_error over cycles c0, c0 + step, ..
HD void splice_lane_part(const SpliceArgs &a, const SpliceClock &k, int b,
                         int c0, int step, int32_t *count, bool *err) {
    const uint64_t B = a.batch;
#ifdef __CUDA_ARCH__
#pragma unroll 4
#endif
    for (int c = c0; c < k.n; c += step) {
        if (!splice_overflow(k, c)) *count += a.nslots[c * B + b];
        else if (splice_flagged(k, c)) *err |= a.emit[c * B + b] != 0;
    }
}

HD void splice_lane_store(const SpliceArgs &a, const SpliceClock &k, int b,
                          int32_t count, bool err) {
    a.pq_count[b] += count;
    if (err) a.lane_error[b] = 1;
    a.pq_blocks[b] += splice_flagged_count(k);
}

// the flag kernel's blocks: the partials a launch writes
static int pq_flag_blocks(int batch) {
    return (batch + PQ_FLAG_LANES - 1) / PQ_FLAG_LANES * PQ_FLAG_GROUPS;
}

extern "C" int eravm_pq_splice_partials(int batch) {
    return pq_flag_blocks(batch);
}

#ifdef __CUDACC__
// block (x, y): lanes x * 256 .. of cycles y * 16 .. (a grid of 8 cycle
// groups, so that each thread has 16 loads of emit in flight, not n in a
// row); partial x + y * gridDim.x
__global__ void __launch_bounds__(PQ_FLAG_LANES) pq_flag_kernel(
        const SpliceArgs a) {
    __shared__ uint32_t red[PQ_FLAG_LANES / 32][PQ_MASK_WORDS + 1];
    const int b = blockIdx.x * PQ_FLAG_LANES + threadIdx.x;
    const bool in = b < a.batch;
    const int c0 = blockIdx.y * PQ_FLAG_CYCLES;
    uint32_t bits = 0;                  // bit i: cycle c0 + i emitted
#pragma unroll
    for (int i = 0; i < PQ_FLAG_CYCLES; i++)
        if (in && c0 + i < a.n && a.emit[(uint64_t)(c0 + i) * a.batch + b])
            bits |= 1u << i;
    uint32_t mask[PQ_MASK_WORDS];
#pragma unroll
    for (int w = 0; w < PQ_MASK_WORDS; w++)
        mask[w] = (c0 >> 5) == w ? bits << (c0 & 31) : 0u;
    int32_t m = in && blockIdx.y == 0 ? a.pq_blocks[b] : 0x7fffffff;
    for (int w = 0; w < PQ_MASK_WORDS; w++)
        mask[w] = __reduce_or_sync(0xffffffffu, mask[w]);
    m = __reduce_min_sync(0xffffffffu, m);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        for (int w = 0; w < PQ_MASK_WORDS; w++) red[warp][w] = mask[w];
        red[warp][PQ_MASK_WORDS] = (uint32_t)m;
    }
    __syncthreads();
    if (threadIdx.x < PQ_MASK_WORDS + 1) {
        const int w = threadIdx.x;
        uint32_t v = w < PQ_MASK_WORDS ? 0u : 0x7fffffffu;
        for (int i = 0; i < PQ_FLAG_LANES / 32; i++) {
            const uint32_t x = red[i][w];
            v = w < PQ_MASK_WORDS ? v | x
                : ((int32_t)x < (int32_t)v ? x : v);
        }
        a.partial[(blockIdx.y * gridDim.x + blockIdx.x) * 5 + w] = (int32_t)v;
    }
}

// block (x, y): a tile of PQ_TILE lanes and the surviving blocks of cycles
// c = y, y + PQ_MOVE_SLICES, ..: each block's rows through shared memory
// (meta, value and flags: 13 PS words a lane); then, in slice 0, the lane
// scalars.  Each cycle's base, overflow and survival come once a block
// from the clock, into a table in shared memory.
__global__ void __launch_bounds__(PQ_MOVE_THREADS) pq_move_kernel(
        const SpliceArgs a, int flag_blocks) {
    extern __shared__ int32_t tile[];     // [13 PS][PQ_TILE + 1]
    constexpr int WARPS = PQ_MOVE_THREADS / 32;
    constexpr int CYCLES = 32 * PQ_MASK_WORDS;
    __shared__ SpliceClock part[WARPS];
    __shared__ int32_t counts[WARPS][PQ_TILE];
    __shared__ bool errs[WARPS][PQ_TILE];
    __shared__ bool keep[PQ_TILE];
    __shared__ int32_t cyc_base[CYCLES], cyc_rows[CYCLES];  // rows: 0 = none
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // every thread combines a stride of the partials, then the warps
    SpliceClock k = splice_clock(a, flag_blocks, threadIdx.x,
                                 PQ_MOVE_THREADS);
    for (int w = 0; w < PQ_MASK_WORDS; w++)
        k.mask[w] = __reduce_or_sync(0xffffffffu, k.mask[w]);
    k.p0 = __reduce_min_sync(0xffffffffu, k.p0);
    if (lane == 0) part[warp] = k;
    __syncthreads();
    for (int i = 0; i < WARPS; i++) {
        for (int w = 0; w < PQ_MASK_WORDS; w++) k.mask[w] |= part[i].mask[w];
        k.p0 = part[i].p0 < k.p0 ? part[i].p0 : k.p0;
    }
    static_assert(PQ_MOVE_THREADS >= CYCLES, "a thread a cycle");
    const int c_own = threadIdx.x;
    if (c_own < k.n) {
        cyc_base[c_own] = (int32_t)splice_base(k, c_own);
        // the rows it writes where it survives, with the overflow in the
        // sign: keep the rows of its emitting lanes only where positive
        cyc_rows[c_own] = !splice_last(k, c_own) ? 0
            : (splice_overflow(k, c_own) || !splice_flagged(k, c_own)
               ? -splice_rows_written(k, c_own)
               : splice_rows_written(k, c_own));
    }
    __syncthreads();
    const int b0 = blockIdx.x * PQ_TILE;
    const int lanes = a.batch - b0 < PQ_TILE ? a.batch - b0 : PQ_TILE;
    const uint64_t B = a.batch;
    const int ps = k.ps;
    const int row_words = 13 * ps;        // meta 4 PS, value 8 PS, flags PS
    static_assert(PQ_TILE == 32, "a warp's threads are the tile's lanes");
    for (int c = blockIdx.y; c < k.n; c += gridDim.y) {
        const int rows = cyc_rows[c];
        if (rows == 0) continue;                      // uniform in the block
        const int n_rows = rows < 0 ? -rows : rows;
        const uint64_t base = (uint64_t)cyc_base[c];
        if (threadIdx.x < PQ_TILE)
            keep[threadIdx.x] = threadIdx.x < lanes && rows > 0
                && a.emit[c * B + b0 + threadIdx.x] != 0;
        __syncthreads();
        // load: warp w takes rows j = w, w + 8, .. of the tile's words (a
        // row of the scratch is contiguous over lanes), thread l lane l
        for (int j = warp; j < row_words; j += WARPS) {
            const int32_t *src = j < 4 * ps
                ? a.meta_blk + ((uint64_t)c * ps * 4 + j) * B
                : j < 12 * ps
                ? a.value_blk + ((uint64_t)c * ps * 8 + j - 4 * ps) * B
                : a.flags_blk + ((uint64_t)c * ps + j - 12 * ps) * B;
            tile[j * (PQ_TILE + 1) + lane] = keep[lane] ? src[b0 + lane] : 0;
        }
        __syncthreads();
        // store: warp w takes lanes l = w, w + 8, ..; each array's rows of
        // a lane are contiguous in the queue, thread i its words i, i + 32
        for (int l = warp; l < lanes; l += WARPS) {
            const uint64_t row = (b0 + l) * (uint64_t)a.cap + base;
            const int32_t *t = tile + l;
            for (int j = lane; j < 4 * n_rows; j += 32)
                a.pq_meta[row * 4 + j] = t[j * (PQ_TILE + 1)];
            for (int j = lane; j < 8 * n_rows; j += 32)
                a.pq_value[row * 8 + j] = t[(4 * ps + j) * (PQ_TILE + 1)];
            for (int j = lane; j < n_rows; j += 32)
                a.pq_flags[row + j] = t[(12 * ps + j) * (PQ_TILE + 1)];
        }
        __syncthreads();
    }
    if (blockIdx.y != 0) return;
    // the lane scalars: warp w takes cycles w, w + 8, .. of the tile's lanes
    int32_t count = 0;
    bool err = false;
    if (lane < lanes)
        splice_lane_part(a, k, b0 + lane, warp, WARPS, &count, &err);
    counts[warp][lane] = count;
    errs[warp][lane] = err;
    __syncthreads();
    if (threadIdx.x < lanes) {
        for (int i = 1; i < WARPS; i++) {
            count += counts[i][lane];
            err |= errs[i][lane];
        }
        splice_lane_store(a, k, b0 + lane, count, err);
    }
}

extern "C" int eravm_pq_splice_launch(const SpliceArgs *args, void *stream) {
    const SpliceArgs &a = *args;
    if (a.n <= 0 || a.batch <= 0) return 0;
    if (a.n > 32 * PQ_MASK_WORDS || a.ps <= 0 || a.cap < a.ps)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int fb = pq_flag_blocks(a.batch);
    pq_flag_kernel<<<dim3(fb / PQ_FLAG_GROUPS, PQ_FLAG_GROUPS), PQ_FLAG_LANES,
                     0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int smem = 13 * a.ps * (PQ_TILE + 1) * (int)sizeof(int32_t);
    e = cudaFuncSetAttribute(pq_move_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    pq_move_kernel<<<dim3((a.batch + PQ_TILE - 1) / PQ_TILE, PQ_MOVE_SLICES),
                     PQ_MOVE_THREADS, smem, s>>>(a, fb);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
