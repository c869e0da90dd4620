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
// The contract with K1: K1 stores only the rows of a block that carry data,
// which its emit word names (PQ_EMIT in common.cuh: the mem_in rows 0 ..
// n_in - 1 and the mem_out rows PS_IN .. PS_IN + n_out - 1); the scratch's
// other rows hold whatever was there.  The splice reads only the data rows
// and writes zeros for the others.
//
// Design.  The surviving blocks (one a distinct base) tile one contiguous
// range of rows, [base(0), base(n - 1) + PS): consecutive bases differ by
// PS except where the last is clamped at cap - PS, and a block is written
// only below the next one's base (so the clamped block wins, as the
// sequential engine's later write does).  So each lane's part of the queue
// that a splice writes is one contiguous run in each of pq_meta [B, cap,
// 4], pq_value [B, cap, 8] and pq_flags [B, cap], and row r of the range
// takes row i of the block of one cycle c: the table's row map.
//  * pq_flag_kernel reads emit once (int32[n, B], batch-last: coalesced),
//    a block 256 lanes of 16 cycles, and writes the OR of its lanes'
//    per-cycle flags (n <= 128 cycles: four 32-bit masks) and the min of
//    their pq_blocks into a partial a block.  The last block to finish (a
//    ticket from a counter that wraps to 0 by itself) folds the partials
//    once and writes the table: the range's first row and length, the
//    flagged count, each cycle's overflow and the row map.
//  * pq_move_kernel: a block (256 threads) a tile of 32 lanes walks that
//    tile's range in steps of PQ_CHUNK rows.  The scratch is batch-last
//    ([K, PS, ., B]: a warp reads 128 contiguous bytes of one row word) and
//    the queue lane-major, so each step goes through shared memory: a warp
//    a row, cp.async copies its 13 words (4 bytes a thread, a zero fill
//    without a read where the row carries no data or the lane keeps
//    nothing), and the next step's copies are issued before this step's
//    stores, 16-byte stores of each lane's contiguous meta and value runs
//    (flags: 4-byte words, their rows only 4-byte aligned).  The tile's
//    emit words (zero where the cycle overflowed) and the row map stay in
//    shared memory for the whole walk (49 KB a block at n = 128, PS = 11:
//    four blocks an SM); the lane scalars (pq_count, lane_error,
//    pq_blocks) come from the same pass over emit and nslots.
// What bounds it on an H100: bytes.  It must read emit and nslots (2 n B
// int32) and the data rows of the lanes that keep them, and write the rows
// the surviving blocks cover: at B = 32768 with kPrecomp's 35 flagged
// cycles and PS = 11, 752 MB, 675 MB of them written (0.225 ms at 3.35
// TB/s; measured 0.40 ms, the stores alone 0.28: PERF.md); with kEc's one
// flagged cycle and PS = 12, 85 MB (0.025 ms; measured 0.064, where the
// two launches' latency is of the same order).

#include "common.cuh"

struct SpliceArgs {
    const int32_t *meta_blk;    // [K, PS, 4, B]
    const int32_t *value_blk;   // [K, PS, 8, B]
    const int32_t *flags_blk;   // [K, PS, B]
    const int32_t *emit;        // [K, B], PQ_EMIT words
    const int32_t *nslots;      // [K, B]
    int32_t *pq_meta;           // [B, cap, 4]
    int32_t *pq_value;          // [B, cap, 8]
    int32_t *pq_flags;          // [B, cap]
    int32_t *pq_count;          // [B]
    int32_t *pq_blocks;         // [B], >= 0
    uint8_t *lane_error;        // [B]
    int32_t *scratch;           // [eravm_pq_splice_scratch(B, n, PS)]
    int n, ps, ps_in, cap, batch;
};

#define PQ_MASK_WORDS 4          // n <= 128 cycles
#define PQ_MAX_CYCLES (32 * PQ_MASK_WORDS)
#define PQ_FLAG_LANES 256        // lanes of one pq_flag_kernel block
#define PQ_FLAG_CYCLES 16        // cycles of one pq_flag_kernel block
#define PQ_FLAG_GROUPS (PQ_MAX_CYCLES / PQ_FLAG_CYCLES)
#define PQ_ROW_WORDS 13          // a row's words: meta 4, value 8, flags 1
#define PQ_TILE 32               // lanes of one pq_move_kernel block
#define PQ_CHUNK 8               // rows of one pq_move_kernel step
#define PQ_MOVE_THREADS 256
#define PQ_PAD (PQ_TILE + 1)     // a tile row's stride in shared memory

// The table a launch's last flag block writes (after the partials):
// [0] the range's first row R0, [1] its length, [2] the flagged cycles,
// [4 + c] whether cycle c overflowed, [PQ_TABLE_MAP + j] the row map:
// (c << 16) | i for row R0 + j, row i of cycle c's block.
#define PQ_TABLE_MAP (4 + PQ_MAX_CYCLES)

// The clock of one launch: the flagged-cycle mask, P = min(pq_blocks), n
// cycles of PS rows into a queue of cap rows.
struct SpliceClock {
    uint32_t mask[PQ_MASK_WORDS];
    int32_t p0;
    int n, ps, cap;
};

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
// those below it
HD int splice_rows_written(const SpliceClock &k, int c) {
    if (c == k.n - 1) return k.ps;
    const int64_t gap = splice_base(k, c + 1) - splice_base(k, c);
    return gap < k.ps ? (int)gap : k.ps;
}

// the clock from the partials of the flag blocks (5 words each: the four
// masks, the min), those of blocks i0, i0 + step, ..
HD SpliceClock splice_clock(const SpliceArgs &a, const int32_t *partial,
                            int blocks, int i0, int step) {
    SpliceClock k;
    for (int w = 0; w < PQ_MASK_WORDS; w++) k.mask[w] = 0;
    k.p0 = 0x7fffffff;
    for (int i = i0; i < blocks; i += step) {
        for (int w = 0; w < PQ_MASK_WORDS; w++)
            k.mask[w] |= (uint32_t)partial[i * 5 + w];
        const int32_t m = partial[i * 5 + 4];
        k.p0 = m < k.p0 ? m : k.p0;
    }
    k.n = a.n;
    k.ps = a.ps;
    k.cap = a.cap;
    return k;
}

// cycle c's part of the table: its overflow and, where its rows survive,
// its rows of the row map; with c == 0 also the header
HD void splice_table_cycle(const SpliceClock &k, int c, int32_t *table) {
    table[4 + c] = splice_overflow(k, c);
    const int64_t r0 = splice_base(k, 0);
    if (c == 0) {
        int f = 0;
        for (int w = 0; w < PQ_MASK_WORDS; w++)
#ifdef __CUDA_ARCH__
            f += __popc(k.mask[w]);
#else
            f += __builtin_popcount(k.mask[w]);
#endif
        table[0] = (int32_t)r0;
        table[1] = (int32_t)(splice_base(k, k.n - 1) + k.ps - r0);
        table[2] = f;
    }
    if (!splice_last(k, c)) return;
    int32_t *map = table + PQ_TABLE_MAP + (splice_base(k, c) - r0);
    for (int i = 0; i < splice_rows_written(k, c); i++) map[i] = (c << 16) | i;
}

// word w (meta 0-3, value 4-11, flags 12) of row i of cycle c's block, of
// lane b, in the scratch (a row word's lanes are contiguous: word w + q of
// meta or value is q B words further)
HD const int32_t *splice_src(const SpliceArgs &a, int c, int i, int w,
                             uint64_t b) {
    const uint64_t B = a.batch, row = (uint64_t)c * a.ps + i;
    return w < 4 ? a.meta_blk + (row * 4 + w) * B + b
        : w < 12 ? a.value_blk + (row * 8 + w - 4) * B + b
        : a.flags_blk + row * B + b;
}

// lane b's emit word in cycle c as the move reads it (0 where the cycle
// overflowed), with its pq_count credit and lane_error
HD int32_t splice_lane_cycle(const SpliceArgs &a, const int32_t *table, int c,
                             uint64_t b, int32_t *count, bool *err) {
    const uint64_t i = (uint64_t)c * a.batch + b;
    const int32_t e = a.emit[i];
    if (table[4 + c]) {
        *err |= e != 0;
        return 0;
    }
    *count += a.nslots[i];
    return e;
}

// the flag kernel's blocks: the partials a launch writes
static int pq_flag_blocks(int batch) {
    return (batch + PQ_FLAG_LANES - 1) / PQ_FLAG_LANES * PQ_FLAG_GROUPS;
}

// the scratch a launch takes (int32 words): the partials, then the table
extern "C" int eravm_pq_splice_scratch(int batch, int n, int ps) {
    return pq_flag_blocks(batch) * 5 + PQ_TABLE_MAP + n * ps;
}

#ifdef __CUDACC__
// the flag kernel's tickets: each block takes one when its partial is out,
// and the last of a launch finds the counter at gridDim - 1, which wraps it
// to 0 for the next launch (launches of the splice on one device are
// stream-ordered)
__device__ unsigned int pq_flag_ticket;

// block (x, y): lanes x * 256 .. of cycles y * 16 .. (a grid of 8 cycle
// groups, so that each thread has 16 loads of emit in flight, not n in a
// row); partial x + y * gridDim.x; then, in the launch's last block, the
// table
__global__ void __launch_bounds__(PQ_FLAG_LANES) pq_flag_kernel(
        const SpliceArgs a) {
    __shared__ uint32_t red[PQ_FLAG_LANES / 32][PQ_MASK_WORDS + 1];
    __shared__ bool last;
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
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
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
        a.scratch[(blockIdx.y * gridDim.x + blockIdx.x) * 5 + w] = (int32_t)v;
        __threadfence();
    }
    __syncthreads();
    const unsigned blocks = gridDim.x * gridDim.y;
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicInc(&pq_flag_ticket, blocks - 1) == blocks - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the last block: every thread folds a stride of the partials (read
    // past L1: other SMs wrote them), then the warps
    __shared__ SpliceClock part[PQ_FLAG_LANES / 32];
    SpliceClock k;
    for (int w = 0; w < PQ_MASK_WORDS; w++) k.mask[w] = 0;
    k.p0 = 0x7fffffff;
    for (int i = threadIdx.x; i < (int)blocks; i += PQ_FLAG_LANES) {
        for (int w = 0; w < PQ_MASK_WORDS; w++)
            k.mask[w] |= (uint32_t)__ldcg(a.scratch + i * 5 + w);
        const int32_t x = __ldcg(a.scratch + i * 5 + 4);
        k.p0 = x < k.p0 ? x : k.p0;
    }
    for (int w = 0; w < PQ_MASK_WORDS; w++)
        k.mask[w] = __reduce_or_sync(0xffffffffu, k.mask[w]);
    k.p0 = __reduce_min_sync(0xffffffffu, k.p0);
    if (lane == 0) part[warp] = k;
    __syncthreads();
    for (int i = 0; i < PQ_FLAG_LANES / 32; i++) {
        for (int w = 0; w < PQ_MASK_WORDS; w++) k.mask[w] |= part[i].mask[w];
        k.p0 = part[i].p0 < k.p0 ? part[i].p0 : k.p0;
    }
    k.n = a.n;
    k.ps = a.ps;
    k.cap = a.cap;
    static_assert(PQ_FLAG_LANES >= PQ_MAX_CYCLES, "a thread a cycle");
    if ((int)threadIdx.x < a.n)
        splice_table_cycle(k, threadIdx.x, a.scratch + blocks * 5);
}

__device__ __forceinline__ void cp_async4(void *dst, const void *src,
                                          bool read) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(read ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one step's words into a tile buffer [PQ_CHUNK rows][13 words][PQ_PAD]:
// rows j0 .. j0 + rows - 1 of the range, warp w rows w, w + 8, .. and
// thread l lane l of each (the row's block, its lane's emit word and the
// source addresses once a row, then its 13 words)
__device__ __forceinline__ void pq_move_issue(
        const SpliceArgs &a, const int32_t *emitk, const int32_t *map,
        int32_t *buf, int b0, int j0, int rows) {
    static_assert(PQ_TILE == 32, "a warp's threads are the tile's lanes");
    constexpr int WARPS = PQ_MOVE_THREADS / 32;
    const int l = threadIdx.x & 31;
    const uint64_t B = a.batch, b = b0 + l < a.batch ? b0 + l : a.batch - 1;
    for (int r = threadIdx.x >> 5; r < rows; r += WARPS) {
        const int32_t m = map[j0 + r];
        const int c = m >> 16, i = m & 0xffff;
        const bool d = pq_data_row(emitk[c * PQ_TILE + l], i, a.ps_in);
        int32_t *dst = buf + r * PQ_ROW_WORDS * PQ_PAD + l;
        const int32_t *meta = splice_src(a, c, i, 0, b);
        const int32_t *value = splice_src(a, c, i, 4, b);
#pragma unroll
        for (int q = 0; q < 4; q++)
            cp_async4(dst + q * PQ_PAD, meta + q * B, d);
#pragma unroll
        for (int q = 0; q < 8; q++)
            cp_async4(dst + (4 + q) * PQ_PAD, value + q * B, d);
        cp_async4(dst + 12 * PQ_PAD, splice_src(a, c, i, 12, b), d);
    }
}

// the step's rows from the tile buffer to the queue: each lane's meta and
// value rows as 16-byte words, its flags as 4-byte words
__device__ __forceinline__ void pq_move_store(
        const SpliceArgs &a, const int32_t *buf, int b0, int lanes,
        uint64_t row0, int rows) {
    for (int x = threadIdx.x; x < PQ_TILE * PQ_CHUNK; x += PQ_MOVE_THREADS) {
        const int l = x / PQ_CHUNK, r = x % PQ_CHUNK;
        if (l >= lanes || r >= rows) continue;
        const uint64_t row = (uint64_t)(b0 + l) * a.cap + row0 + r;
        const int32_t *t = buf + r * PQ_ROW_WORDS * PQ_PAD + l;
        ((int4 *)a.pq_meta)[row] = make_int4(t[0], t[PQ_PAD], t[2 * PQ_PAD],
                                             t[3 * PQ_PAD]);
        a.pq_flags[row] = t[12 * PQ_PAD];
    }
    for (int x = threadIdx.x; x < 2 * PQ_TILE * PQ_CHUNK;
         x += PQ_MOVE_THREADS) {
        const int l = x / (2 * PQ_CHUNK), r = x % (2 * PQ_CHUNK) / 2,
                  h = x % 2;
        if (l >= lanes || r >= rows) continue;
        const uint64_t row = (uint64_t)(b0 + l) * a.cap + row0 + r;
        const int32_t *t = buf + (r * PQ_ROW_WORDS + 4 + 4 * h) * PQ_PAD + l;
        ((int4 *)a.pq_value)[row * 2 + h] = make_int4(
            t[0], t[PQ_PAD], t[2 * PQ_PAD], t[3 * PQ_PAD]);
    }
}

// the shared memory of a pq_move_kernel block: the tile's emit words (n x
// PQ_TILE), the row map (n PS at most), two step buffers
static int pq_move_smem(int n, int ps) {
    return (n * PQ_TILE + n * ps
            + 2 * PQ_CHUNK * PQ_ROW_WORDS * PQ_PAD) * (int)sizeof(int32_t);
}

// block x: lanes x * PQ_TILE .. and the whole range the splice writes
__global__ void __launch_bounds__(PQ_MOVE_THREADS) pq_move_kernel(
        const SpliceArgs a, int flag_blocks) {
    extern __shared__ int32_t smem[];
    __shared__ int32_t counts[PQ_MOVE_THREADS];
    __shared__ bool errs[PQ_MOVE_THREADS];
    const int32_t *table = a.scratch + flag_blocks * 5;
    const int r0 = table[0], n_rows = table[1];
    int32_t *emitk = smem;                       // [n][PQ_TILE]
    int32_t *map = emitk + a.n * PQ_TILE;        // [n_rows]
    int32_t *bufs = map + a.n * a.ps;            // [2][PQ_CHUNK * 13 * PAD]
    constexpr int BUF = PQ_CHUNK * PQ_ROW_WORDS * PQ_PAD;
    const int b0 = blockIdx.x * PQ_TILE;
    const int lanes = a.batch - b0 < PQ_TILE ? a.batch - b0 : PQ_TILE;
    // the tile's emit words, counts and errors: thread t lane t % PQ_TILE,
    // cycles t / PQ_TILE, .. (a warp reads a row of emit and nslots)
    const int l = threadIdx.x % PQ_TILE;
    int32_t count = 0;
    bool err = false;
    for (int c = threadIdx.x / PQ_TILE; c < a.n;
         c += PQ_MOVE_THREADS / PQ_TILE)
        emitk[c * PQ_TILE + l] = l < lanes
            ? splice_lane_cycle(a, table, c, b0 + l, &count, &err) : 0;
    counts[threadIdx.x] = count;
    errs[threadIdx.x] = err;
    for (int j = threadIdx.x; j < n_rows; j += PQ_MOVE_THREADS)
        map[j] = table[PQ_TABLE_MAP + j];
    __syncthreads();
    if ((int)threadIdx.x < lanes) {
        for (int i = threadIdx.x + PQ_TILE; i < PQ_MOVE_THREADS;
             i += PQ_TILE) {
            count += counts[i];
            err |= errs[i];
        }
        const int b = b0 + threadIdx.x;
        a.pq_count[b] += count;
        if (err) a.lane_error[b] = 1;
        a.pq_blocks[b] += table[2];
    }
    // the walk: step s + 1's copies in flight during step s's stores
    const int steps = (n_rows + PQ_CHUNK - 1) / PQ_CHUNK;
    pq_move_issue(a, emitk, map, bufs, b0, 0,
                  n_rows < PQ_CHUNK ? n_rows : PQ_CHUNK);
    cp_async_commit();
    for (int s = 0; s < steps; s++) {
        const int j0 = s * PQ_CHUNK;
        if (s + 1 < steps) {
            const int left = n_rows - j0 - PQ_CHUNK;
            pq_move_issue(a, emitk, map, bufs + ((s + 1) & 1) * BUF, b0,
                          j0 + PQ_CHUNK, left < PQ_CHUNK ? left : PQ_CHUNK);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int left = n_rows - j0;
        pq_move_store(a, bufs + (s & 1) * BUF, b0, lanes,
                      (uint64_t)r0 + j0, left < PQ_CHUNK ? left : PQ_CHUNK);
        __syncthreads();
    }
}

extern "C" int eravm_pq_splice_launch(const SpliceArgs *args, void *stream) {
    const SpliceArgs &a = *args;
    if (a.n <= 0 || a.batch <= 0) return 0;
    if (a.n > PQ_MAX_CYCLES || a.ps <= 0 || a.ps_in <= 0 || a.ps_in >= a.ps
            || a.ps >= 0x10000 || a.cap < a.ps
            || (uintptr_t)a.pq_meta % 16 || (uintptr_t)a.pq_value % 16)
        return (int)cudaErrorInvalidValue;
    // the shared-memory attribute once a device: the most any launch takes
    static bool sized[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const int smem = pq_move_smem(a.n, a.ps);
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!sized[dev]) {
        int most = 0;
        cudaFuncAttributes fa;
        e = cudaDeviceGetAttribute(&most,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, pq_move_kernel);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                pq_move_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                most - (int)fa.sharedSizeBytes);
        if (e != cudaSuccess) return (int)e;
        sized[dev] = true;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const int fb = pq_flag_blocks(a.batch);
    pq_flag_kernel<<<dim3(fb / PQ_FLAG_GROUPS, PQ_FLAG_GROUPS), PQ_FLAG_LANES,
                     0, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    pq_move_kernel<<<(a.batch + PQ_TILE - 1) / PQ_TILE, PQ_MOVE_THREADS,
                     smem, s>>>(a, fb);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
