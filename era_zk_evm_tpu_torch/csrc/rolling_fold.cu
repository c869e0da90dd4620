// K2: the rolling memory-queue commitment fold, one thread per lane
// (CUDA C++, sm_90a).
//
// Replaces the TPU kernels era_zk_evm_tpu/models/fused_cycle.py::
// _rolling_fold_bitsliced (a mask kernel and a bit-sliced fold kernel) and
// its u32-pair fallback _rolling_fold_call: both fold one chunk's valid
// memory-query slots into each lane's keccak sponge under spec v2 (record
// 2i XORed into u64 lanes 0..7, record 2i+1 into lanes 8..15, then one
// permutation).  Its plain version is
// era_zk_evm_tpu_torch/witness/rolling.py::rolling_absorb_rows.
//
// Input.  K1 writes a lane's valid slots compacted (csrc/cycle_kernel.cu,
// emit_block_rows): rows 0 .. count[b] - 1 of the chunk block ([rows, 4,
// B], [rows, 8, B], [rows, B], batch-last, so each row's loads coalesce
// across a warp whose lanes read one row), in cycle-then-slot order; rows
// past the count are never read.  Each row is one record: its flags word
// is rw | ptr << 1 | 4.
//
// Design.  The TPU needed bit-planes (32 sponges per u32 word) and a
// separate mask pass to keep its vector unit busy; here a thread holds its
// lane's 25 x u64 sponge in registers and walks its own rows.  A lane
// whose wc_count is odd first XORs row 0 into lanes 8..15 and permutes;
// then every pair of rows goes into 0..7 and 8..15 and permutes once; a
// trailing row goes into 0..7.  So the lanes of a warp with equal counts
// and parities permute in step, with no branch a slot.  The next pair's
// 26 words are loaded into registers before the current permutation is
// issued, so a load's latency sits under 24 rounds of ALU work.
// What bounds it on an H100: the permutations, ~4320 int32 operations a
// keccak-f against 104 bytes of records read for it (WORKLOAD: 116
// records a lane a 128-cycle chunk, 58 permutations).  It runs at the
// issue rate of keccak.cuh's permutation (immediate rotations, four
// rounds a loop trip); at B = 32768 the lanes are ~8 warps an SM.  The
// block size comes from the SM count, as K1's does.

#include "common.cuh"
#include "keccak.cuh"

HD uint32_t bswap32(uint32_t x) {
    return ((x & 0xFFu) << 24) | ((x & 0xFF00u) << 8) | ((x >> 8) & 0xFF00u) |
           (x >> 24);
}

// one row of the chunk block: meta (ts, type, page, index), the value's 8
// little-endian u32 limbs, the flags word
struct K2Row {
    uint32_t meta[4], value[8], flags;
};

HD void k2_load_row(const int32_t *meta, const int32_t *value,
                    const int32_t *flags, uint64_t B, int b, uint64_t r,
                    K2Row &x) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 4; k++) x.meta[k] = (uint32_t)meta[(r * 4 + k) * B + b];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 8; k++) x.value[k] = (uint32_t)value[(r * 8 + k) * B + b];
    x.flags = (uint32_t)flags[r * B + b];
}

// XOR a row's 64-byte record (era_zk_evm_tpu/witness/commitment.py::
// serialize_memory_query, as eight little-endian u64 lanes; lanes 2 and 3
// are zero) into h[0..7]
HD void k2_absorb(uint64_t *h, const K2Row &x) {
    const uint32_t ts = x.meta[0], type = x.meta[1], page = x.meta[2],
                   idx = x.meta[3];
    h[0] ^= (uint64_t)bswap32(ts) |
            ((uint64_t)((type & 0xFF) | (((page >> 24) & 0xFF) << 8) |
                        (((page >> 16) & 0xFF) << 16) |
                        (((page >> 8) & 0xFF) << 24)) << 32);
    h[1] ^= (uint64_t)((page & 0xFF) | (((idx >> 24) & 0xFF) << 8) |
                       (((idx >> 16) & 0xFF) << 16) |
                       (((idx >> 8) & 0xFF) << 24)) |
            ((uint64_t)((idx & 0xFF) | ((x.flags & 3) << 8)) << 32);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 4; k++)
        h[4 + k] ^= (uint64_t)bswap32(x.value[7 - 2 * k]) |
                    ((uint64_t)bswap32(x.value[6 - 2 * k]) << 32);
}

// lane b: fold rows 0 .. min(count[b], rows) - 1 into its sponge
HD void k2_run_lane(const int32_t *meta, const int32_t *value,
                    const int32_t *flags, const int32_t *count,
                    int32_t *wc_state, int32_t *wc_count, int rows, int batch,
                    int b) {
    const uint64_t B = batch;
    uint64_t st[25];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 25; k++)
        st[k] = (uint64_t)(uint32_t)wc_state[((uint64_t)b * 25 + k) * 2] |
                ((uint64_t)(uint32_t)wc_state[((uint64_t)b * 25 + k) * 2 + 1] << 32);
    const uint32_t c0 = (uint32_t)wc_count[b];
    int n = count[b];
    n = n < 0 ? 0 : (n > rows ? rows : n);
    int r = 0;
    K2Row x, y;                 // rows r and r + 1, loaded ahead
    if (n > 0) k2_load_row(meta, value, flags, B, b, 0, x);
    if ((c0 & 1) && n > 0) {
        // an odd count: row 0 completes the sponge's half-filled block
        k2_absorb(st + 8, x);
        r = 1;
        if (r < n) k2_load_row(meta, value, flags, B, b, r, x);
        if (r + 1 < n) k2_load_row(meta, value, flags, B, b, r + 1, y);
        keccak_f1600(st);
    } else if (n > 1) {
        k2_load_row(meta, value, flags, B, b, 1, y);
    }
    while (r + 1 < n) {
        k2_absorb(st, x);
        k2_absorb(st + 8, y);
        r += 2;
        if (r < n) k2_load_row(meta, value, flags, B, b, r, x);
        if (r + 1 < n) k2_load_row(meta, value, flags, B, b, r + 1, y);
        keccak_f1600(st);
    }
    if (r < n) k2_absorb(st, x);     // a trailing row fills lanes 0..7
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < 25; k++) {
        wc_state[((uint64_t)b * 25 + k) * 2] = (int32_t)(uint32_t)st[k];
        wc_state[((uint64_t)b * 25 + k) * 2 + 1] = (int32_t)(uint32_t)(st[k] >> 32);
    }
    wc_count[b] = (int32_t)(c0 + (uint32_t)n);
}

#ifdef __CUDACC__
#define K2_THREADS 128

__global__ void __launch_bounds__(K2_THREADS) k2_kernel(
        const int32_t *meta, const int32_t *value, const int32_t *flags,
        const int32_t *count, int32_t *wc_state, int32_t *wc_count, int rows,
        int batch) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < batch)
        k2_run_lane(meta, value, flags, count, wc_state, wc_count, rows,
                    batch, b);
}

extern "C" int eravm_k2_launch(const void *meta, const void *value,
                               const void *flags, const void *count,
                               void *wc_state, void *wc_count, int rows,
                               int batch, void *stream) {
    const int threads = sm_block_threads(batch, K2_THREADS);
    const int blocks = (batch + threads - 1) / threads;
    k2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t *)meta, (const int32_t *)value, (const int32_t *)flags,
        (const int32_t *)count, (int32_t *)wc_state, (int32_t *)wc_count,
        rows, batch);
    return (int)cudaGetLastError();
}
#endif
