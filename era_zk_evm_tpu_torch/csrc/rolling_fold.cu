// K2: the rolling memory-queue commitment fold, one thread per lane
// (CUDA C++, sm_90a).
//
// Replaces the TPU kernels era_zk_evm_tpu/models/fused_cycle.py::
// _rolling_fold_bitsliced (a mask kernel and a bit-sliced fold kernel) and
// its u32-pair fallback _rolling_fold_call: both fold one chunk's valid
// memory-query slots into each lane's keccak sponge under spec v2 (record
// 2i XORed into u64 lanes 0..7, record 2i+1 into lanes 8..15, then one
// permutation).  Its plain version is
// era_zk_evm_tpu_torch/witness/rolling.py::rolling_absorb.
//
// Design.  The TPU needed bit-planes (32 sponges per u32 word) and a
// separate mask pass to keep its vector unit busy; here a thread holds its
// lane's 25 x u64 sponge in registers, walks the chunk's slot block
// ([rows, ., B], batch-last, so each row's loads coalesce across the warp) in
// slot order, serialises each valid record as the JAX engine does
// (models/batched_vm.py rolling block) and permutes on each odd record.
// What bounds it on an H100: about 24 x 25 x ~10 integer ops per two
// records, so it is ALU-bound while the lanes run in step; lanes whose
// records fall at different slots diverge within a warp.

#include "common.cuh"
#include "keccak.cuh"

HD uint32_t bswap32(uint32_t x) {
    return ((x & 0xFFu) << 24) | ((x & 0xFF00u) << 8) | ((x >> 8) & 0xFF00u) |
           (x >> 24);
}

HD void k2_run_lane(const int32_t *meta, const int32_t *value,
                    const int32_t *flags, int32_t *wc_state, int32_t *wc_count,
                    int n_rows, int batch, int b) {
    const uint64_t B = batch;
    uint64_t st[25];
    for (int k = 0; k < 25; k++)
        st[k] = (uint64_t)(uint32_t)wc_state[((uint64_t)b * 25 + k) * 2] |
                ((uint64_t)(uint32_t)wc_state[((uint64_t)b * 25 + k) * 2 + 1] << 32);
    uint32_t count = (uint32_t)wc_count[b];
    for (int s = 0; s < n_rows; s++) {
        const uint32_t fl = (uint32_t)flags[(uint64_t)s * B + b];
        if (!(fl & 4)) continue;
        const uint32_t ts = meta[((uint64_t)s * 4 + 0) * B + b];
        const uint32_t type = meta[((uint64_t)s * 4 + 1) * B + b];
        const uint32_t page = meta[((uint64_t)s * 4 + 2) * B + b];
        const uint32_t idx = meta[((uint64_t)s * 4 + 3) * B + b];
        uint64_t rec[8];
        rec[0] = (uint64_t)bswap32(ts) |
                 ((uint64_t)((type & 0xFF) | (((page >> 24) & 0xFF) << 8) |
                             (((page >> 16) & 0xFF) << 16) |
                             (((page >> 8) & 0xFF) << 24)) << 32);
        rec[1] = (uint64_t)((page & 0xFF) | (((idx >> 24) & 0xFF) << 8) |
                            (((idx >> 16) & 0xFF) << 16) |
                            (((idx >> 8) & 0xFF) << 24)) |
                 ((uint64_t)((idx & 0xFF) | ((fl & 3) << 8)) << 32);
        rec[2] = rec[3] = 0;
        for (int k = 0; k < 4; k++) {
            const uint32_t lo = value[((uint64_t)s * 8 + 7 - 2 * k) * B + b];
            const uint32_t hi = value[((uint64_t)s * 8 + 6 - 2 * k) * B + b];
            rec[4 + k] = (uint64_t)bswap32(lo) | ((uint64_t)bswap32(hi) << 32);
        }
        if (count & 1) {
            for (int k = 0; k < 8; k++) st[8 + k] ^= rec[k];
            keccak_f1600(st);
        } else {
            for (int k = 0; k < 8; k++) st[k] ^= rec[k];
        }
        count++;
    }
    for (int k = 0; k < 25; k++) {
        wc_state[((uint64_t)b * 25 + k) * 2] = (int32_t)(uint32_t)st[k];
        wc_state[((uint64_t)b * 25 + k) * 2 + 1] = (int32_t)(uint32_t)(st[k] >> 32);
    }
    wc_count[b] = (int32_t)count;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) k2_kernel(
        const int32_t *meta, const int32_t *value, const int32_t *flags,
        int32_t *wc_state, int32_t *wc_count, int n_rows, int batch) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < batch) k2_run_lane(meta, value, flags, wc_state, wc_count, n_rows, batch, b);
}

extern "C" int eravm_k2_launch(const void *meta, const void *value,
                               const void *flags, void *wc_state,
                               void *wc_count, int n_rows, int batch,
                               void *stream) {
    const int threads = 128;
    const int blocks = (batch + threads - 1) / threads;
    k2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t *)meta, (const int32_t *)value, (const int32_t *)flags,
        (int32_t *)wc_state, (int32_t *)wc_count, n_rows, batch);
    return (int)cudaGetLastError();
}
#endif
