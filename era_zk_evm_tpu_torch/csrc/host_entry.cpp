// Host (C++) build of the K1 (all four instances), K2 and K3 per-lane
// bodies, of K1's ecrecover unit and of the probes P1-P7, one lane (or
// column) after another.
//
// Not a runtime path: the port's wrappers take the kernels on CUDA tensors
// and the plain torch versions on CPU tensors.  This entry lets the tests
// check the kernels' lane logic against the plain versions on a machine
// without CUDA (tests/test_torch_kernel_host.py).

#include "cycle_kernel.cu"
#include "rolling_fold.cu"
#include "keccak_f.cu"
#include "probe_keccak.cu"
#include "probe_rate.cu"
#include "probe_uniform.cu"
#include "bisect_fold.cu"

extern "C" int eravm_k1_host(const K1Args *a, int ecrecover) {
    // the instance eravm_k1_launch chooses
    for (int b = 0; b < a->batch; b++) {
        if (a->storage_slots > 0 && a->keccak_blocks > 0 && ecrecover)
            k1_run_lane<true, true, true>(*a, b);
        else if (a->storage_slots > 0 && a->keccak_blocks > 0)
            k1_run_lane<true, true>(*a, b);
        else if (a->storage_slots > 0) k1_run_lane<true, false>(*a, b);
        else k1_run_lane<false, false>(*a, b);
    }
    return 0;
}

extern "C" int eravm_k2_host(const void *meta, const void *value,
                             const void *flags, void *wc_state,
                             void *wc_count, int n_rows, int batch) {
    for (int b = 0; b < batch; b++)
        k2_run_lane((const int32_t *)meta, (const int32_t *)value,
                    (const int32_t *)flags, (int32_t *)wc_state,
                    (int32_t *)wc_count, n_rows, batch, b);
    return 0;
}

extern "C" int eravm_k3_host(void *states, int n, int iters) {
    for (int i = 0; i < n; i++) k3_run_state((int32_t *)states, i, iters);
    return 0;
}

// ecrecover_unit on n signatures: digest, r, s, addr int32[n, 8] (u32
// limbs), v and ok int32[n]
extern "C" int eravm_ecrecover_host(const void *digest, const void *v,
                                    const void *r, const void *s, void *ok,
                                    void *addr, int n) {
    for (int i = 0; i < n; i++) {
        U256 out;
        ((int32_t *)ok)[i] = ecrecover_unit(
            load_u256((const int32_t *)digest + 8 * i),
            (uint32_t)((const int32_t *)v)[i],
            load_u256((const int32_t *)r + 8 * i),
            load_u256((const int32_t *)s + 8 * i), &out);
        store_u256((int32_t *)addr + 8 * i, out);
    }
    return 0;
}

// P1 over rows u32[50, B] (batch-last)
extern "C" int eravm_p1_host(void *rows, int B, int iters, int unroll) {
    if (iters % unroll != 0) return 1;
    for (int b = 0; b < B; b++) {
        if (unroll == 1) p1_run_state<1>((uint32_t *)rows, B, b, iters);
        else if (unroll == 2) p1_run_state<2>((uint32_t *)rows, B, b, iters);
        else if (unroll == 4) p1_run_state<4>((uint32_t *)rows, B, b, iters);
        else return 1;
    }
    return 0;
}

// P2 (fused = 0) or P5 (fused = 1) over state, scratch u32[1600, cols]
extern "C" int eravm_p2_host(void *state, void *scratch, int cols, int iters,
                             int fused) {
    uint32_t parity[320];
    for (int c = 0; c < cols; c++) {
        if (fused)
            p2_run_column<true>((uint32_t *)state, (uint32_t *)scratch,
                                parity, 1, cols, c, iters);
        else
            p2_run_column<false>((uint32_t *)state, (uint32_t *)scratch,
                                 parity, 1, cols, c, iters);
    }
    return 0;
}

// P3 over st u32[rows, n]: op 0 xor, 1 mix, 2 andnot; rows 8
extern "C" int eravm_p3_host(void *st, int rows, int n, int steps, int op) {
    for (int i = 0; i < n; i++) {
        uint32_t *p = (uint32_t *)st;
#define P3_CASE(OP, ROWS) \
        if (op == OP && rows == ROWS) { \
            p3_run_column<OP, ROWS>(p, n, i, steps); continue; }
        P3_CASE(kXor, 8) P3_CASE(kMix, 8) P3_CASE(kAndNot, 8)
#undef P3_CASE
        return 1;
    }
    return 0;
}

extern "C" int eravm_p4_host(void *states, int n, int iters) {
    for (int i = 0; i < n; i++) p4_run_state((int32_t *)states, i, iters);
    return 0;
}

// P6: out u32[8, TB] from arena u32[8, W, TB] (or u32[TB, 8, W] when
// lane_major) and idx u32[TB]
extern "C" int eravm_p6_host(const void *arena, const void *idx, void *out,
                             int W, int TB, int reps, int lane_major) {
    for (int k = 0; k < 8; k++)
        for (int t = 0; t < TB; t++)
            ((uint32_t *)out)[(uint64_t)k * TB + t] = p6_sum(
                (const uint32_t *)arena, W, TB, k,
                ((const uint32_t *)idx)[t], t, reps, lane_major);
    return 0;
}

// P7 over flags u32[kq, B] and st u32[51, B]
extern "C" int eravm_p7_host(const void *flags, void *st, int B, int kq,
                             int variant) {
    for (int b = 0; b < B; b++) {
        const uint32_t *f = (const uint32_t *)flags;
        uint32_t *p = (uint32_t *)st;
        if (variant == kOld) p7_run_lane<kOld>(f, p, B, kq, b);
        else if (variant == kWrapB) p7_run_lane<kWrapB>(f, p, B, kq, b);
        else if (variant == kSel) p7_run_lane<kSel>(f, p, B, kq, b);
        else if (variant == kTwo) p7_run_lane<kTwo>(f, p, B, kq, b);
        else return 1;
    }
    return 0;
}
