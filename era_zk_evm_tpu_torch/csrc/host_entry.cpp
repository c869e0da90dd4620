// Host (C++) build of the K1 (all four instances), K2 and K3 per-lane
// bodies and of K1's ecrecover unit, one lane after another.
//
// Not a runtime path: the port's wrappers take the kernels on CUDA tensors
// and the plain torch versions on CPU tensors.  This entry lets the tests
// check the kernels' lane logic against the plain versions on a machine
// without CUDA (tests/test_torch_kernel_host.py).

#include "cycle_kernel.cu"
#include "rolling_fold.cu"
#include "keccak_f.cu"

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
