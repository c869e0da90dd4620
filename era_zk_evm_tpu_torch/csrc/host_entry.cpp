// Host (C++) build of the K1 (all three instances), K2 and K3 per-lane
// bodies, one lane after another.
//
// Not a runtime path: the port's wrappers take the kernels on CUDA tensors
// and the plain torch versions on CPU tensors.  This entry lets the tests
// check the kernels' lane logic against the plain versions on a machine
// without CUDA (tests/test_torch_kernel_host.py).

#include "cycle_kernel.cu"
#include "rolling_fold.cu"
#include "keccak_f.cu"

extern "C" int eravm_k1_host(const K1Args *a) {
    // the instance eravm_k1_launch chooses
    for (int b = 0; b < a->batch; b++) {
        if (a->storage_slots > 0 && a->keccak_blocks > 0)
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
