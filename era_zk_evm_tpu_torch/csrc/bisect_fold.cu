// The gated-fold probe P7 (CUDA C++, sm_90a).
//
// Replaces the TPU kernel of tools/bisect_fold.py (`build`): per lane, KQ
// slots of a gated keccak fold over st u32[51, B] (words 0-24 the low and
// 25-49 the high halves of a keccak state, word 50 a count) under flags
// u32[KQ, B].  With valid = flg & 4, rec = flg & 3 (into u64 lanes 0-7,
// "even", or 8-15, "odd", low and high half alike) and wrap = valid and the
// count odd, a slot does, by variant:
//   old    valid: st = f(st ^ even);
//   wrapb  wrap:  st = f(st ^ even);
//   sel    wrap:  st = f(st ^ odd);
//   two    valid: st ^= (wrap ? odd : even); then wrap: st = f(st);
// and every variant counts the valid slots.  (`new` is `two`.)  The TPU
// kernel's tile gates (pl.when on any lane of a tile) never change a lane's
// result, so a thread per lane computes it exactly.  Its plain version is
// era_zk_evm_tpu_torch/tools/bisect_fold.py::fold_plain.
//
// Design.  K2's: a thread per lane, the state as 25 u64 lanes in registers,
// the variant a template parameter; st and flags are batch-last, so a warp's
// loads of one word coalesce.  Bound: the permutations' integer operations
// (at B = 32768 and 16 slots, 8 to 16 keccak-f a lane) against 104 bytes
// of state and 4 of flags a slot.

#include "common.cuh"
#include "keccak.cuh"

enum P7Variant { kOld = 0, kWrapB = 1, kSel = 2, kTwo = 3 };

template <int kVariant>
HD void p7_run_lane(const uint32_t *flags, uint32_t *st, int B, int kq,
                    int b) {
    uint64_t a[25];
    for (int k = 0; k < 25; k++)
        a[k] = (uint64_t)st[(uint64_t)k * B + b] |
               ((uint64_t)st[(uint64_t)(25 + k) * B + b] << 32);
    uint32_t count = st[(uint64_t)50 * B + b];
    for (int s = 0; s < kq; s++) {
        const uint32_t flg = flags[(uint64_t)s * B + b];
        const bool valid = (flg & 4) != 0;
        const uint64_t rec = (uint64_t)(flg & 3) * 0x100000001ull;
        const bool wrap = ((flg >> 2) & count & 1) != 0;
        const bool odd = kVariant == kSel || (kVariant == kTwo && wrap);
        const bool absorb = kVariant == kOld || kVariant == kTwo ? valid : wrap;
        const bool permute = kVariant == kOld ? valid : wrap;
        // constant indices only, so that the state stays in registers
        const uint64_t even_rec = absorb && !odd ? rec : 0;
        const uint64_t odd_rec = absorb && odd ? rec : 0;
        for (int k = 0; k < 8; k++) {
            a[k] ^= even_rec;
            a[8 + k] ^= odd_rec;
        }
        if (permute) keccak_f1600(a);
        count += valid;
    }
    for (int k = 0; k < 25; k++) {
        st[(uint64_t)k * B + b] = (uint32_t)a[k];
        st[(uint64_t)(25 + k) * B + b] = (uint32_t)(a[k] >> 32);
    }
    st[(uint64_t)50 * B + b] = count;
}

#ifdef __CUDACC__
template <int kVariant>
__global__ void __launch_bounds__(128) p7_kernel(const uint32_t *flags,
                                                 uint32_t *st, int B, int kq) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < B) p7_run_lane<kVariant>(flags, st, B, kq, b);
}

// flags u32[kq, B]; st u32[51, B], folded in place; variant 0 old, 1 wrapb,
// 2 sel, 3 two
extern "C" int eravm_p7_launch(const void *flags, void *st, int B, int kq,
                               int variant, void *stream) {
    const int threads = 128, blocks = (B + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t *f = (const uint32_t *)flags;
    uint32_t *p = (uint32_t *)st;
    switch (variant) {
    case kOld: p7_kernel<kOld><<<blocks, threads, 0, s>>>(f, p, B, kq); break;
    case kWrapB: p7_kernel<kWrapB><<<blocks, threads, 0, s>>>(f, p, B, kq); break;
    case kSel: p7_kernel<kSel><<<blocks, threads, 0, s>>>(f, p, B, kq); break;
    case kTwo: p7_kernel<kTwo><<<blocks, threads, 0, s>>>(f, p, B, kq); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
#endif
