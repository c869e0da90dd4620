// keccak-f[1600] for one state held as 25 u64 lanes (flat index x + 5y).
//
// The device counterpart of era_zk_evm_tpu/ops/keccak.py: where the TPU
// kernels split each lane into u32 pairs or 32-state bit-planes, a Hopper
// thread keeps its 25 lanes in registers.  One round body, keccak_round,
// builds every form: its loops unroll, so each index is a constant, each
// rho offset (KECCAK_ROT_C, generated from the port's constants) folds to
// an immediate and each 64-bit rotation is two funnel shifts (SHF); theta's
// D folds into three-input XORs and chi into one LOP3 a 32-bit word.  That
// is the 180 int32 operations a round that the bounds count (chip_smoke.py,
// KECCAK_OPS), and ptxas emits just those: 180 LOP3 / SHF a round.
// keccak_rounds<kTrip> runs the 24 rounds kTrip to a loop trip, each
// round's constant read from the constant bank.
//
// Forms, chosen by measurement on the card (PERF.md §6):
//   keccak_f1600       K2, K3, the sponge, P1 and P7: four rounds a loop
//                      trip (~730 SASS, ~12 KB of code); all 24 unrolled
//                      (~4330, ~70 KB) ran 15-21% slower in K3 and K2,
//                      the code no longer held in the instruction cache;
//   keccak_f1600_unit  K1's precompile units and the ecrecover unit's
//                      address hash: a round a trip, compact inside the
//                      interpreter's code;
//   keccak_round       one round with any constant (P4).
#pragma once

#include "common.cuh"

#ifdef __CUDACC__
#define KECCAK_PRAGMA(x) _Pragma(#x)
#else
#define KECCAK_PRAGMA(x)
#endif

// x rotated left by n (0 <= n < 64).  Callers pass an n that folds to a
// constant, so that on the card the shifts are immediates.
HD uint64_t rotl64(uint64_t x, int n) {
#ifdef __CUDA_ARCH__
    const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
    if (n == 0) return x;
    if (n >= 32) {
        return ((uint64_t)__funnelshift_l(hi, lo, n - 32) << 32)
            | __funnelshift_l(lo, hi, n - 32);
    }
    return ((uint64_t)__funnelshift_l(lo, hi, n) << 32)
        | __funnelshift_l(hi, lo, n);
#else
    return n == 0 ? x : (x << n) | (x >> (64 - n));
#endif
}

// One round with the round constant rc.
HD void keccak_round(uint64_t a[25], uint64_t rc) {
    uint64_t c[5], t[25];
    KECCAK_PRAGMA(unroll)
    for (int x = 0; x < 5; x++)
        c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    // theta, then rho + pi: lane (x, y) moves to (y, 2x + 3y)
    KECCAK_PRAGMA(unroll)
    for (int x = 0; x < 5; x++) {
        // D = c[x - 1] ^ r is left unnamed: each lane's a ^ c[x - 1] ^ r
        // is then one three-input LOP3 a half, where a named D shared by
        // five lanes stays apart (10 instructions a round more)
        const uint64_t r = rotl64(c[(x + 1) % 5], 1);
        KECCAK_PRAGMA(unroll)
        for (int y = 0; y < 5; y++)
            t[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(
                a[x + 5 * y] ^ c[(x + 4) % 5] ^ r, KECCAK_ROT_C(x + 5 * y));
    }
    // chi, iota
    KECCAK_PRAGMA(unroll)
    for (int y = 0; y < 5; y++)
        KECCAK_PRAGMA(unroll)
        for (int x = 0; x < 5; x++)
            a[x + 5 * y] = t[x + 5 * y] ^
                (~t[(x + 1) % 5 + 5 * y] & t[(x + 2) % 5 + 5 * y]);
    a[0] ^= rc;
}

// The 24 rounds, kTrip of them a loop trip (kTrip divides 24).
template <int kTrip>
HD void keccak_rounds(uint64_t a[25]) {
    static_assert(24 % kTrip == 0, "kTrip must divide 24");
    KECCAK_PRAGMA(unroll 1)
    for (int r = 0; r < 24; r += kTrip) {
        KECCAK_PRAGMA(unroll)
        for (int u = 0; u < kTrip; u++) keccak_round(a, KECCAK_RC[r + u]);
    }
}

// rounds a loop trip of keccak_f1600
constexpr int kKeccakTrip = 4;

HD void keccak_f1600(uint64_t a[25]) { keccak_rounds<kKeccakTrip>(a); }

HD void keccak_f1600_unit(uint64_t a[25]) { keccak_rounds<1>(a); }
