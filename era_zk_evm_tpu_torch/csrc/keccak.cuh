// keccak-f[1600] for one state held as 25 u64 lanes (flat index x + 5y).
//
// The device counterpart of era_zk_evm_tpu/ops/keccak.py: where the TPU
// kernels split each lane into u32 pairs or 32-state bit-planes, a Hopper
// thread keeps its 25 lanes in registers (every index below is a constant
// after unrolling) and rotates with the 64-bit funnel shift.  Round
// constants and rotation offsets come from the generated header.
#pragma once

#include "common.cuh"

HD uint64_t rotl64(uint64_t x, int n) {
    return n == 0 ? x : (x << n) | (x >> (64 - n));
}

HD void keccak_f1600(uint64_t a[25]) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int round = 0; round < 24; round++) {
        uint64_t c[5], d[5], t[25];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        // theta, then rho + pi: lane (x, y) moves to (y, 2x + 3y)
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int x = 0; x < 5; x++)
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int y = 0; y < 5; y++)
                t[y + 5 * ((2 * x + 3 * y) % 5)] =
                    rotl64(a[x + 5 * y] ^ d[x], KECCAK_ROT[x + 5 * y]);
        // chi
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int y = 0; y < 5; y++)
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int x = 0; x < 5; x++)
                a[x + 5 * y] = t[x + 5 * y] ^
                    (~t[(x + 1) % 5 + 5 * y] & t[(x + 2) % 5 + 5 * y]);
        // iota
        a[0] ^= KECCAK_RC[round];
    }
}

// One round with the round constant `rc`: the body of keccak_f1600's loop,
// kept apart from it so that the permutation K1, K2 and K3 inline compiles
// exactly as before (the round-rate probe, csrc/probe_rate.cu, calls this).
HD void keccak_round(uint64_t a[25], uint64_t rc) {
    uint64_t c[5], d[5], t[25];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int x = 0; x < 5; x++)
        c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int x = 0; x < 5; x++)
        d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int x = 0; x < 5; x++)
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int y = 0; y < 5; y++)
            t[y + 5 * ((2 * x + 3 * y) % 5)] =
                rotl64(a[x + 5 * y] ^ d[x], KECCAK_ROT[x + 5 * y]);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int y = 0; y < 5; y++)
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int x = 0; x < 5; x++)
            a[x + 5 * y] = t[x + 5 * y] ^
                (~t[(x + 1) % 5 + 5 * y] & t[(x + 2) % 5 + 5 * y]);
    a[0] ^= rc;
}

// The precompile units' permutation (K1's kPrecomp and kEc instances,
// cycle_kernel.cu): keccak_f1600's rounds with the rotation offsets as
// immediates (KECCAK_ROT_C folds where the lane index is a constant after
// unrolling), so that each 64-bit rotation is two funnel shifts and not a
// table load and a variable shift; a round a loop trip, as compact as
// keccak_f1600's.  K2, K3 and the sponge keep keccak_f1600.
HD uint64_t rotl64_c(uint64_t x, int n) {
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
    return rotl64(x, n);
#endif
}

HD void keccak_f1600_unit(uint64_t a[25]) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int round = 0; round < 24; round++) {
        uint64_t c[5], d[5], t[25];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl64_c(c[(x + 1) % 5], 1);
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int x = 0; x < 5; x++)
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int y = 0; y < 5; y++)
                t[y + 5 * ((2 * x + 3 * y) % 5)] =
                    rotl64_c(a[x + 5 * y] ^ d[x], KECCAK_ROT_C(x + 5 * y));
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int y = 0; y < 5; y++)
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int x = 0; x < 5; x++)
                a[x + 5 * y] = t[x + 5 * y] ^
                    (~t[(x + 1) % 5 + 5 * y] & t[(x + 2) % 5 + 5 * y]);
        a[0] ^= KECCAK_RC[round];
    }
}
