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
