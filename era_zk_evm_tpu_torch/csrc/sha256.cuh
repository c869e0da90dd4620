// SHA-256 compression of one 64-byte block, for one lane.
//
// The device counterpart of era_zk_evm_tpu/ops/sha256.py (and of the port's
// plain ops/sha256.py): where the TPU runs the 64 rounds over [B] vectors,
// a Hopper thread keeps its 8 state words and a rolling 16-word message
// schedule in registers (every index is a constant once nvcc unrolls a
// trip of 16 rounds).  The round constants and the IV come from the generated header,
// in __constant__ memory on the device.
#pragma once

#include "common.cuh"

HD uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// state[8] <- compress(state, block[16]); the block as big-endian words.
// Four trips of 16 unrolled rounds, the schedule's next 16 words computed
// in place after each trip: every index is a constant, and the code a
// fourth of the 64 rounds unrolled (the units run it rarely, between long
// stretches of the interpreter, so their code is fetched cold).
HD void sha256_compress(uint32_t state[8], const uint32_t block[16]) {
    uint32_t w[16];
    for (int i = 0; i < 16; i++) w[i] = block[i];
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int r = 0; r < 64; r += 16) {
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int j = 0; j < 16; j++) {
            const uint32_t t1 = h + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25))
                + ((e & f) ^ (~e & g)) + SHA256_K[r + j] + w[j];
            const uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22))
                + ((a & b) ^ (a & c) ^ (b & c));
            h = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        if (r < 48) {
            // W[r + 16 + j] from W[r + j .. r + 14 + j], in place in order
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int j = 0; j < 16; j++) {
                const uint32_t x = w[(j + 1) & 15], y = w[(j + 14) & 15];
                w[j] += (rotr32(x, 7) ^ rotr32(x, 18) ^ (x >> 3))
                    + w[(j + 9) & 15]
                    + (rotr32(y, 17) ^ rotr32(y, 19) ^ (y >> 10));
            }
        }
    }
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
    state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}
