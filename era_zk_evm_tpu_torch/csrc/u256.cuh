// 256-bit unsigned arithmetic for one lane: eight little-endian u32 limbs.
//
// The device counterpart of era_zk_evm_tpu/ops/u256.py (add, sub, mul_full,
// div_mod, shl, shr); the scalar forms follow the native oracle's
// add256/mul256/divmod256/shl256/shr256 (native/eravm_oracle.cpp).
#pragma once

#include "common.cuh"

struct U256 {
    uint32_t w[8];
};

HD U256 u256_zero() {
    U256 r;
    for (int i = 0; i < 8; i++) r.w[i] = 0;
    return r;
}

HD U256 u256_from32(uint32_t x) {
    U256 r = u256_zero();
    r.w[0] = x;
    return r;
}

HD bool u256_is_zero(const U256 &a) {
    uint32_t acc = 0;
    for (int i = 0; i < 8; i++) acc |= a.w[i];
    return acc == 0;
}

HD U256 u256_add(const U256 &a, const U256 &b, bool *carry) {
    U256 r;
    uint64_t c = 0;
    for (int i = 0; i < 8; i++) {
        uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
        r.w[i] = (uint32_t)s;
        c = s >> 32;
    }
    *carry = c != 0;
    return r;
}

HD U256 u256_sub(const U256 &a, const U256 &b, bool *borrow) {
    U256 r;
    uint32_t br = 0;
    for (int i = 0; i < 8; i++) {
        uint64_t d = (uint64_t)a.w[i] - b.w[i] - br;
        r.w[i] = (uint32_t)d;
        br = (uint32_t)(d >> 63);
    }
    *borrow = br != 0;
    return r;
}

// full 512-bit product: schoolbook over u32 limbs with u64 partial sums
HD void u256_mul_full(const U256 &a, const U256 &b, U256 *lo, U256 *hi) {
    uint32_t p[16];
    for (int i = 0; i < 16; i++) p[i] = 0;
    for (int i = 0; i < 8; i++) {
        uint64_t carry = 0;
        for (int j = 0; j < 8; j++) {
            uint64_t cur = (uint64_t)a.w[i] * b.w[j] + p[i + j] + carry;
            p[i + j] = (uint32_t)cur;
            carry = cur >> 32;
        }
        p[i + 8] = (uint32_t)carry;
    }
    for (int i = 0; i < 8; i++) {
        lo->w[i] = p[i];
        hi->w[i] = p[i + 8];
    }
}

// a << n; n >= 256 gives 0
HD U256 u256_shl(const U256 &a, uint32_t n) {
    U256 r = u256_zero();
    if (n >= 256) return r;
    int ws = n >> 5, bs = n & 31;
    for (int i = 7; i >= ws; i--) {
        uint32_t v = a.w[i - ws] << bs;
        if (bs && i - ws - 1 >= 0) v |= a.w[i - ws - 1] >> (32 - bs);
        r.w[i] = v;
    }
    return r;
}

// a >> n; n >= 256 gives 0
HD U256 u256_shr(const U256 &a, uint32_t n) {
    U256 r = u256_zero();
    if (n >= 256) return r;
    int ws = n >> 5, bs = n & 31;
    for (int i = 0; i + ws < 8; i++) {
        uint32_t v = a.w[i + ws] >> bs;
        if (bs && i + ws + 1 < 8) v |= a.w[i + ws + 1] << (32 - bs);
        r.w[i] = v;
    }
    return r;
}

HD U256 u256_or(const U256 &a, const U256 &b) {
    U256 r;
    for (int i = 0; i < 8; i++) r.w[i] = a.w[i] | b.w[i];
    return r;
}

HD U256 u256_and(const U256 &a, const U256 &b) {
    U256 r;
    for (int i = 0; i < 8; i++) r.w[i] = a.w[i] & b.w[i];
    return r;
}

HD U256 u256_xor(const U256 &a, const U256 &b) {
    U256 r;
    for (int i = 0; i < 8; i++) r.w[i] = a.w[i] ^ b.w[i];
    return r;
}

// unsigned (a / b, a % b); b == 0 gives (0, 0).  Restoring binary long
// division: 256 steps, each shifting one dividend bit into the remainder.
HD void u256_divmod(const U256 &a, const U256 &b, U256 *q, U256 *r) {
    *q = u256_zero();
    *r = u256_zero();
    if (u256_is_zero(b)) return;
    int top = 255;                       // skip the dividend's leading zeros
    while (top >= 0 && !((a.w[top >> 5] >> (top & 31)) & 1)) top--;
    for (int bit = top; bit >= 0; bit--) {
        for (int i = 7; i > 0; i--)
            r->w[i] = (r->w[i] << 1) | (r->w[i - 1] >> 31);
        r->w[0] = (r->w[0] << 1) | ((a.w[bit >> 5] >> (bit & 31)) & 1);
        bool borrow;
        U256 d = u256_sub(*r, b, &borrow);
        if (!borrow) {
            *r = d;
            q->w[bit >> 5] |= 1u << (bit & 31);
        }
    }
}
