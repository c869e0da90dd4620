// secp256k1 signature recovery for one lane: K1's ecrecover unit.
//
// Replaces the TPU path for ecrecover cycles: the TPU kernel
// era_zk_evm_tpu/models/fused_cycle.py::_build_kernel only detects them
// (ec_first_blk, :2863-2894), and the wrapper _run_cycles_fused_ec (:3752)
// re-runs each chunk up to the ecrecover cycle and runs that cycle on the jnp
// engine, whose unit is era_zk_evm_tpu/ops/secp256k1.py::ecrecover_batched
// (:229).  Here a lane whose cycle is an ecrecover call runs the recovery
// itself, inside K1: no detection, no host readback, no second engine.  The
// plain version is era_zk_evm_tpu_torch/ops/secp256k1.py::ecrecover_batched.
//
// Design: a simple exact one, one lane per thread.  Field elements are U256
// (8 x 32-bit limbs) kept canonical in [0, m); a product is the 512-bit
// schoolbook product with 64-bit partial sums, its high half folded back with
// 2**256 = 2**256 - m (mod m), the pseudo-Mersenne 2**32 + 977 for p (two
// limbs) and a 129-bit constant for n (five limbs), until nothing is left
// above 2**256, then one conditional subtraction.  Points are Jacobian with
// Z = 0 for infinity; the addition branches on the edge cases (an operand at
// infinity, equal points, opposite points), which only crafted inputs reach.
// Q = u1 G + u2 R is one MSB-first double-and-add ladder over both scalars
// (Shamir's trick: G, R or G + R is added per bit).  Inversions and the square
// root are Fermat powers by square-and-multiply.  The outputs (the ok flag and
// the low 160 bits of keccak256 of the public key, keccak.cuh) are canonical,
// so any exact arithmetic gives the JAX package's bits.
//
// What bounds it on an H100: its operations, some 6,500 modular
// multiplications per recovery at ~300 int32 instructions each, and the local
// memory of its U256 temporaries (the function is __noinline__, so they live
// in its own frame and the interpreter's hot loop does not pay for them).
// Windowed or GLV scalar multiplication, Montgomery form and PTX carry chains
// are later work.  All constants come from the generated header.

#pragma once

#include "keccak.cuh"
#include "u256.cuh"

// internal linkage: two sources of one library include this header
namespace {

// the modulus (p, or n with kN) and 2**256 - modulus, limb i
template <bool kN> HD uint32_t ec_mod(int i) { return kN ? SECP_N[i] : SECP_P[i]; }
template <bool kN> HD uint32_t ec_fold(int i) {
    return kN ? SECP_FOLD_N[i] : SECP_FOLD_P[i];
}

template <bool kN> HD U256 ec_modulus() {
    U256 m;
    for (int i = 0; i < 8; i++) m.w[i] = ec_mod<kN>(i);
    return m;
}

HD bool u256_lt(const U256 &a, const U256 &b) {
    bool borrow;
    u256_sub(a, b, &borrow);
    return borrow;
}

HD bool u256_eq(const U256 &a, const U256 &b) {
    uint32_t d = 0;
    for (int i = 0; i < 8; i++) d |= a.w[i] ^ b.w[i];
    return d == 0;
}

// a + b mod m for a, b in [0, m): a carry out or a sum >= m subtracts m
template <bool kN> HD U256 fe_add(const U256 &a, const U256 &b) {
    bool carry, borrow;
    U256 s = u256_add(a, b, &carry);
    U256 d = u256_sub(s, ec_modulus<kN>(), &borrow);
    return (carry || !borrow) ? d : s;
}

template <bool kN> HD U256 fe_sub(const U256 &a, const U256 &b) {
    bool borrow, carry;
    U256 d = u256_sub(a, b, &borrow);
    return borrow ? u256_add(d, ec_modulus<kN>(), &carry) : d;
}

// a * b mod m: the 512-bit product, then hi * 2**256 = hi * fold until the
// high half is zero (p: at most four rounds, n: five), then one subtraction
template <bool kN> HD U256 fe_mul(const U256 &a, const U256 &b) {
    constexpr int FL = kN ? 5 : 2;          // nonzero limbs of the fold
    U256 lo, hi;
    u256_mul_full(a, b, &lo, &hi);
    while (!u256_is_zero(hi)) {
        uint32_t p[8 + FL];                 // hi * fold, schoolbook
        for (int i = 0; i < 8 + FL; i++) p[i] = 0;
        for (int i = 0; i < 8; i++) {
            uint64_t carry = 0;
            for (int j = 0; j < FL; j++) {
                uint64_t cur = (uint64_t)hi.w[i] * ec_fold<kN>(j) + p[i + j] + carry;
                p[i + j] = (uint32_t)cur;
                carry = cur >> 32;
            }
            p[i + FL] = (uint32_t)carry;
        }
        uint64_t c = 0;
        for (int i = 0; i < 8; i++) {
            c += (uint64_t)lo.w[i] + p[i];
            lo.w[i] = (uint32_t)c;
            c >>= 32;
        }
        for (int i = 0; i < 8; i++) {
            c += i < FL ? p[8 + i] : 0u;
            hi.w[i] = (uint32_t)c;
            c >>= 32;
        }
    }
    const U256 m = ec_modulus<kN>();
    bool borrow;
    return u256_lt(lo, m) ? lo : u256_sub(lo, m, &borrow);
}

enum { EXP_SQRT, EXP_P_INV, EXP_N_INV };

// limb i of a fixed exponent: (p + 1) / 4, p - 2 or n - 2
template <int kE> HD uint32_t ec_exp(int i) {
    return kE == EXP_SQRT ? SECP_SQRT_EXP[i]
        : kE == EXP_P_INV ? SECP_P_MINUS_2[i] : SECP_N_MINUS_2[i];
}

// x ** e for a fixed exponent, square-and-multiply MSB first
template <bool kN, int kE> HD U256 fe_pow(const U256 &x) {
    U256 acc = u256_from32(1);
    for (int bit = 255; bit >= 0; bit--) {
        acc = fe_mul<kN>(acc, acc);
        if ((ec_exp<kE>(bit >> 5) >> (bit & 31)) & 1) acc = fe_mul<kN>(acc, x);
    }
    return acc;
}

struct EcPoint {
    U256 X, Y, Z;   // Jacobian over p; Z == 0 is the point at infinity
};

HD_NOINLINE EcPoint ec_double(const EcPoint &P) {
    const U256 A = fe_mul<false>(P.X, P.X);
    const U256 Bv = fe_mul<false>(P.Y, P.Y);
    const U256 C = fe_mul<false>(Bv, Bv);
    const U256 XB = fe_add<false>(P.X, Bv);
    U256 D = fe_sub<false>(fe_sub<false>(fe_mul<false>(XB, XB), A), C);
    D = fe_add<false>(D, D);
    const U256 E = fe_add<false>(fe_add<false>(A, A), A);
    EcPoint R;
    R.X = fe_sub<false>(fe_mul<false>(E, E), fe_add<false>(D, D));
    U256 C8 = fe_add<false>(C, C);
    C8 = fe_add<false>(C8, C8);
    C8 = fe_add<false>(C8, C8);
    R.Y = fe_sub<false>(fe_mul<false>(E, fe_sub<false>(D, R.X)), C8);
    const U256 YZ = fe_mul<false>(P.Y, P.Z);
    R.Z = fe_add<false>(YZ, YZ);
    return R;
}

HD_NOINLINE EcPoint ec_add(const EcPoint &P, const EcPoint &Q) {
    if (u256_is_zero(P.Z)) return Q;
    if (u256_is_zero(Q.Z)) return P;
    const U256 Z1Z1 = fe_mul<false>(P.Z, P.Z);
    const U256 Z2Z2 = fe_mul<false>(Q.Z, Q.Z);
    const U256 U1 = fe_mul<false>(P.X, Z2Z2);
    const U256 U2 = fe_mul<false>(Q.X, Z1Z1);
    const U256 S1 = fe_mul<false>(P.Y, fe_mul<false>(Q.Z, Z2Z2));
    const U256 S2 = fe_mul<false>(Q.Y, fe_mul<false>(P.Z, Z1Z1));
    const U256 H = fe_sub<false>(U2, U1);
    const U256 Rr = fe_sub<false>(S2, S1);
    if (u256_is_zero(H)) {
        if (u256_is_zero(Rr)) return ec_double(P);
        EcPoint inf;
        inf.X = inf.Y = inf.Z = u256_zero();
        return inf;
    }
    const U256 HH = fe_mul<false>(H, H);
    const U256 HHH = fe_mul<false>(HH, H);
    const U256 V = fe_mul<false>(U1, HH);
    EcPoint R;
    R.X = fe_sub<false>(fe_sub<false>(fe_mul<false>(Rr, Rr), HHH),
                        fe_add<false>(V, V));
    R.Y = fe_sub<false>(fe_mul<false>(Rr, fe_sub<false>(V, R.X)),
                        fe_mul<false>(S1, HHH));
    R.Z = fe_mul<false>(fe_mul<false>(P.Z, Q.Z), H);
    return R;
}

HD uint32_t ec_bswap32(uint32_t x) {
    return (x << 24) | ((x & 0xFF00u) << 8) | ((x >> 8) & 0xFF00u) | (x >> 24);
}

// The recovered address (the low 160 bits of keccak256 of the public key)
// of a signature (digest, v, r, s); false, with a zero address, when r or s
// is outside [1, n), v > 1, r is no curve x coordinate, or the recovered
// point is at infinity.
HD_NOINLINE bool ecrecover_unit(const U256 &digest, uint32_t v,
                                const U256 &r, const U256 &s, U256 *addr) {
    *addr = u256_zero();
    const U256 n = ec_modulus<true>();
    if (u256_is_zero(r) || u256_is_zero(s) || !u256_lt(r, n)
        || !u256_lt(s, n) || v > 1)
        return false;
    // R = (r, y) with y = sqrt(r^3 + 7) of parity v (r < n < p)
    const U256 y_sq = fe_add<false>(fe_mul<false>(fe_mul<false>(r, r), r),
                                    u256_from32(7));
    U256 y = fe_pow<false, EXP_SQRT>(y_sq);
    if (!u256_eq(fe_mul<false>(y, y), y_sq)) return false;
    if ((y.w[0] & 1) != v) y = fe_sub<false>(u256_zero(), y);
    // u1 = -e / r, u2 = s / r (mod n); e = digest mod n (digest < 2n)
    const U256 e = u256_lt(digest, n) ? digest : fe_sub<true>(digest, n);
    const U256 r_inv = fe_pow<true, EXP_N_INV>(r);
    const U256 u1 = fe_mul<true>(fe_sub<true>(u256_zero(), e), r_inv);
    const U256 u2 = fe_mul<true>(s, r_inv);
    // Q = u1 G + u2 R, one ladder over both scalars
    EcPoint G, R, acc;
    for (int i = 0; i < 8; i++) {
        G.X.w[i] = SECP_GX[i];
        G.Y.w[i] = SECP_GY[i];
    }
    G.Z = R.Z = u256_from32(1);
    R.X = r;
    R.Y = y;
    const EcPoint GR = ec_add(G, R);
    acc.X = acc.Y = acc.Z = u256_zero();
    for (int bit = 255; bit >= 0; bit--) {
        acc = ec_double(acc);
        const bool b1 = (u1.w[bit >> 5] >> (bit & 31)) & 1;
        const bool b2 = (u2.w[bit >> 5] >> (bit & 31)) & 1;
        if (b1 || b2) acc = ec_add(acc, b1 ? (b2 ? GR : G) : R);
    }
    if (u256_is_zero(acc.Z)) return false;
    const U256 zinv = fe_pow<false, EXP_P_INV>(acc.Z);
    const U256 zinv2 = fe_mul<false>(zinv, zinv);
    const U256 qx = fe_mul<false>(acc.X, zinv2);
    const U256 qy = fe_mul<false>(acc.Y, fe_mul<false>(zinv2, zinv));
    // keccak256 of the 64 big-endian bytes qx || qy: one padded block
    uint64_t st[25];
    for (int i = 0; i < 25; i++) st[i] = 0;
    for (int k = 0; k < 4; k++) {
        st[k] = ec_bswap32(qx.w[7 - 2 * k]) | ((uint64_t)ec_bswap32(qx.w[6 - 2 * k]) << 32);
        st[4 + k] = ec_bswap32(qy.w[7 - 2 * k]) | ((uint64_t)ec_bswap32(qy.w[6 - 2 * k]) << 32);
    }
    st[8] ^= 0x01;
    st[16] ^= 0x8000000000000000ull;
    keccak_f1600(st);
    for (int j = 0; j < 5; j++) {
        uint32_t limb = 0;
        for (int q = 0; q < 4; q++) {
            const int i = 28 - 4 * j + q;
            limb = (limb << 8) | (uint32_t)((st[i / 8] >> (8 * (i % 8))) & 0xFF);
        }
        addr->w[j] = limb;
    }
    return true;
}

}  // namespace
