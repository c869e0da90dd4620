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
// Design: one lane per thread, and every lane of a warp runs the same
// sequence of field operations, whatever its signature.
//  * Field elements are U256 (8 x 32-bit limbs), canonical in [0, m).  A
//    product is the 8 x 8-limb schoolbook product, on the card one carry
//    chain a row (mad.lo.cc / madc.hi.cc: 2 instructions a limb product), a
//    square its 28 cross products doubled plus the 8 diagonal ones.  The
//    reduction has a fixed number of steps: mod p = 2**256 - c, c = 2**32 +
//    977, two folds of the high part by c and one conditional subtraction;
//    mod n (2**256 - n has 129 bits) three folds of fixed widths and one
//    conditional subtraction.  No loop depends on the data.
//  * The three fixed powers (the square root (p + 1) / 4, the inverses p - 2
//    and n - 2) are addition chains over the exponents' runs of ones
//    (SECP_CHAIN_*, generated by _build.py): 255-263 squarings and 15-47
//    multiplications each, where square-and-multiply took ~500.
//  * Q = u1 G + u2 R splits each scalar by the endomorphism lambda (lambda
//    (x, y) = (beta x, y)) into two halves under 2**130 (ec_split, the
//    rounding constants SECP_G1 / SECP_G2 and the basis from _build.py), so
//    four half-scalars share one run of 128 doublings.  Each half is walked
//    in the regular signed recoding (every digit odd and nonzero: an even
//    half is made odd and corrected by one subtraction at the end, taken or
//    not by a select), 4-bit digits for R and lambda R, 5-bit ones for G and
//    lambda G, so the sequence of doublings and additions is the same in
//    every lane.  G's and lambda G's 16 odd multiples are affine constants
//    in read-only global memory (SECP_GTAB).  R's 8 odd multiples are built
//    per lane with one common Z (the z-ratio rescaling), so that they are
//    affine on the curve isomorphic by that Z, where the accumulator runs:
//    every addition is a mixed one (8 multiplications and 3 squares), G's
//    entries scaled by Z^2 and Z^3 on the way in.
//  * Edge cases of an addition (the accumulator at infinity, equal to the
//    table point or to its negation) are exact: branches that only crafted
//    signatures take (u1 G = -u2 R, R = +-G, ...).
// The outputs (the ok flag and the low 160 bits of keccak256 of the public
// key, keccak.cuh) are canonical, so any exact arithmetic gives the JAX
// package's bits.
//
// What bounds it on an H100: its operations, some 3,400 field
// multiplications and squares per recovery (chip_smoke.py's
// ecrecover_counts counts them) at ~150-190 int32 instructions each (the
// mod-n ones ~250-290), and the local memory of R's table (512 bytes a
// lane) and of the noinline functions' frames.  All constants come from
// the generated header.

#pragma once

#include "keccak.cuh"
#include "u256.cuh"

// internal linkage: two sources of one library include this header
namespace {

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

HD U256 u256_sel(bool c, const U256 &a, const U256 &b) {
    U256 r;
    for (int i = 0; i < 8; i++) r.w[i] = c ? a.w[i] : b.w[i];
    return r;
}

// the modulus: p, or n with kN
template <bool kN> HD U256 ec_modulus() {
    U256 m;
    for (int i = 0; i < 8; i++) m.w[i] = kN ? SECP_N[i] : SECP_P[i];
    return m;
}

// the 512-bit product t of a and b
HD void mul_512(const U256 &a, const U256 &b, uint32_t t[16]) {
#ifdef __CUDA_ARCH__
    for (int i = 0; i < 16; i++) t[i] = 0;
    // row i adds a_i * b at limb i: the low halves in one carry chain, the
    // carry into limb i + 8 (not yet written), then the high halves; the
    // sum so far is below 2**(32 (i + 9)), so nothing carries out
#pragma unroll
    for (int i = 0; i < 8; i++) {
        asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
            "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
            "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
            "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
            "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
            "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
            "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
            "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
            "addc.u32 %8, 0, 0;\n\t"
            "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
            "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
            "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
            "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
            "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
            "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
            "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
            "madc.hi.u32 %8, %9, %17, %8;\n\t"
            : "+r"(t[i]), "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(t[i + 3]),
              "+r"(t[i + 4]), "+r"(t[i + 5]), "+r"(t[i + 6]), "+r"(t[i + 7]),
              "+r"(t[i + 8])
            : "r"(a.w[i]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]),
              "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
              "r"(b.w[7]));
    }
#else
    U256 lo, hi;
    u256_mul_full(a, b, &lo, &hi);
    for (int i = 0; i < 8; i++) {
        t[i] = lo.w[i];
        t[8 + i] = hi.w[i];
    }
#endif
}

// the 512-bit square t of a
HD void sqr_512(const U256 &a, uint32_t t[16]) {
#ifdef __CUDA_ARCH__
    for (int i = 0; i < 16; i++) t[i] = 0;
    // the cross products a_i a_j (i < j) at limb i + j, a row an i as in
    // mul_512 (limb i + 8 not yet written; the cross sum is below 2**511)
    asm("mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.lo.cc.u32 %1, %8, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %11, %2;\n\t"
        "madc.lo.cc.u32 %3, %8, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %13, %4;\n\t"
        "madc.lo.cc.u32 %5, %8, %14, %5;\n\t"
        "madc.lo.cc.u32 %6, %8, %15, %6;\n\t"
        "addc.u32 %7, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %8, %9, %1;\n\t"
        "madc.hi.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %11, %3;\n\t"
        "madc.hi.cc.u32 %4, %8, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %13, %5;\n\t"
        "madc.hi.cc.u32 %6, %8, %14, %6;\n\t"
        "madc.hi.u32 %7, %8, %15, %7;\n\t"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
    asm("mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.lo.cc.u32 %1, %7, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %10, %2;\n\t"
        "madc.lo.cc.u32 %3, %7, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %12, %4;\n\t"
        "madc.lo.cc.u32 %5, %7, %13, %5;\n\t"
        "addc.u32 %6, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.hi.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %10, %3;\n\t"
        "madc.hi.cc.u32 %4, %7, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %12, %5;\n\t"
        "madc.hi.u32 %6, %7, %13, %6;\n\t"
        : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
        : "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
    asm("mad.lo.cc.u32 %0, %6, %7, %0;\n\t"
        "madc.lo.cc.u32 %1, %6, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %9, %2;\n\t"
        "madc.lo.cc.u32 %3, %6, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %6, %11, %4;\n\t"
        "addc.u32 %5, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %6, %7, %1;\n\t"
        "madc.hi.cc.u32 %2, %6, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %9, %3;\n\t"
        "madc.hi.cc.u32 %4, %6, %10, %4;\n\t"
        "madc.hi.u32 %5, %6, %11, %5;\n\t"
        : "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10])
        : "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
    asm("mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.lo.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %8, %2;\n\t"
        "madc.lo.cc.u32 %3, %5, %9, %3;\n\t"
        "addc.u32 %4, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.hi.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %8, %3;\n\t"
        "madc.hi.u32 %4, %5, %9, %4;\n\t"
        : "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11])
        : "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
    asm("mad.lo.cc.u32 %0, %4, %5, %0;\n\t"
        "madc.lo.cc.u32 %1, %4, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %4, %7, %2;\n\t"
        "addc.u32 %3, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %4, %5, %1;\n\t"
        "madc.hi.cc.u32 %2, %4, %6, %2;\n\t"
        "madc.hi.u32 %3, %4, %7, %3;\n\t"
        : "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
    asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.lo.cc.u32 %1, %3, %5, %1;\n\t"
        "addc.u32 %2, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "madc.hi.u32 %2, %3, %5, %2;\n\t"
        : "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
    asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "mad.hi.u32 %1, %2, %3, %1;\n\t"
        : "+r"(t[13]), "+r"(t[14])
        : "r"(a.w[6]), "r"(a.w[7]));

    // doubled, then the squares a_i**2 at limb 2 i
    asm("add.cc.u32 %0, %0, %0;\n\t"
        "addc.cc.u32 %1, %1, %1;\n\t"
        "addc.cc.u32 %2, %2, %2;\n\t"
        "addc.cc.u32 %3, %3, %3;\n\t"
        "addc.cc.u32 %4, %4, %4;\n\t"
        "addc.cc.u32 %5, %5, %5;\n\t"
        "addc.cc.u32 %6, %6, %6;\n\t"
        "addc.cc.u32 %7, %7, %7;\n\t"
        "addc.cc.u32 %8, %8, %8;\n\t"
        "addc.cc.u32 %9, %9, %9;\n\t"
        "addc.cc.u32 %10, %10, %10;\n\t"
        "addc.cc.u32 %11, %11, %11;\n\t"
        "addc.cc.u32 %12, %12, %12;\n\t"
        "addc.cc.u32 %13, %13, %13;\n\t"
        "addc.cc.u32 %14, %14, %14;\n\t"
        "addc.u32 %15, %15, %15;\n\t"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
          "+r"(t[15]));
    asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
        "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
        "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
        "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
        "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
        "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
        "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
        "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
        "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
        "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
        "madc.hi.u32 %15, %23, %23, %15;\n\t"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
          "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
          "+r"(t[15])
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
          "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
#else
    mul_512(a, a, t);
#endif
}

// t mod p, p = 2**256 - c with c = 2**32 + SECP_FOLD_P[0]: s = lo + hi c
// (below 2**289), then v = s mod 2**256 + (s >> 256) c (below 2**256 +
// 2**66), then v - p where v >= p, that is where v carries past 2**256 or
// v + c does
HD U256 reduce_p(const uint32_t t[16]) {
    const uint64_t c0 = SECP_FOLD_P[0];
    uint32_t s[8];
    uint64_t acc = 0;
    for (int i = 0; i < 8; i++) {
        acc += (uint64_t)t[i] + (uint64_t)t[8 + i] * c0
            + (i ? (uint64_t)t[7 + i] : 0u);
        s[i] = (uint32_t)acc;
        acc >>= 32;
    }
    const uint64_t top = acc + t[15];            // s >> 256, below 2**34
    const uint64_t tc = top * c0;
    U256 v;
    acc = (uint64_t)s[0] + (uint32_t)tc;
    v.w[0] = (uint32_t)acc;
    acc = (acc >> 32) + s[1] + (tc >> 32) + (uint32_t)top;
    v.w[1] = (uint32_t)acc;
    acc = (acc >> 32) + s[2] + (top >> 32);
    v.w[2] = (uint32_t)acc;
    for (int i = 3; i < 8; i++) {
        acc = (acc >> 32) + s[i];
        v.w[i] = (uint32_t)acc;
    }
    const bool over = (acc >> 32) != 0;
    U256 w;
    acc = (uint64_t)v.w[0] + c0;
    w.w[0] = (uint32_t)acc;
    acc = (acc >> 32) + v.w[1] + 1u;
    w.w[1] = (uint32_t)acc;
    for (int i = 2; i < 8; i++) {
        acc = (acc >> 32) + v.w[i];
        w.w[i] = (uint32_t)acc;
    }
    return u256_sel(over || (acc >> 32) != 0, w, v);
}

// acc[0 .. na) += a[0 .. la) * b[0 .. lb), carries through all of acc
HD void mac_limbs(uint32_t *acc, int na, const uint32_t *a, int la,
                  const uint32_t *b, int lb) {
    for (int i = 0; i < la; i++) {
        uint64_t c = 0;
        for (int j = 0; j < lb; j++) {
            c += (uint64_t)a[i] * b[j] + acc[i + j];
            acc[i + j] = (uint32_t)c;
            c >>= 32;
        }
        for (int k = i + lb; k < na; k++) {
            c += acc[k];
            acc[k] = (uint32_t)c;
            c >>= 32;
        }
    }
}

// t mod n, with c = 2**256 - n (five limbs, 129 bits): u = lo + hi c (below
// 2**386), v = u mod 2**256 + (u >> 256) c (below 2**260), w = v mod 2**256
// + (v >> 256) c (below 2**256 + 2**133), then w - n where w >= n
HD U256 reduce_n(const uint32_t t[16]) {
    uint32_t c[5];
    for (int i = 0; i < 5; i++) c[i] = SECP_FOLD_N[i];
    uint32_t u[13], v[10], w[9];
    for (int i = 0; i < 13; i++) u[i] = i < 8 ? t[i] : 0u;
    mac_limbs(u, 13, t + 8, 8, c, 5);
    for (int i = 0; i < 10; i++) v[i] = i < 8 ? u[i] : 0u;
    mac_limbs(v, 10, u + 8, 5, c, 5);
    for (int i = 0; i < 9; i++) w[i] = i < 8 ? v[i] : 0u;
    mac_limbs(w, 9, v + 8, 1, c, 5);
    U256 lo, x;
    uint64_t acc = 0;
    for (int i = 0; i < 8; i++) {
        lo.w[i] = w[i];
        acc += (uint64_t)w[i] + (i < 5 ? c[i] : 0u);
        x.w[i] = (uint32_t)acc;
        acc >>= 32;
    }
    return u256_sel(w[8] != 0 || acc != 0, x, lo);
}

// a + b mod m for a, b in [0, m): a carry out or a sum >= m subtracts m
template <bool kN> HD U256 fe_add(const U256 &a, const U256 &b) {
    bool carry, borrow;
    U256 s = u256_add(a, b, &carry);
    U256 d = u256_sub(s, ec_modulus<kN>(), &borrow);
    return u256_sel(carry || !borrow, d, s);
}

template <bool kN> HD U256 fe_sub(const U256 &a, const U256 &b) {
    bool borrow, carry;
    U256 d = u256_sub(a, b, &borrow);
    return u256_sel(borrow, u256_add(d, ec_modulus<kN>(), &carry), d);
}

template <bool kN> HD U256 fe_neg(const U256 &a) {
    return fe_sub<kN>(u256_zero(), a);
}

// a * b mod m (m = p, or n with kN), canonical for any 256-bit a and b.
// Out of line, its operands by value (in registers): one copy of each, so
// the unit's code stays small and the callers' register footprint low
// (inlined, they made the kEc instance spill more and the unit slower).
template <bool kN> HD_NOINLINE U256 fe_mul(const U256 a, const U256 b) {
    uint32_t t[16];
    mul_512(a, b, t);
    return kN ? reduce_n(t) : reduce_p(t);
}

template <bool kN> HD_NOINLINE U256 fe_sqr(const U256 a) {
    uint32_t t[16];
    sqr_512(a, t);
    return kN ? reduce_n(t) : reduce_p(t);
}

// a ** (2**s): s squarings, the same count in every lane
template <bool kN> HD_NOINLINE U256 fe_sqr_n(U256 a, int s) {
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
    for (int i = 0; i < s; i++) a = fe_sqr<kN>(a);
    return a;
}

#define EC_SQM_P(a, s, b) fe_mul<false>(fe_sqr_n<false>(a, s), b)
#define EC_SQ_P(a, s) fe_sqr_n<false>(a, s)
#define EC_SQM_N(a, s, b) fe_mul<true>(fe_sqr_n<true>(a, s), b)
#define EC_SQ_N(a, s) fe_sqr_n<true>(a, s)

// the fixed powers, by the addition chains of the generated header:
// x ** ((p + 1) / 4) (a square root where one exists), 1 / x mod p and
// 1 / x mod n (0 for x = 0)
HD_NOINLINE U256 fe_sqrt_pow(const U256 x1) { SECP_CHAIN_SQRT(EC_SQM_P, EC_SQ_P) }
HD_NOINLINE U256 fe_inv_p(const U256 x1) { SECP_CHAIN_P_INV(EC_SQM_P, EC_SQ_P) }
HD_NOINLINE U256 fe_inv_n(const U256 x1) { SECP_CHAIN_N_INV(EC_SQM_N, EC_SQ_N) }

struct EcPoint {
    U256 X, Y, Z;   // Jacobian over p; Z == 0 is the point at infinity
};

struct EcAffine {
    U256 x, y;
};

// 2 P (dbl-2009-l: 2 multiplications, 5 squares); infinity stays infinity.
// The formulas do not use the curve's b, so they hold on every curve
// y^2 = x^3 + b' isomorphic to secp256k1.
HD_NOINLINE EcPoint ec_double(const EcPoint &P) {
    const U256 A = fe_sqr<false>(P.X);
    const U256 Bv = fe_sqr<false>(P.Y);
    const U256 C = fe_sqr<false>(Bv);
    U256 D = fe_sub<false>(fe_sub<false>(fe_sqr<false>(fe_add<false>(P.X, Bv)),
                                         A), C);
    D = fe_add<false>(D, D);
    const U256 E = fe_add<false>(fe_add<false>(A, A), A);
    EcPoint R;
    R.X = fe_sub<false>(fe_sqr<false>(E), fe_add<false>(D, D));
    U256 C8 = fe_add<false>(C, C);
    C8 = fe_add<false>(C8, C8);
    C8 = fe_add<false>(C8, C8);
    R.Y = fe_sub<false>(fe_mul<false>(E, fe_sub<false>(D, R.X)), C8);
    const U256 YZ = fe_mul<false>(P.Y, P.Z);
    R.Z = fe_add<false>(YZ, YZ);
    return R;
}

// P + (x2, y2), the second point affine (Z = 1): 8 multiplications and 3
// squares, Z3 = Z1 H.  Exact in every case: P at infinity gives (x2, y2),
// P equal to the point its double, P its negation infinity; those branches
// only crafted inputs take.  *zr (when given) is the z-ratio Z3 / Z1 = H of
// the general case.  b-free, as ec_double.
HD_NOINLINE EcPoint ec_madd(const EcPoint &P, const U256 &x2, const U256 &y2,
                            U256 *zr) {
    EcPoint R;
    if (u256_is_zero(P.Z)) {
        R.X = x2;
        R.Y = y2;
        R.Z = u256_from32(1);
        return R;
    }
    const U256 Z1Z1 = fe_sqr<false>(P.Z);
    const U256 U2 = fe_mul<false>(x2, Z1Z1);
    const U256 S2 = fe_mul<false>(y2, fe_mul<false>(P.Z, Z1Z1));
    const U256 H = fe_sub<false>(U2, P.X);
    const U256 Rr = fe_sub<false>(S2, P.Y);
    if (u256_is_zero(H)) {
        if (u256_is_zero(Rr)) return ec_double(P);
        R.X = R.Y = R.Z = u256_zero();
        return R;
    }
    const U256 HH = fe_sqr<false>(H);
    const U256 HHH = fe_mul<false>(HH, H);
    const U256 V = fe_mul<false>(P.X, HH);
    R.X = fe_sub<false>(fe_sub<false>(fe_sqr<false>(Rr), HHH),
                        fe_add<false>(V, V));
    R.Y = fe_sub<false>(fe_mul<false>(Rr, fe_sub<false>(V, R.X)),
                        fe_mul<false>(P.Y, HHH));
    R.Z = fe_mul<false>(P.Z, H);
    if (zr) *zr = H;
    return R;
}

// R's odd multiples R, 3R, .. 15R, affine (x, y) over one common Z: the
// entries and *zt, with (x, y, zt) their Jacobian coordinates.  d = 2R is
// affine on the curve isomorphic by d.Z, where R is (r d.Z^2, y d.Z^3), so
// each further multiple is one mixed addition of d; the z-ratios then bring
// every entry to the last one's Z.  No addition here meets an edge case: kR
// for k < 16 are distinct and finite (n is prime).
HD_NOINLINE void ec_odd_multiples(const U256 &rx, const U256 &ry,
                                  EcAffine tab[8], U256 *zt) {
    EcPoint P;
    P.X = rx;
    P.Y = ry;
    P.Z = u256_from32(1);
    const EcPoint d = ec_double(P);
    const U256 zd2 = fe_sqr<false>(d.Z);
    P.X = fe_mul<false>(rx, zd2);
    P.Y = fe_mul<false>(ry, fe_mul<false>(zd2, d.Z));
    U256 zr[8];
    tab[0].x = P.X;
    tab[0].y = P.Y;
    for (int i = 1; i < 8; i++) {
        P = ec_madd(P, d.X, d.Y, &zr[i]);
        tab[i].x = P.X;
        tab[i].y = P.Y;
    }
    U256 zs = zr[7];
    for (int i = 6; i >= 0; i--) {
        const U256 zs2 = fe_sqr<false>(zs);
        tab[i].x = fe_mul<false>(tab[i].x, zs2);
        tab[i].y = fe_mul<false>(tab[i].y, fe_mul<false>(zs2, zs));
        if (i) zs = fe_mul<false>(zs, zr[i]);
    }
    *zt = fe_mul<false>(P.Z, d.Z);
}

// A half-scalar of the split, made odd: |k| + (1 if k is even), its sign and
// whether it was even
struct EcScalar {
    uint32_t m[5];
    bool neg, even;
};

HD EcScalar ec_scalar(const U256 &k) {
    EcScalar s;
    s.neg = (k.w[7] >> 31) != 0;
    bool borrow, carry;
    U256 mag = u256_sel(s.neg, u256_sub(u256_zero(), k, &borrow), k);
    s.even = (mag.w[0] & 1u) == 0;
    mag = u256_add(mag, u256_from32(s.even), &carry);
    for (int i = 0; i < 5; i++) s.m[i] = mag.w[i];
    return s;
}

// the low 256 bits of a * b
HD U256 mul_lo(const U256 &a, const U256 &b) {
    uint32_t t[16];
    mul_512(a, b, t);
    U256 r;
    for (int i = 0; i < 8; i++) r.w[i] = t[i];
    return r;
}

HD U256 ec_const(const uint32_t *limbs) {
    U256 r;
    for (int i = 0; i < 8; i++) r.w[i] = limbs[i];
    return r;
}

// round(k g / 2**384) for k < n
HD U256 ec_round384(const U256 &k, const U256 &g) {
    uint32_t t[16];
    mul_512(k, g, t);
    U256 c = u256_zero();
    for (int i = 0; i < 4; i++) c.w[i] = t[12 + i];
    bool carry;
    return u256_add(c, u256_from32(t[11] >> 31), &carry);
}

// k = k1 + k2 lambda (mod n), k < n: c1 = round(k g1 / 2**384), c2 =
// round(k g2 / 2**384), k1 = k - c1 a1 - c2 a2, k2 = c1 (-b1) - c2 b2.  Both
// halves are small (under 2**130), so their low 256 bits in two's complement
// are exact.
HD void ec_split(const U256 &k, EcScalar *k1, EcScalar *k2) {
    const U256 c1 = ec_round384(k, ec_const(SECP_G1));
    const U256 c2 = ec_round384(k, ec_const(SECP_G2));
    bool b;
    const U256 h1 = u256_sub(u256_sub(k, mul_lo(c1, ec_const(SECP_A1)), &b),
                             mul_lo(c2, ec_const(SECP_A2)), &b);
    const U256 h2 = u256_sub(mul_lo(c1, ec_const(SECP_MINUS_B1)),
                             mul_lo(c2, ec_const(SECP_B2)), &b);
    *k1 = ec_scalar(h1);
    *k2 = ec_scalar(h2);
}

// digit i of the regular signed recoding of the odd m in `count` digits of
// w bits: 2 ((m >> (w i + 1)) mod 2**w) + 1 - 2**w, the top one without the
// - 2**w; every digit is odd, so none is zero
HD int ec_digit(const uint32_t m[5], int i, int w, int count) {
    const int pos = w * i + 1, limb = pos >> 5, bit = pos & 31;
    uint32_t win = m[limb] >> bit;
    if (bit + w > 32 && limb < 4) win |= m[limb + 1] << (32 - bit);
    win &= (1u << w) - 1u;
    return 2 * (int)win + 1 - (i < count - 1 ? 1 << w : 0);
}

// the accumulator plus digit i of a half-scalar's recoding times its point:
// R or lambda R from the lane's table (lambda: x times beta), G or lambda G
// from SECP_GTAB scaled onto the table's curve (x zt^2, y zt^3)
HD EcPoint ec_add_digit(const EcPoint &acc, const EcScalar &s, int i,
                        bool is_g, bool lam, const EcAffine tab[8],
                        const U256 &zt2, const U256 &zt3) {
    const int w = is_g ? SECP_WG : SECP_WR;
    const int d = ec_digit(s.m, i, w, is_g ? SECP_DIGITS_G : SECP_DIGITS_R);
    const int idx = ((d < 0 ? -d : d) - 1) >> 1;
    U256 x, y;
    if (is_g) {
        const int base = ((lam ? 1 << (SECP_WG - 1) : 0) + idx) * 16;
        for (int l = 0; l < 8; l++) {
#ifdef __CUDA_ARCH__
            x.w[l] = __ldg(&SECP_GTAB[base + l]);
            y.w[l] = __ldg(&SECP_GTAB[base + 8 + l]);
#else
            x.w[l] = SECP_GTAB[base + l];
            y.w[l] = SECP_GTAB[base + 8 + l];
#endif
        }
        x = fe_mul<false>(x, zt2);
        y = fe_mul<false>(y, zt3);
    } else {
        x = tab[idx].x;
        y = tab[idx].y;
        if (lam) x = fe_mul<false>(x, ec_const(SECP_BETA));
    }
    y = u256_sel((d < 0) != s.neg, fe_neg<false>(y), y);
    return ec_madd(acc, x, y, nullptr);
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
    const U256 y_sq = fe_add<false>(fe_mul<false>(fe_sqr<false>(r), r),
                                    u256_from32(7));
    U256 y = fe_sqrt_pow(y_sq);
    if (!u256_eq(fe_sqr<false>(y), y_sq)) return false;
    y = u256_sel((y.w[0] & 1) != v, fe_neg<false>(y), y);
    // u1 = -e / r, u2 = s / r (mod n); e = digest mod n (digest < 2n)
    const U256 e = u256_lt(digest, n) ? digest : fe_sub<true>(digest, n);
    const U256 r_inv = fe_inv_n(r);
    const U256 u1 = fe_mul<true>(fe_neg<true>(e), r_inv);
    const U256 u2 = fe_mul<true>(s, r_inv);
    // the four half-scalars: G, lambda G (u1), R, lambda R (u2)
    EcScalar ks[4];
    ec_split(u1, &ks[0], &ks[1]);
    ec_split(u2, &ks[2], &ks[3]);
    EcAffine tab[8];
    U256 zt;
    ec_odd_multiples(r, y, tab, &zt);
    const U256 zt2 = fe_sqr<false>(zt);
    const U256 zt3 = fe_mul<false>(zt2, zt);
    // one fixed schedule: a doubling a bit, R's digits every 4 bits and G's
    // every 5, the same in every lane
    EcPoint acc;
    acc.X = acc.Y = acc.Z = u256_zero();
    for (int pos = SECP_TOP_POS; pos >= 0; pos--) {
        if (pos != SECP_TOP_POS) acc = ec_double(acc);
        if (pos % SECP_WR == 0)
            for (int j = 2; j < 4; j++)
                acc = ec_add_digit(acc, ks[j], pos / SECP_WR, false, j == 3,
                                   tab, zt2, zt3);
        if (pos % SECP_WG == 0 && pos / SECP_WG < SECP_DIGITS_G)
            for (int j = 0; j < 2; j++)
                acc = ec_add_digit(acc, ks[j], pos / SECP_WG, true, j == 1,
                                   tab, zt2, zt3);
    }
    // an even half was walked as |k| + 1: subtract its point once (the
    // addition is made in every lane and kept by a select)
    for (int j = 0; j < 4; j++) {
        U256 x, yj;
        if (j < 2) {
            for (int l = 0; l < 8; l++) {
                x.w[l] = SECP_GX[l];
                yj.w[l] = SECP_GY[l];
            }
            if (j == 1) x = fe_mul<false>(x, ec_const(SECP_BETA));
            x = fe_mul<false>(x, zt2);
            yj = fe_mul<false>(yj, zt3);
        } else {
            x = tab[0].x;
            yj = tab[0].y;
            if (j == 3) x = fe_mul<false>(x, ec_const(SECP_BETA));
        }
        yj = u256_sel(ks[j].neg, yj, fe_neg<false>(yj));
        const EcPoint t = ec_madd(acc, x, yj, nullptr);
        if (ks[j].even) acc = t;
    }
    if (u256_is_zero(acc.Z)) return false;
    const U256 zinv = fe_inv_p(fe_mul<false>(acc.Z, zt));
    const U256 zinv2 = fe_sqr<false>(zinv);
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
    keccak_f1600_unit(st);          // K1's compact form: a round a trip
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
