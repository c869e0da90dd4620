"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on u32 halves.

The port of `era_zk_evm_tpu/ops/goldilocks.py`: an element rides as its
(lo, hi) u32 halves, here int64 tensors holding values in [0, 2^32), so a
sum of halves keeps its carry in bit 32 and a product of 16-bit pieces
stays far below 2^63.  The sorted-queue grand products
(`witness/sorted_queue.py`) multiply in this field, the field of zkSync
Era's prover stack.

Reduction identities (as in the JAX module):
    2^64 ≡ 2^32 - 1   (mod p)
    2^96 ≡ -1         (mod p)
so a 128-bit product a + b*2^64 + c*2^96 (a < 2^64; b, c < 2^32) reduces to
a + b*(2^32 - 1) - c, settled with one conditional add or subtract of p.
"""

from __future__ import annotations

import torch

from .u256 import M32

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1

Pair = tuple[torch.Tensor, torch.Tensor]


def _add64(a_lo, a_hi, b_lo, b_hi):
    """64 + 64 -> (lo, hi, carry out)."""
    lo = a_lo + b_lo
    hi = a_hi + b_hi + (lo >> 32)
    return lo & M32, hi & M32, hi >> 32


def _sub64(a_lo, a_hi, b_lo, b_hi):
    """64 - 64 -> (lo, hi, borrow out)."""
    lo = a_lo - b_lo
    hi = a_hi - b_hi - (lo < 0).to(lo.dtype)
    return lo & M32, hi & M32, (hi < 0).to(hi.dtype)


def gl_reduce64(lo: torch.Tensor, hi: torch.Tensor) -> Pair:
    """A full u64 (lo, hi) mod p: at most one subtraction of p.

    p's halves are (1, 2^32 - 1), so x >= p exactly when hi is all ones and
    lo >= 1, and then x - p = (lo - 1, 0).
    """
    ge = (hi == M32) & (lo >= 1)
    return torch.where(ge, lo - 1, lo), torch.where(ge, 0, hi)


def _mul32(a, b):
    """u32 x u32 -> (lo, hi) through 16-bit pieces."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    return lo, hh + (lh >> 16) + (hl >> 16) + (mid >> 16)


def gl_mul(a_lo, a_hi, b_lo, b_hi) -> Pair:
    """(a * b) mod p for canonical inputs (< p)."""
    p00_lo, p00_hi = _mul32(a_lo, b_lo)
    p01_lo, p01_hi = _mul32(a_lo, b_hi)
    p10_lo, p10_hi = _mul32(a_hi, b_lo)
    p11_lo, p11_hi = _mul32(a_hi, b_hi)
    # the 128-bit product's u32 limbs m0..m3, carries in bits 32 and up
    s1 = p00_hi + p01_lo + p10_lo
    s2 = p01_hi + p10_hi + p11_lo + (s1 >> 32)
    m0, m1, m2 = p00_lo, s1 & M32, s2 & M32
    m3 = p11_hi + (s2 >> 32)
    # x = (m0, m1) + m2 * 2^64 + m3 * 2^96 ≡ (m0, m1) + m2 * (2^32 - 1) - m3;
    # m2 * (2^32 - 1) = (m2 << 32) - m2 = ((-m2) mod 2^32, m2 - borrow)
    t_lo = (-m2) & M32
    t_hi = m2 - (m2 != 0).to(m2.dtype)
    z = torch.zeros_like(m0)
    lo, hi, carry = _add64(m0, m1, t_lo, t_hi)
    # fold carries of 2^64 ≡ 2^32 - 1; the second fold cannot carry again
    lo, hi, carry2 = _add64(lo, hi, M32 * carry, z)
    lo, hi, _ = _add64(lo, hi, M32 * carry2, z)
    # subtract m3 (< 2^32); on a borrow add p back
    slo, shi, borrow = _sub64(lo, hi, m3, z)
    blo, bhi, _ = _add64(slo, shi, torch.ones_like(z), z + M32)
    lo = torch.where(borrow != 0, blo, slo)
    hi = torch.where(borrow != 0, bhi, shi)
    return gl_reduce64(lo, hi)


def gl_add(a_lo, a_hi, b_lo, b_hi) -> Pair:
    """(a + b) mod p for canonical inputs."""
    lo, hi, carry = _add64(a_lo, a_hi, b_lo, b_hi)
    # a + b < 2p < 2^65: on a carry the value is lo + hi * 2^32 + 2^64, and
    # 2^64 mod p = 2^32 - 1
    clo, chi, _ = _add64(lo, hi, torch.full_like(lo, M32),
                         torch.zeros_like(lo))
    lo = torch.where(carry != 0, clo, lo)
    hi = torch.where(carry != 0, chi, hi)
    return gl_reduce64(lo, hi)
