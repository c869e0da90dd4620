"""256-bit limb arithmetic on `[..., 8]` tensors (plain torch).

The counterpart of `era_zk_evm_tpu/ops/u256.py`: limbs are little-endian
u32.  Every op takes either `torch.int32` limbs (the state's carrier for
u32) or `torch.int64` limbs holding values in `[0, 2**32)` ("wide" limbs,
which the plain cycle step uses throughout), computes in int64 and returns
the dtype it was given.  Carry and borrow come back as 0/1 of that dtype,
comparisons as `torch.bool`.  Shift amounts are u32 tensors; a shift by 256
or more yields 0.
"""

from __future__ import annotations

import torch

N = 8
M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def wide(x: torch.Tensor) -> torch.Tensor:
    """u32 carried in int32 (or already wide) -> int64 in [0, 2**32)."""
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 in [0, 2**32) -> `dtype` (int32 keeps the same 32 bits)."""
    if dtype == torch.int64:
        return x
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(dtype)


def from_u32_scalar(x: torch.Tensor) -> torch.Tensor:
    """[...] -> [..., 8] with the high limbs zero."""
    out = torch.zeros(x.shape + (N,), dtype=x.dtype, device=x.device)
    out[..., 0] = x
    return out


# ---------------------------------------------------------------------------
# add / sub / compare
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor):
    """(a + b) mod 2**256 and the carry-out (0/1)."""
    aw, bw = wide(a), wide(b)
    out = torch.empty_like(aw)
    carry = torch.zeros(aw.shape[:-1], dtype=torch.int64, device=aw.device)
    for i in range(N):
        s = aw[..., i] + bw[..., i] + carry
        out[..., i] = s & M32
        carry = s >> 32
    return narrow(out, a.dtype), narrow(carry, a.dtype)


def sub(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2**256 and the borrow-out (0/1)."""
    aw, bw = wide(a), wide(b)
    out = torch.empty_like(aw)
    borrow = torch.zeros(aw.shape[:-1], dtype=torch.int64, device=aw.device)
    for i in range(N):
        d = aw[..., i] - bw[..., i] - borrow
        out[..., i] = d & M32
        borrow = (d < 0).to(torch.int64)
    return narrow(out, a.dtype), narrow(borrow, a.dtype)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _, borrow = sub(a, b)
    return borrow != 0


def gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lt(b, a)


# ---------------------------------------------------------------------------
# bitwise
# ---------------------------------------------------------------------------

def bit_and(a, b):
    return a & b


def bit_or(a, b):
    return a | b


def bit_xor(a, b):
    return a ^ b


def bit_not(a):
    return narrow(~wide(a) & M32, a.dtype)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-lane select: mask is bool [...]; a/b are [..., 8]."""
    return torch.where(mask[..., None], a, b)


# ---------------------------------------------------------------------------
# multiplication: 512-bit product over 16-bit digits
# ---------------------------------------------------------------------------

def mul_full(a: torch.Tensor, b: torch.Tensor):
    """Full 512-bit product -> (low 256, high 256).

    Schoolbook over 16-bit digits: each digit product is below 2**32 and a
    column sums at most 16 of them, far inside int64.
    """
    aw, bw = wide(a), wide(b)
    ad = torch.stack([aw & _M16, aw >> 16], dim=-1).flatten(-2)   # [..., 16]
    bd = torch.stack([bw & _M16, bw >> 16], dim=-1).flatten(-2)
    prod = ad[..., :, None] * bd[..., None, :]                     # [..., 16, 16]
    cols = torch.zeros(aw.shape[:-1] + (32,), dtype=torch.int64,
                       device=aw.device)
    for i in range(16):
        cols[..., i:i + 16] += prod[..., i, :]
    digits = torch.empty_like(cols)
    carry = torch.zeros(aw.shape[:-1], dtype=torch.int64, device=aw.device)
    for k in range(32):
        s = cols[..., k] + carry
        digits[..., k] = s & _M16
        carry = s >> 16
    limbs = digits[..., 0::2] | (digits[..., 1::2] << 16)          # [..., 16]
    return narrow(limbs[..., :N], a.dtype), narrow(limbs[..., N:], a.dtype)


def mul_low(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mul_full(a, b)[0]


# ---------------------------------------------------------------------------
# shifts (per-lane amounts)
# ---------------------------------------------------------------------------

def _limb_shift(aw: torch.Tensor, words: torch.Tensor, left: bool):
    """result[i] = a[i - words] (left) or a[i + words] (right); limbs that
    fall outside the word are 0."""
    i = torch.arange(N, device=aw.device)
    src = i - words[..., None] if left else i + words[..., None]
    ok = (src >= 0) & (src < N)
    got = torch.gather(aw, -1, src.clamp(0, N - 1).expand(aw.shape))
    return torch.where(ok, got, torch.zeros_like(got))


def shl(a: torch.Tensor, n) -> torch.Tensor:
    """a << n per lane; n >= 256 yields 0."""
    aw = wide(a)
    n = wide(torch.as_tensor(n, device=aw.device)).expand(aw.shape[:-1])
    words = n >> 5
    bits = (n & 31)[..., None]
    lo = (_limb_shift(aw, words, True) << bits) & M32
    hi = _limb_shift(aw, words + 1, True) >> (32 - bits)   # bits == 0 -> 0
    out = torch.where((n >= 256)[..., None], torch.zeros_like(aw), lo | hi)
    return narrow(out, a.dtype)


def shr(a: torch.Tensor, n) -> torch.Tensor:
    """a >> n per lane; n >= 256 yields 0."""
    aw = wide(a)
    n = wide(torch.as_tensor(n, device=aw.device)).expand(aw.shape[:-1])
    words = n >> 5
    bits = (n & 31)[..., None]
    lo = _limb_shift(aw, words, False) >> bits
    hi = (_limb_shift(aw, words + 1, False) << (32 - bits)) & M32
    out = torch.where((n >= 256)[..., None], torch.zeros_like(aw), lo | hi)
    return narrow(out, a.dtype)


def rol(a: torch.Tensor, n) -> torch.Tensor:
    """Rotate left: shl(n) | shr(256 - n) (u32 arithmetic on n)."""
    n = wide(torch.as_tensor(n, device=a.device))
    return shl(a, n) | shr(a, (256 - n) & M32)


def ror(a: torch.Tensor, n) -> torch.Tensor:
    n = wide(torch.as_tensor(n, device=a.device))
    return shr(a, n) | shl(a, (256 - n) & M32)


def shl1(a: torch.Tensor) -> torch.Tensor:
    """a << 1 (mod 2**256)."""
    aw = wide(a)
    carry = torch.zeros_like(aw)
    carry[..., 1:] = aw[..., :-1] >> 31
    return narrow(((aw << 1) & M32) | carry, a.dtype)


# ---------------------------------------------------------------------------
# division: binary long division, 256 steps
# ---------------------------------------------------------------------------

def div_mod(a: torch.Tensor, b: torch.Tensor):
    """Unsigned (a // b, a % b); b == 0 lanes return (0, 0)."""
    aw, bw = wide(a), wide(b)
    q = torch.zeros_like(aw)
    r = torch.zeros_like(aw)
    for bit_idx in range(255, -1, -1):
        limb, bit = divmod(bit_idx, 32)
        r = shl1(r)
        r[..., 0] |= (aw[..., limb] >> bit) & 1
        r_minus_b, borrow = sub(r, bw)
        fits = borrow == 0
        r = select(fits, r_minus_b, r)
        q[..., limb] |= fits.to(torch.int64) << bit
    zero = is_zero(bw)
    q = select(zero, torch.zeros_like(q), q)
    r = select(zero, torch.zeros_like(r), r)
    return narrow(q, a.dtype), narrow(r, a.dtype)
