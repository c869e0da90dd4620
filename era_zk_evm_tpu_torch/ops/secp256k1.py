"""secp256k1 signature recovery, batched, in plain torch.

The counterpart of `era_zk_evm_tpu/ops/secp256k1.py` and the plain version
of K1's ecrecover unit (`csrc/secp256k1.cuh`).  `ecrecover_batched(digest,
v, r, s)` returns `(ok, address)` per lane: `ok` false for r or s outside
[1, n), v > 1, an r that is no curve x coordinate, or a recovered point at
infinity; the address is the low 160 bits of keccak256 of the public key
(zero where not ok).  Both outputs are canonical, so any exact arithmetic
gives the JAX package's bits; this module is written for few torch ops, not
to mirror the JAX formulas step by step:

  * A field element is 16 little-endian digits of 16 bits in int64, kept
    "loose" between operations: each digit in [0, 2**20), the value any
    residue of its class.  A digit product is below 2**40 and a column of
    the 256 x 256-bit product below 2**44, so the whole product is one
    broadcast multiply and a diagonal sum, and no Python loop runs over
    digits.  Three carry rounds bring the columns to at most 2**16 each;
    the high 18 columns fold back through the table of 2**(16k) mod m, and
    a few carry rounds whose top carry folds with 2**256 mod m bring every
    digit under 2**20 again (`Field.mul`; the round counts are derived in
    `Field`'s docstring).
  * Only zero tests, parities and outputs need the canonical residue
    (`Field.canon`): a carry-lookahead resolves the last carries exactly.
  * Q = u1 G + u2 R is a ladder: MSB first, a doubling and the addition
    of G, R or G + R per bit (Shamir's trick), with Jacobian formulas whose
    edge cases (a point at infinity, equal or opposite points) are resolved
    by selects, as in the JAX package.  Inversions and the square root are
    fixed-exponent powers over 4-bit windows.  (K1's unit computes the
    same outputs another way: an endomorphism split in fixed windows,
    csrc/secp256k1.cuh; `ecrecover_unit` runs it alone on the card.)

The curve constants and the Python-int references are the port's golden
oracle's (`golden/precompiles.py`'s secp256k1 section: `ecrecover_scalar`
is its `ecrecover_inner`); they and a signer serve the test programs.
Inputs are u32 limbs `[B, 8]` (int32 or int64, see `ops/u256.py`); limb
outputs are int64 holding u32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..golden.precompiles import (  # noqa: F401 (re-exported references)
    SECP_GX as GX_INT, SECP_GY as GY_INT, SECP_N as N_INT, SECP_P as P_INT,
    _ec_mul as ec_mul, _inv_mod as inv_mod,
    ecrecover_inner as ecrecover_scalar,
)
from .keccak import keccak256, keccak_f1600_lanes
from .u256 import M32, wide


def to_limbs(x: int) -> list[int]:
    """A 256-bit int as 8 little-endian u32 limbs."""
    return [(x >> (32 * i)) & M32 for i in range(8)]


_P = to_limbs(P_INT)
_N = to_limbs(N_INT)
_FOLD_P = to_limbs(2**256 - P_INT)     # 2**32 + 977
_FOLD_N = to_limbs(2**256 - N_INT)

_DM = 0xFFFF                           # digit mask
_HIGH = 18                             # product columns 16..33 fold back
_SUB_BIAS = 21                         # every digit of the subtrahend bias


def _digits(x: int) -> list[int]:
    return [(x >> (16 * j)) & _DM for j in range(16)]


def _carry(d: torch.Tensor) -> torch.Tensor:
    """One parallel carry round that keeps the value (the top digit's own
    carry must be zero)."""
    t = d >> 16
    d = d & _DM
    d[..., 1:] += t[..., :-1]
    return d


def _resolve(d: torch.Tensor):
    """Exact carries of digits in [0, 2**32): (digits in [0, 2**16), the
    value's multiple of 2**256)."""
    d = _carry(_carry(F.pad(d, (0, 1))))        # digits 0..15 at most 2**16
    low, top = d[..., :16], d[..., 16]
    gen = low == 1 << 16
    idx = torch.arange(16, device=d.device)
    # the carry out of digit j is `gen` at the last digit <= j that does
    # not propagate (is not 0xFFFF), and 0 if there is none
    last = torch.where(low != _DM, idx, -1).cummax(-1).values
    out = torch.gather(gen, -1, last.clamp(min=0)) & (last >= 0)
    low = (low + F.pad(out[..., :-1], (1, 0))) & _DM
    return low, top + out[..., 15]


class Field:
    """Arithmetic modulo m < 2**256 on loose digits (see the module
    docstring); tables per device.

    Round counts, from digit bounds.  A product's folded digits are below
    2**37; a round with top fold f (digits of 2**256 - m) maps a bound M to
    2**16 + M / 2**16 + (top carry) * max(f).  For p, f = (977, 0, 1), so
    two rounds reach 2**17.  For n, f has 129 bits: 2**37 -> 2**37 -> 2**22
    -> 2**17 + 2**6, three rounds.  A sum, a difference with the bias, or a
    multiple by k <= 8 is below 2**24: one round for p (digit 0 below
    2**18), two for n (a top carry of at most 1 on the second)."""

    def __init__(self, modulus: int, mul_rounds: int, add_rounds: int):
        self.modulus = modulus
        self.mul_rounds = mul_rounds
        self.add_rounds = add_rounds
        self._tables = {}

    def tables(self, device) -> dict:
        t = self._tables.get(device)
        if t is None:
            m = self.modulus
            bias = sum(1 << (_SUB_BIAS + 16 * j) for j in range(16))

            def tensor(rows):
                return torch.tensor(rows, dtype=torch.int64, device=device)

            t = self._tables[device] = dict(
                high=tensor([_digits(pow(2, 16 * k, m))
                             for k in range(16, 16 + _HIGH)]),
                fold=tensor(_digits(2**256 - m)),
                # a multiple of m whose every digit is in [2**21, 2**21 +
                # 2**16): a - b + bias has no negative digit
                bias=tensor([(1 << _SUB_BIAS) + d
                             for d in _digits(-bias % m)]))
        return t

    def _rounds(self, d: torch.Tensor, n: int) -> torch.Tensor:
        fold = self.tables(d.device)["fold"]
        for _ in range(n):
            t = d >> 16
            d = d & _DM
            d[..., 1:] += t[..., :-1]
            d = d + t[..., 15:] * fold
        return d

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        prod = a.unsqueeze(-1) * b.unsqueeze(-2)               # [..., 16, 16]
        # diagonal sums: row i shifted right by i, by padding each row to
        # 35 and reading the flat rows with a stride of 34
        flat = F.pad(prod, (0, 19)).flatten(-2)[..., :16 * 34]
        cols = flat.unflatten(-1, (16, 34)).sum(-2)             # [..., 34]
        cols = _carry(_carry(_carry(cols)))
        d = cols[..., :16] + (cols[..., 16:, None]
                              * self.tables(a.device)["high"]).sum(-2)
        return self._rounds(d, self.mul_rounds)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._rounds(a + b, self.add_rounds)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._rounds(a + self.tables(a.device)["bias"] - b,
                            self.add_rounds)

    def scale(self, a: torch.Tensor, k: int) -> torch.Tensor:
        """k * a for 1 <= k <= 8."""
        return self._rounds(a * k, self.add_rounds)

    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """The canonical residue in [0, m), as digits in [0, 2**16)."""
        fold = self.tables(a.device)["fold"]
        low, top = _resolve(a)                  # top < 2**5
        low, top = _resolve(low + top[..., None] * fold)
        low, _ = _resolve(low + top[..., None] * fold)   # now < 2**256
        # one subtraction of m where low >= m, i.e. low + (2**256 - m)
        # carries out
        w, over = _resolve(low + fold)
        return torch.where(over[..., None] != 0, w, low)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        c = self.canon(a)
        return (c == 0).all(-1)

    def pow(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x ** e for a fixed e >= 1, over 4-bit windows."""
        table = [None, x]
        for _ in range(14):
            table.append(self.mul(table[-1], x))
        acc = None
        for shift in range((e.bit_length() - 1) // 4 * 4, -1, -4):
            if acc is not None:
                for _ in range(4):
                    acc = self.mul(acc, acc)
            w = (e >> shift) & 15
            if w:
                acc = table[w] if acc is None else self.mul(acc, table[w])
        return acc


FP = Field(P_INT, mul_rounds=2, add_rounds=1)
FN = Field(N_INT, mul_rounds=3, add_rounds=2)


def to_digits(limbs: torch.Tensor) -> torch.Tensor:
    """u32 limbs [..., 8] -> 16-bit digits [..., 16] (int64)."""
    w = wide(limbs)
    return torch.stack([w & _DM, w >> 16], -1).flatten(-2)


def from_digits(d: torch.Tensor) -> torch.Tensor:
    """Digits in [0, 2**16) -> u32 limbs (int64)."""
    return d[..., 0::2] | (d[..., 1::2] << 16)


def _field(modulus_int: int) -> Field:
    return {P_INT: FP, N_INT: FN}[modulus_int]


# ---------------------------------------------------------------------------
# limb-level field operations (the JAX module's names; where those take a
# fold constant and a modulus array, these take the modulus as an int)
# ---------------------------------------------------------------------------

def mod_add(a, b, modulus: int = P_INT) -> torch.Tensor:
    f = _field(modulus)
    return from_digits(f.canon(f.add(to_digits(a), to_digits(b))))


def mod_sub(a, b, modulus: int = P_INT) -> torch.Tensor:
    f = _field(modulus)
    return from_digits(f.canon(f.sub(to_digits(a), to_digits(b))))


def mod_mul(a, b, modulus: int = P_INT) -> torch.Tensor:
    f = _field(modulus)
    return from_digits(f.canon(f.mul(to_digits(a), to_digits(b))))


def normalize(a, modulus: int = P_INT) -> torch.Tensor:
    """A residue in [0, 2**256) -> [0, m)."""
    return from_digits(_field(modulus).canon(to_digits(a)))


def mod_pow_const(base, exponent: int, modulus: int = P_INT) -> torch.Tensor:
    f = _field(modulus)
    return from_digits(f.canon(f.pow(to_digits(base), exponent)))


# ---------------------------------------------------------------------------
# Jacobian points over p (a = 0), digit tensors (X, Y, Z); Z == 0 mod p is
# the point at infinity
# ---------------------------------------------------------------------------

def _pt_double(X, Y, Z):
    f = FP
    A = f.mul(X, X)
    Bv = f.mul(Y, Y)
    C = f.mul(Bv, Bv)
    XB = f.add(X, Bv)
    D = f.scale(f.sub(f.sub(f.mul(XB, XB), A), C), 2)
    E = f.scale(A, 3)
    X3 = f.sub(f.mul(E, E), f.scale(D, 2))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), f.scale(C, 8))
    Z3 = f.scale(f.mul(Y, Z), 2)
    return X3, Y3, Z3


def _sel(mask, a, b):
    return torch.where(mask[..., None], a, b)


def _pt_add(P1, P2, z2_zero=None):
    """P1 + P2, every edge case resolved by selects: a point at infinity,
    equal points (doubling), opposite points (infinity).  `z2_zero` may
    give P2's infinity flags when they are known."""
    f = FP
    (X1, Y1, Z1), (X2, Y2, Z2) = P1, P2
    Z1Z1, Z2Z2 = f.mul(Z1, Z1), f.mul(Z2, Z2)
    U1, U2 = f.mul(X1, Z2Z2), f.mul(X2, Z1Z1)
    S1 = f.mul(Y1, f.mul(Z2, Z2Z2))
    S2 = f.mul(Y2, f.mul(Z1, Z1Z1))
    H, R = f.sub(U2, U1), f.sub(S2, S1)
    tests = [Z1, H, R] + ([Z2] if z2_zero is None else [])
    zero = f.is_zero(torch.stack(tests))
    z1_zero, h_zero, r_zero = zero[0], zero[1], zero[2]
    if z2_zero is None:
        z2_zero = zero[3]
    HH = f.mul(H, H)
    HHH = f.mul(HH, H)
    V = f.mul(U1, HH)
    X3 = f.sub(f.sub(f.mul(R, R), HHH), f.scale(V, 2))
    Y3 = f.sub(f.mul(R, f.sub(V, X3)), f.mul(S1, HHH))
    Z3 = f.mul(f.mul(Z1, Z2), H)
    out = [X3, Y3, Z3]
    same = h_zero & r_zero
    if bool(same.any()):
        out = [_sel(same, d, o) for d, o in zip(_pt_double(X1, Y1, Z1), out)]
    opposite = h_zero & ~r_zero
    out = [_sel(opposite, torch.zeros_like(o), o) for o in out]
    out = [_sel(z1_zero, b, o) for b, o in zip(P2, out)]
    only2 = z2_zero & ~z1_zero
    return tuple(_sel(only2, a, o) for a, o in zip(P1, out))


def _joint_mul(u1, u2, P1, P2):
    """u1 P1 + u2 P2 for canonical digit scalars: MSB first, a doubling and
    the addition of P1, P2 or P1 + P2 per bit (Shamir's trick)."""
    B, dev = u1.shape[0], u1.device
    inf = tuple(torch.zeros((B, 16), dtype=torch.int64, device=dev)
                for _ in range(3))
    table = [inf, P1, P2, _pt_add(P1, P2)]
    TX, TY, TZ = (torch.stack([t[c].expand(B, 16) for t in table])
                  for c in range(3))
    t_inf = FP.is_zero(TZ)                                   # [4, B]
    lanes = torch.arange(B, device=dev)
    acc = inf
    for bit in range(255, -1, -1):
        acc = _pt_double(*acc)
        k, sh = divmod(bit, 16)
        idx = ((u1[:, k] >> sh) & 1) + 2 * ((u2[:, k] >> sh) & 1)
        acc = _pt_add(acc, (TX[idx, lanes], TY[idx, lanes], TZ[idx, lanes]),
                      z2_zero=t_inf[idx, lanes])
    return acc


def _affine_digits(X, Y, Z):
    zinv = FP.pow(Z, P_INT - 2)
    zinv2 = FP.mul(zinv, zinv)
    return (FP.canon(FP.mul(X, zinv2)),
            FP.canon(FP.mul(Y, FP.mul(zinv2, zinv))))


def scalar_mul(k, px, py):
    """k (px, py) on the curve, as Jacobian limbs (X, Y, Z)."""
    P = (to_digits(px), to_digits(py), _const(1, px.shape[0], px.device))
    zero = torch.zeros_like(P[0])
    return tuple(from_digits(FP.canon(c))
                 for c in _joint_mul(to_digits(k), zero, P, P))


def to_affine(X, Y, Z):
    """Jacobian limbs -> canonical affine limbs (x, y)."""
    x, y = _affine_digits(to_digits(X), to_digits(Y), to_digits(Z))
    return from_digits(x), from_digits(y)


# ---------------------------------------------------------------------------
# ecrecover
# ---------------------------------------------------------------------------

def _const(x: int, B: int, device) -> torch.Tensor:
    """The digits of x, for B lanes."""
    return torch.tensor(_digits(x), dtype=torch.int64,
                        device=device).expand(B, 16)


def _lt(a: torch.Tensor, bound: list[int]) -> torch.Tensor:
    """a < bound for u32 limbs, compared from the top limb."""
    b = torch.tensor(bound, dtype=torch.int64, device=a.device)
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for i in range(7, -1, -1):
        lt = lt | (eq & (a[..., i] < b[i]))
        eq = eq & (a[..., i] == b[i])
    return lt


def _pubkey_address(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """The low 160 bits of keccak256(qx || qy) (big-endian 32 bytes each)
    as u32 limbs [B, 8], from canonical limbs."""
    def bswap(x):
        return ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) \
            | ((x >> 8) & 0xFF00) | (x >> 24)

    B = qx.shape[0]
    lanes = torch.zeros((25, B), dtype=torch.int64, device=qx.device)
    for k in range(4):
        lanes[k] = (bswap(qx[:, 6 - 2 * k]) << 32) | bswap(qx[:, 7 - 2 * k])
        lanes[4 + k] = (bswap(qy[:, 6 - 2 * k]) << 32) \
            | bswap(qy[:, 7 - 2 * k])
    lanes[8] ^= 0x01                        # keccak padding of 64 bytes
    lanes[16] ^= -(1 << 63)                 # 0x80 in byte 135
    lanes = keccak_f1600_lanes(lanes)
    byte = [(lanes[i // 8] >> (8 * (i % 8))) & 0xFF for i in range(32)]
    addr = torch.zeros((B, 8), dtype=torch.int64, device=qx.device)
    for j in range(5):
        addr[:, j] = (byte[28 - 4 * j] << 24) | (byte[29 - 4 * j] << 16) \
            | (byte[30 - 4 * j] << 8) | byte[31 - 4 * j]
    return addr


def ecrecover_batched(digest, v, r, s):
    """Batched address recovery.

    digest / r / s: u32 limbs [B, 8]; v: [B] (the recovery bit; > 1 fails).
    Returns (ok bool[B], address int64 limbs [B, 8]: the low 160 bits of
    keccak256 of the public key, zero where not ok)."""
    return _ecrecover(wide(digest), wide(v), wide(r), wide(s))


#: launches of the unit alone (csrc/cycle_kernel_ec.cu, ec_unit_kernel)
EC_UNIT_LAUNCHES = 0


def ecrecover_unit(digest, v, r, s):
    """`ecrecover_batched` through K1's ecrecover unit alone, a signature a
    thread, on CUDA tensors (digest, r, s int32 [B, 8] u32 limbs, v int32
    [B]); the plain `ecrecover_batched` on CPU tensors.  Returns (ok bool
    [B], address int64 [B, 8])."""
    global EC_UNIT_LAUNCHES
    device = digest.device
    if device.type == "cpu":
        return ecrecover_batched(digest, v, r, s)
    if device.type != "cuda":
        raise ValueError(f"no ecrecover kernel for device {device}")
    from .._build import load

    n = digest.shape[0]
    for name, t, shape in (("digest", digest, (n, 8)), ("v", v, (n,)),
                           ("r", r, (n, 8)), ("s", s, (n, 8))):
        if t.device != device or t.dtype != torch.int32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32{list(shape)}"
                             f" on {device}, got {t.dtype}{list(t.shape)} on "
                             f"{t.device}")
    ok = torch.empty((n,), dtype=torch.int32, device=device)
    addr = torch.empty((n, 8), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load().eravm_ecrecover_launch(
        *(t.data_ptr() for t in (digest, v, r, s, ok, addr)), n, stream)
    if rc != 0:
        raise RuntimeError(f"ecrecover launch failed: cudaError {rc}")
    EC_UNIT_LAUNCHES += 1
    return ok != 0, addr.to(torch.int64) & M32


def _ecrecover(digest, v, r, s):
    B, dev = r.shape[0], r.device
    ok = (r != 0).any(-1) & (s != 0).any(-1) & _lt(r, _N) & _lt(s, _N) \
        & (v <= 1)
    # lift x = r to a point: y = sqrt(x^3 + 7), of the requested parity
    x = to_digits(r)
    y_sq = FP.add(FP.mul(FP.mul(x, x), x), _const(7, B, dev))
    y = FP.pow(y_sq, (P_INT + 1) // 4)
    ok &= (FP.canon(FP.mul(y, y)) == FP.canon(y_sq)).all(-1)
    y = FP.canon(y)
    y = torch.where(((y[:, 0] & 1) != v)[:, None],
                    FP.canon(FP.sub(torch.zeros_like(y), y)), y)
    # Q = u1 G + u2 R with u1 = -e / r, u2 = s / r (mod n)
    r_inv = FN.pow(x, N_INT - 2)
    u1 = FN.canon(FN.mul(FN.sub(torch.zeros_like(x), to_digits(digest)),
                         r_inv))
    u2 = FN.canon(FN.mul(to_digits(s), r_inv))
    one = _const(1, B, dev)
    G = (_const(GX_INT, B, dev), _const(GY_INT, B, dev), one)
    Q = _joint_mul(u1, u2, G, (x, y, one))
    ok &= ~FP.is_zero(Q[2])
    qx, qy = _affine_digits(*Q)
    addr = _pubkey_address(from_digits(qx), from_digits(qy))
    return ok, torch.where(ok[:, None], addr, torch.zeros_like(addr))


# ---------------------------------------------------------------------------
# a signer for test vectors (the Python-int references are golden's:
# `ec_mul`, `inv_mod`, `ecrecover_scalar`, imported above)
# ---------------------------------------------------------------------------

def _g_mul(k: int):
    """k G for 0 < k < n, in Jacobian Python ints with one inversion (the
    signer's fast path; `ec_mul` inverts at every step)."""
    p = P_INT

    def double(X, Y, Z):
        A, B = X * X % p, Y * Y % p
        C = B * B % p
        D = 2 * ((X + B) ** 2 - A - C) % p
        E = 3 * A % p
        X3 = (E * E - 2 * D) % p
        return X3, (E * (D - X3) - 8 * C) % p, 2 * Y * Z % p

    def add_affine(X, Y, Z, x, y):          # (X, Y, Z) != +-(x, y)
        ZZ = Z * Z % p
        H = (x * ZZ - X) % p
        R = (y * ZZ * Z - Y) % p
        HH = H * H % p
        HHH, V = HH * H % p, X * HH % p
        X3 = (R * R - HHH - 2 * V) % p
        return X3, (R * (V - X3) - Y * HHH) % p, Z * H % p

    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = double(*acc)
        if bit == "1":
            acc = (GX_INT, GY_INT, 1) if acc is None \
                else add_affine(*acc, GX_INT, GY_INT)
    X, Y, Z = acc
    zi = inv_mod(Z, p)
    return X * zi * zi % p, Y * zi * zi * zi % p


def address_of(d: int) -> int:
    """The address of private key d."""
    qx, qy = _g_mul(d)
    return int.from_bytes(
        keccak256(qx.to_bytes(32, "big") + qy.to_bytes(32, "big"))[12:],
        "big")


def sign(d: int, digest: int, k: int) -> tuple[int, int, int]:
    """(v, r, s) of digest under key d with nonce k, s in the low half."""
    R = _g_mul(k)
    r = R[0] % N_INT
    s = inv_mod(k, N_INT) * (digest + r * d) % N_INT
    v = R[1] & 1
    if s > N_INT // 2:
        s = N_INT - s
        v ^= 1
    return v, r, s
