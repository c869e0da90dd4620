"""The port's plain secp256k1 (`ops/secp256k1.py`) against the JAX module
and the golden scalar reference, bit for bit (integers: zero tolerance).

  * the field layer on `tests/test_secp256k1_kernel.py`'s vectors, against
    JAX and Python ints, and at the bounds of its loose digits;
  * `scalar_mul` + `to_affine` on that file's scalars, against golden;
  * `ecrecover_batched` on that file's nine cases, 64 random signatures
    and every edge case of the unit against golden `ecrecover_inner` (the
    nine against JAX `ecrecover_batched` run in the VMs'
    ecrecover units, `tests/test_torch_ecrecover.py`);
  * the copies: the curve constants, the Python-int reference and signer,
    and keccak256;
  * the constants that `_build.py` generates for K1's ecrecover unit: the
    endomorphism (lambda, beta) and its lattice split, G's and lambda G's
    odd multiples, the addition chains of its powers.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from era_zk_evm_tpu.golden import precompiles as golden
from era_zk_evm_tpu.ops import secp256k1 as jec
from era_zk_evm_tpu.utils import batch_from_limbs, batch_to_limbs
from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.ops import keccak
from era_zk_evm_tpu_torch.ops import secp256k1 as ec
from era_zk_evm_tpu_torch.testing import ec_programs

import test_secp256k1_kernel


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The plain recovery is many small torch ops: on a loaded CPU, more
    intra-op threads only add their synchronisation (at B=64, 38 s a call
    against 3 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(values):
    """Python ints -> int64 u32 limbs [B, 8]."""
    return torch.from_numpy(batch_to_limbs(values).astype(np.int64))


def _ints(t):
    return batch_from_limbs(t.numpy().astype(np.uint32))


def _vals():
    # tests/test_secp256k1_kernel.py::test_mod_mul_both_moduli
    rng = np.random.default_rng(5)
    return [int.from_bytes(rng.bytes(32), "big") for _ in range(32)]


@pytest.mark.parametrize("name", ["p", "n"])
def test_field_ops_match_jax_and_python(name):
    m = {"p": ec.P_INT, "n": ec.N_INT}[name]
    fold_arr, mod_arr = {"p": (jec._FOLD_P, jec._P),
                         "n": (jec._FOLD_N, jec._N)}[name]
    vals = _vals()
    a, b = vals[:16], vals[16:]
    ja, jb = jnp.asarray(batch_to_limbs(a)), jnp.asarray(batch_to_limbs(b))
    fold, modulus = jec._const(fold_arr, 16), jec._const(mod_arr, 16)
    for op, jop, py in ((ec.mod_mul, jec.mod_mul, lambda x, y: x * y),
                        (ec.mod_add, jec.mod_add, lambda x, y: x + y),
                        (ec.mod_sub, jec.mod_sub, lambda x, y: x - y)):
        got = _ints(op(_t(a), _t(b), m))
        assert got == [py(x, y) % m for x, y in zip(a, b)], op.__name__
        ref = batch_from_limbs(np.asarray(jax.jit(
            lambda x, y: jec.normalize(jop(x, y, fold), modulus))(ja, jb)))
        assert got == ref, op.__name__
    assert _ints(ec.normalize(_t(vals), m)) == [x % m for x in vals]


def test_mod_pow_inverse():
    # tests/test_secp256k1_kernel.py::test_mod_pow_inverse, and for n
    vals = [123456789, ec.P_INT - 5, 2**255 + 17, 31337]
    for m in (ec.P_INT, ec.N_INT):
        got = _ints(ec.mod_pow_const(_t(vals), m - 2, m))
        assert got == [pow(v, -1, m) for v in vals]


@pytest.mark.parametrize("field", ["FP", "FN"])
def test_loose_digits_stay_bounded(field):
    # digits at the top of the loose range: every op's output stays below
    # 2**20 and its canonical residue is exact
    f = getattr(ec, field)
    top = (1 << 20) - 1
    x = torch.full((3, 16), top, dtype=torch.int64)
    x[1, ::2] = 0
    x[2] = torch.arange(16) * 4099 % (1 << 20)

    def value(d):
        return [sum(int(v) << (16 * j) for j, v in enumerate(row))
                for row in d.tolist()]

    vx = value(x)
    for out, want in ((f.mul(x, x), [v * v for v in vx]),
                      (f.add(x, x), [2 * v for v in vx]),
                      (f.sub(x, x.flip(0)), [a - b for a, b
                                             in zip(vx, vx[::-1])]),
                      (f.scale(x, 8), [8 * v for v in vx])):
        assert int(out.max()) < 1 << 20 and int(out.min()) >= 0
        assert value(f.canon(out)) == [w % f.modulus for w in want]


def test_scalar_mul_matches_golden():
    # the scalars of tests/test_secp256k1_kernel.py::TestScalarMul
    rng = np.random.default_rng(9)
    scalars = [1, 2, 3, int.from_bytes(rng.bytes(32), "big") % ec.N_INT,
               ec.N_INT - 1, 0x1234567890ABCDEF]
    B = len(scalars)
    X, Y, Z = ec.scalar_mul(_t(scalars), _t([ec.GX_INT] * B),
                            _t([ec.GY_INT] * B))
    x, y = ec.to_affine(X, Y, Z)
    for i, s in enumerate(scalars):
        want = golden._ec_mul(s, (golden.SECP_GX, golden.SECP_GY))
        assert (_ints(x)[i], _ints(y)[i]) == want, f"scalar {s:#x}"


def _nine_cases():
    """tests/test_secp256k1_kernel.py::test_recover_random_signatures"""
    rng = np.random.default_rng(13)
    cases = []
    for i in range(6):
        d = int.from_bytes(rng.bytes(32), "big") % ec.N_INT or 7
        digest = int.from_bytes(golden.keccak256(bytes([i]) * 11), "big")
        kk = int.from_bytes(rng.bytes(32), "big") % ec.N_INT or 11
        v, r, s = test_secp256k1_kernel._sign(d, digest, kk)
        cases.append((digest, v, r, s))
    cases += [(123, 0, 0, 5), (123, 1, 10, 0), (123, 2, 10, 5)]
    return cases


def _recover(cases):
    digests, vs, rs, ss = zip(*cases)
    return ec.ecrecover_batched(_t(digests), torch.tensor(vs), _t(rs),
                                _t(ss))


def _random_cases(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = int.from_bytes(rng.bytes(32), "big") % ec.N_INT or 7
        digest = int.from_bytes(rng.bytes(32), "big")
        k = int.from_bytes(rng.bytes(32), "big") % ec.N_INT or 11
        out.append((digest,) + test_secp256k1_kernel._sign(d, digest, k))
    return out


def _edge_cases():
    cases = [(dg, vw & 1, r, s)
             for dg, vw, r, s in ec_programs.EDGE_CASES.values()]
    return cases + [(5, 2, 7, 9), (1 << 255, 1, ec.N_INT - 1, 1),
                    (ec.N_INT, 0, 1, 1), (2**256 - 1, 1, 3, ec.N_INT - 1)]


@pytest.mark.parametrize("kind", ["nine", "random", "edges"])
def test_ecrecover_matches_golden(kind):
    cases = {"nine": _nine_cases, "random": lambda: _random_cases(64, 17),
             "edges": _edge_cases}[kind]()
    ok, addr = _recover(cases)
    for i, c in enumerate(cases):
        want = golden.ecrecover_inner(*c) if c[1] <= 1 else None
        assert bool(ok[i]) == (want is not None), (kind, i)
        assert _ints(addr)[i] == (want or 0), (kind, i)
    if kind == "random":
        assert bool(ok.all())
    if kind == "nine":
        assert ok.tolist() == [True] * 6 + [False] * 3


def test_scalar_reference_matches_golden():
    for dg, v, r, s in _random_cases(8, 23) + _edge_cases():
        assert ec.ecrecover_scalar(dg, v, r, s) \
            == golden.ecrecover_inner(dg, v, r, s)
    rng = np.random.default_rng(29)
    for _ in range(4):
        d, dg, k = (int.from_bytes(rng.bytes(32), "big") % ec.N_INT or 3
                    for _ in range(3))
        assert ec.sign(d, dg, k) == test_secp256k1_kernel._sign(d, dg, k)
        assert ec.ec_mul(k, (ec.GX_INT, ec.GY_INT)) \
            == golden._ec_mul(k, (golden.SECP_GX, golden.SECP_GY))
        assert ec.inv_mod(k, ec.N_INT) == golden._inv_mod(k, golden.SECP_N)
        assert ec.ecrecover_scalar(dg, *ec.sign(d, dg, k)) \
            == ec.address_of(d)


def test_constants_match_jax():
    assert (ec.P_INT, ec.N_INT, ec.GX_INT, ec.GY_INT) \
        == (jec.P_INT, jec.N_INT, jec.GX_INT, jec.GY_INT) \
        == (golden.SECP_P, golden.SECP_N, golden.SECP_GX, golden.SECP_GY)
    for name in ("_P", "_N", "_FOLD_P", "_FOLD_N"):
        assert getattr(ec, name) == np.asarray(getattr(jec, name)).tolist()


def _header_limbs(header, name):
    m = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", header)
    return [int(v.strip().rstrip("u"), 16) for v in m.group(1).split(",")]


def test_endomorphism_constants():
    # the ecrecover unit's generated constants (era_zk_evm_tpu_torch/_build.py)
    # against the curve: lambda^3 = 1 mod n, beta^3 = 1 mod p, lambda G =
    # (beta Gx, Gy), the basis in the lattice, the rounding constants
    c = _build.secp_glv()
    n, p = golden.SECP_N, golden.SECP_P
    lam, beta = c["lam"], c["beta"]
    assert lam != 1 and pow(lam, 3, n) == 1
    assert beta != 1 and pow(beta, 3, p) == 1
    g = (golden.SECP_GX, golden.SECP_GY)
    assert golden._ec_mul(lam, g) == (beta * g[0] % p, g[1])
    for a, b in ((c["a1"], c["b1"]), (c["a2"], c["b2"])):
        assert (a + b * lam) % n == 0 and max(abs(a), abs(b)) < 2**129
    assert c["g1"] == (2**384 * c["b2"] + n // 2) // n
    assert c["g2"] == (-(2**384) * c["b1"] + n // 2) // n
    header = _build.generate_header()
    for name, value in (("SECP_BETA", beta), ("SECP_G1", c["g1"]),
                        ("SECP_G2", c["g2"]), ("SECP_A1", c["a1"]),
                        ("SECP_A2", c["a2"]), ("SECP_MINUS_B1", -c["b1"]),
                        ("SECP_B2", c["b2"]), ("SECP_FOLD_P", 2**256 - p),
                        ("SECP_FOLD_N", 2**256 - n)):
        assert _header_limbs(header, name) == ec.to_limbs(value), name
    # the reduction mod p folds by 2**32 + SECP_FOLD_P[0]
    assert 2**256 - p == 2**32 + ec.to_limbs(2**256 - p)[0]


def test_generated_tables_and_chains():
    # G's and lambda G's odd multiples, and the addition chains of the
    # unit's three powers, as the generated header holds them
    header = _build.generate_header()
    words = _header_limbs(header, "SECP_GTAB")
    w = _build.SECP_WINDOW_G
    beta, p = _build.secp_glv()["beta"], golden.SECP_P
    g = (golden.SECP_GX, golden.SECP_GY)
    for t in range(2 * 2 ** (w - 1)):
        x = sum(v << (32 * i) for i, v in enumerate(words[16 * t:16 * t + 8]))
        y = sum(v << (32 * i) for i, v in enumerate(words[16 * t + 8:
                                                          16 * t + 16]))
        k = 2 * (t % 2 ** (w - 1)) + 1
        mx, my = golden._ec_mul(k, g)
        assert (x, y) == ((beta * mx % p if t >= 2 ** (w - 1) else mx), my)
    for e in ((p + 1) // 4, p - 2, golden.SECP_N - 2):
        builds, runs, tail = _build.pow_chain(e)
        ex = {1: 1}
        for length, a, b in builds:
            ex[length] = ex[a] * 2**b + ex[b]
            assert ex[length] == 2**length - 1
        acc = ex[runs[0][1]]
        for z, r in runs[1:]:
            acc = acc * 2 ** (z + r) + ex[r]
        assert acc * 2**tail == e
        # some 256 squares and a few dozen products, where square-and-
        # multiply takes ~500 operations
        squares = sum(b for *_, b in builds) \
            + sum(z + r for z, r in runs[1:]) + tail
        assert squares + len(builds) + len(runs) - 1 <= 320
    # every half of the split, under 2**SECP_SPLIT_BITS, has its digits
    for window in (_build.SECP_WINDOW_R, w):
        m = _build.secp_digits(window)
        k = 2**_build.SECP_SPLIT_BITS - 1
        digits = [2 * ((k >> (window * i + 1)) % 2**window) + 1 - 2**window
                  for i in range(m - 1)] + [2 * (k >> (window * (m - 1) + 1))
                                            + 1]
        assert sum(d << (window * i) for i, d in enumerate(digits)) == k
        assert all(d % 2 and abs(d) < 2**window for d in digits)


@pytest.mark.parametrize("length", [0, 1, 64, 135, 136, 137, 300])
def test_keccak256_matches_golden(length):
    data = bytes((7 * i + length) & 0xFF for i in range(length))
    assert keccak.keccak256(data) == golden.keccak256(data)
