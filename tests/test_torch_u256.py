"""The port's u256 limb ops against `era_zk_evm_tpu.ops.u256`, bit for bit,
on seeded vectors with the edge cases (0, 2**256 - 1, division by zero,
shifts of 256 and more)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from era_zk_evm_tpu.ops import u256 as ju
from era_zk_evm_tpu.utils import batch_to_limbs
from era_zk_evm_tpu_torch.ops import u256 as pu
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

MAX = (1 << 256) - 1
_rng = random.Random(0x7A256)


def _values(n):
    out = [0, MAX, 1, MAX, 1 << 255, 0, 7, MAX - 1]
    while len(out) < n:
        kind = _rng.randrange(4)
        out.append(_rng.getrandbits(256) if kind == 0
                   else _rng.getrandbits(_rng.randrange(1, 256)) if kind == 1
                   else 1 << _rng.randrange(256) if kind == 2
                   else MAX ^ (1 << _rng.randrange(256)))
    return out


A = batch_to_limbs(_values(48))
B = batch_to_limbs(_values(48)[::-1])
B[1] = 0                          # MAX / 0
SHIFTS = np.array([0, 1, 31, 32, 33, 255, 256, 257, 300, 1 << 20]
                  + [_rng.randrange(512) for _ in range(38)], dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
        return x.view(np.uint32) if x.dtype == np.int32 else x
    x = np.asarray(x)
    return x


def _both(j, p):
    j = j if isinstance(j, tuple) else (j,)
    p = p if isinstance(p, tuple) else (p,)
    assert len(j) == len(p)
    for x, y in zip(j, p):
        x, y = np.asarray(x), _np(y)
        if x.dtype == np.bool_:
            assert y.dtype == np.bool_
        assert x.shape == y.shape and (x.astype(np.uint64)
                                       == y.astype(np.uint64)).all()


ja, jb, js = jnp.asarray(A), jnp.asarray(B), jnp.asarray(SHIFTS)
ta, tb, ts = _t(A), _t(B), _t(SHIFTS)
MASK = np.array([_rng.random() < 0.5 for _ in range(48)])

OPS = {
    "add": (lambda: ju.add(ja, jb), lambda: pu.add(ta, tb)),
    "sub": (lambda: ju.sub(ja, jb), lambda: pu.sub(ta, tb)),
    "is_zero": (lambda: ju.is_zero(ja), lambda: pu.is_zero(ta)),
    "eq": (lambda: ju.eq(ja, jb), lambda: pu.eq(ta, tb)),
    "eq_self": (lambda: ju.eq(ja, ja), lambda: pu.eq(ta, ta)),
    "lt": (lambda: ju.lt(ja, jb), lambda: pu.lt(ta, tb)),
    "gt": (lambda: ju.gt(ja, jb), lambda: pu.gt(ta, tb)),
    "and": (lambda: ju.bit_and(ja, jb), lambda: pu.bit_and(ta, tb)),
    "or": (lambda: ju.bit_or(ja, jb), lambda: pu.bit_or(ta, tb)),
    "xor": (lambda: ju.bit_xor(ja, jb), lambda: pu.bit_xor(ta, tb)),
    "not": (lambda: ju.bit_not(ja), lambda: pu.bit_not(ta)),
    "select": (lambda: ju.select(jnp.asarray(MASK), ja, jb),
               lambda: pu.select(torch.from_numpy(MASK), ta, tb)),
    "mul_full": (lambda: ju.mul_full(ja, jb), lambda: pu.mul_full(ta, tb)),
    "mul_low": (lambda: ju.mul_low(ja, jb), lambda: pu.mul_low(ta, tb)),
    "shl": (lambda: ju.shl(ja, js), lambda: pu.shl(ta, ts)),
    "shr": (lambda: ju.shr(ja, js), lambda: pu.shr(ta, ts)),
    "rol": (lambda: ju.rol(ja, js & 0xFF), lambda: pu.rol(ta, ts & 0xFF)),
    "ror": (lambda: ju.ror(ja, js & 0xFF), lambda: pu.ror(ta, ts & 0xFF)),
    "shl1": (lambda: ju.shl1(ja), lambda: pu.shl1(ta)),
    "div_mod": (lambda: ju.div_mod(ja, jb), lambda: pu.div_mod(ta, tb)),
    "from_u32_scalar": (lambda: ju.from_u32_scalar(js),
                        lambda: pu.from_u32_scalar(ts)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(op):
    jfn, pfn = OPS[op]
    _both(jfn(), pfn())


def test_wide_limbs_give_the_same_bits():
    """int64-held limbs (the plain cycle step's carrier) give the same
    results as int32 limbs."""
    wa, wb = pu.wide(ta), pu.wide(tb)
    for name in ("add", "sub", "mul_full", "div_mod"):
        narrow = getattr(pu, name)(ta, tb)
        wide = getattr(pu, name)(wa, wb)
        for x, y in zip(narrow, wide):
            assert y.dtype == torch.int64
            assert (pu.wide(x) == y).all()
