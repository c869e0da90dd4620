"""The port's batched equal-length keccak256 and sha256 helpers
(`ops/keccak.py`: `pad_messages`, `absorb_blocks`, `digest_from_state`,
`keccak256_batched`; `ops/sha256.py`: `sha256_blocks`) against the JAX
package's numpy padding, the golden keccak256, the permutation on Python
ints and `hashlib`, on the cases of `tests/test_keccak_kernel.py` and
`tests/test_sha256_kernel.py`.
On CPU tensors the helpers run the plain version of K3; no XLA program is
compiled (the JAX helpers used here are numpy)."""

import hashlib

import numpy as np
import pytest
import torch

from era_zk_evm_tpu.ops import keccak as jkeccak
from era_zk_evm_tpu_torch.golden.precompiles import keccak256
from era_zk_evm_tpu_torch.ops import keccak, sha256

from test_sha256_kernel import _to_blocks
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

LENGTHS = (0, 1, 50, 135, 136, 137, 200, 272)   # test_keccak_kernel.py


def _messages(length, n=4):
    return [bytes([(i * 7 + j) % 256 for j in range(length)])
            for i in range(n)]


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("length", LENGTHS)
def test_pad_messages_equals_jax(length):
    msgs = _messages(length)
    got = keccak.pad_messages(msgs)
    want = jkeccak.pad_messages(msgs)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got == want).all()
    one = msgs[0]
    assert (keccak.pad_messages(one) == jkeccak.pad_messages(one)).all()


def test_absorb_blocks_equals_the_permutation_block_by_block():
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 1 << 32, size=(6, 3, 34), dtype=np.uint32)
    got = keccak.absorb_blocks(_i32(blocks)).numpy().view(np.uint32)
    for b in range(blocks.shape[0]):
        lanes = [0] * 25
        for blk in blocks[b]:
            for k in range(17):
                lanes[k] ^= int(blk[2 * k]) | (int(blk[2 * k + 1]) << 32)
            lanes = keccak.keccak_f1600_ints(lanes)
        want = [[x & 0xFFFFFFFF, x >> 32] for x in lanes]
        assert got[b].tolist() == want


@pytest.mark.parametrize("length", LENGTHS)
def test_keccak256_batched_equals_golden(length):
    msgs = _messages(length)
    digests = keccak.digest_from_state(
        keccak.keccak256_batched(_i32(keccak.pad_messages(msgs))))
    assert digests == [keccak256(m) for m in msgs]


def test_known_vector():
    digests = keccak.digest_from_state(keccak.absorb_blocks(
        _i32(keccak.pad_messages([b"", b"", b""]))))
    assert digests[0].hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"


def test_absorb_blocks_checks_its_input():
    with pytest.raises(ValueError):
        keccak.absorb_blocks(torch.zeros((2, 1, 17), dtype=torch.int32))
    with pytest.raises(ValueError):
        keccak.absorb_blocks(torch.zeros((2, 1, 34), dtype=torch.int64))


@pytest.mark.parametrize("msg", [b"", b"abc", b"a" * 55, b"b" * 56,
                                 bytes(range(200))])
def test_sha256_blocks_equals_hashlib(msg):
    out = sha256.sha256_blocks(_i32(_to_blocks([msg] * 3)))
    words = out.numpy().view(np.uint32)
    for b in range(3):
        digest = b"".join(int(x).to_bytes(4, "big") for x in words[b])
        assert digest == hashlib.sha256(msg).digest(), msg
