"""The port's plain SHA-256 compression against the JAX batched compression
and the golden scalar one, bit for bit, and its constants against their
source."""

import hashlib

import numpy as np
import jax.numpy as jnp
import torch

from era_zk_evm_tpu.golden import precompiles as golden
from era_zk_evm_tpu.ops import sha256 as jsha
from era_zk_evm_tpu_torch.ops import sha256 as psha
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401


def test_constants_equal_the_golden_ones():
    assert psha.SHA256_K == golden.SHA256_K
    assert psha.SHA256_IV == golden.SHA256_IV
    iv = psha.sha256_iv(3, "cpu").numpy().view(np.uint32)
    assert (iv == np.asarray(jsha.sha256_iv(3))).all()


def test_compress_matches_jax_and_golden():
    rng = np.random.RandomState(7)
    B = 64
    state = rng.randint(0, 1 << 32, size=(B, 8), dtype=np.uint64) \
        .astype(np.uint32)
    block = rng.randint(0, 1 << 32, size=(B, 16), dtype=np.uint64) \
        .astype(np.uint32)
    got = psha.sha256_compress_batched(
        torch.from_numpy(state.view(np.int32)),
        torch.from_numpy(block.view(np.int32))).numpy().view(np.uint32)
    want = np.asarray(jsha.sha256_compress_batched(
        jnp.asarray(state), jnp.asarray(block), unroll=False))
    assert (got == want).all()
    for b in range(B):
        scalar = golden.sha256_compress(
            [int(x) for x in state[b]], block[b].astype(">u4").tobytes())
        assert [int(x) for x in got[b]] == scalar


def test_one_block_message_digest():
    msg = b"abc"
    blk = msg + b"\x80" + bytes(52) + (8 * len(msg)).to_bytes(8, "big")
    words = np.frombuffer(blk, dtype=">u4").astype(np.uint32)
    st = psha.sha256_compress_batched(
        psha.sha256_iv(1, "cpu"), torch.from_numpy(words.view(np.int32))[None])
    digest = st.numpy().view(np.uint32)[0].astype(">u4").tobytes()
    assert digest == hashlib.sha256(msg).digest()
