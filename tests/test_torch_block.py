"""The port's execute_block against the JAX pipeline's
(`execute_block(engine="jnp")`): every TxResult, every per-tx and block
commitment and both grand products, bit for bit, on the six transactions
of `tests/test_block.py` (storage and events, a rolled-back frame, a far
call, arithmetic) at `test_block._config(2)`.  The port runs on CPU tensors.
The precompile block is in `tests/test_torch_precompile.py`, which shares
its config."""

import dataclasses

import pytest

import test_block
from era_zk_evm_tpu.block import execute_block as jax_execute_block
from era_zk_evm_tpu.models import TxSpec as JTxSpec
from era_zk_evm_tpu_torch import block
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu_torch.testing import block_programs as bp

from test_torch_scheduler import assert_same_results
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401


def assert_same_block(ref, got):
    assert_same_results(ref.txs, got.txs)
    assert ref.tx_commitments == got.tx_commitments
    assert ref.commitments == got.commitments
    assert ref.sorted_log_products == got.sorted_log_products
    assert ref.block_log_product == got.block_log_product


@pytest.fixture(scope="module")
def reference():
    txs = [JTxSpec(**dataclasses.asdict(t)) for t in bp.block_txs()]
    return jax_execute_block(test_block._config(2), txs, engine="jnp",
                             chunk=test_block.CHUNK)


@pytest.mark.parametrize("knobs", ["default", "policies"])
def test_execute_block_matches_jax(reference, knobs):
    # against the JAX pipeline's default-policy block: every engine name
    # runs the port's one engine, and the policy knobs and compacted drains
    # are pure (bit-identical BlockResults), so the port's knob run is held
    # against the same reference
    txs, kw = bp.block_txs(), {}
    if knobs == "policies":
        for t, hint in zip(txs, (3, 1, 2)):
            t.cost_hint = hint
        kw = dict(engine="fused", tile=512, spec_depth=3, tail_chunk_mult=2,
                  order="cost_desc", refill_frac=0.5,
                  drain_compact_frac={"memory": 0.5, "log": 0.5,
                                      "decommit": 0.5})
    got = block.execute_block(from_jax_config(test_block._config(2)), txs,
                              chunk=test_block.CHUNK, device="cpu", **kw)
    assert got.all_ok
    assert_same_block(reference, got)
    assert sorted(got.commitments) == ["decommit", "log", "memory"]
    assert got.stats["utilization"] > 0


def test_streams_other_than_packed_raise():
    with pytest.raises(NotImplementedError):
        block.execute_block(from_jax_config(test_block._config(2)),
                            bp.block_txs(), streams="objects", device="cpu")


def test_block_program_copies_equal_their_sources():
    jtxs, callee_words, _ = test_block._block_txs()
    for a, b in zip(bp.block_txs(), jtxs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert assemble_to_code_words(bp.CALLEE) == callee_words
    for name in ("TX_STORAGE", "TX_ROLLBACK", "CALLEE", "TX_FARCALL",
                 "TX_ALU"):
        assert getattr(bp, name) == getattr(test_block, name), name
    assert (bp.BLOCK_ERGS, test_block.CHUNK) == (test_block.ERGS, 24)
