"""Configs whose precompile settings outrun their units, against the JAX jnp
engine `run_cycles`: every BatchedVmState field, bit for bit.

The JAX jnp engine runs these configs with the units simply off: the LOG
unit needs `storage_slots > 0`, the precompile units need it and
`precompile_keccak_blocks > 0`, and without them ecrecover and the
precompile queue are inert (`era_zk_evm_tpu/models/batched_vm.py`,
`precompile_enabled and log_enabled`).  The port runs them the same way.
Two configs cover the four cases:

  * X: the units and ecrecover asked for, a precompile queue, no storage:
    every LOG opcode sets `lane_error`;
  * Y: storage, ecrecover and a precompile queue, but no keccak blocks: the
    LOG unit runs, `log.precompile` sets `lane_error`.

Each runs a plain arithmetic and heap lane, a `log.precompile` lane at the
keccak256 precompile's address and an sstore / sload lane
(`era_zk_evm_tpu_torch/testing/units_off.py`).  Neither config traces the
JAX unit code, so each compiles one small XLA program.
`expect_lane_errors` is the short port-only run the config tests share.
"""

import dataclasses

import numpy as np
import pytest

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig, make_entry_state, run_cycles
from era_zk_evm_tpu_torch import block
from era_zk_evm_tpu_torch.config import check_slice, from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import units_off as uo
from era_zk_evm_tpu_torch.witness.commitment import (
    block_commitment, commit_precompile_queue,
)

from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

N_CYCLES, ERGS = uo.N_CYCLES, uo.ERGS
PROGRAMS, ENTRY, LANE_ERRORS = uo.PROGRAMS, uo.ENTRY, uo.LANE_ERRORS
#: the JAX configs equal to the port's X and Y
CONFIGS = {name: VmConfig(**dataclasses.asdict(pc))
           for name, pc in uo.configs().items()}


def _port_run(pc, programs, entry):
    st = pstate.make_entry_state(pc, programs, ergs=ERGS, entry_address=entry,
                                 device="cpu")
    return fused_cycle.run_cycles(st, pc, N_CYCLES)


def expect_lane_errors(pc) -> None:
    """Run the three lanes on the port (CPU) under config `pc`, batch
    taken from it, and check the lane_error pattern its units give: LOG
    opcodes need the LOG unit, `log.precompile` the precompile units, an
    sstore a journal slot; the precompile queue stays at its initial
    values without the units."""
    check_slice(pc)
    pc = dataclasses.replace(pc, batch=3)
    words = [assemble_to_code_words(s) for s in PROGRAMS]
    st = _port_run(pc, words, ENTRY)
    log_on = pc.storage_slots > 0
    units_on = log_on and pc.precompile_keccak_blocks > 0
    sstore_ok = log_on and pc.journal_slots > 0
    assert st.lane_error.tolist() == [False, not units_on, not sstore_ok]
    assert bool(st.done.all())
    if not units_on:
        assert int(st.pq_count.abs().sum()) == 0
        assert int(st.pq_blocks.abs().sum()) == 0
        assert int(st.pq_flags.abs().sum()) == 0


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    config = CONFIGS[request.param]
    words = [assemble_to_code_words(s) for s in PROGRAMS]
    ref = run_cycles(make_entry_state(config, words, ergs=ERGS,
                                      entry_address=ENTRY), config, N_CYCLES)
    ref = {f.name: np.asarray(getattr(ref, f.name))
           for f in dataclasses.fields(ref)}
    got = pstate.state_to_numpy(_port_run(from_jax_config(config), words,
                                          ENTRY))
    return request.param, ref, got


def test_units_off_match_jax_jnp(runs):
    name, ref, got = runs
    bad = [k for k in ref if ref[k].dtype != got[k].dtype
           or ref[k].shape != got[k].shape or not (ref[k] == got[k]).all()]
    assert not bad, f"config {name}: port/jax mismatch in fields: {bad}"
    assert got["lane_error"].tolist() == LANE_ERRORS[name]
    assert got["done"].all()
    # the precompile queue keeps its shapes and initial values
    cap = CONFIGS[name].precompile_queue_capacity
    assert got["pq_meta"].shape == (3, cap, 4)
    assert not got["pq_count"].any() and not got["pq_blocks"].any()
    if name == "Y":
        assert got["lq_count"][2] > 0 and got["st_count"][2] == 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_units_off_execute_block_commits_an_empty_precompile_family(name):
    # a precompile queue with no rows written drains and commits as an
    # empty family: each tx's precompile digest is that of no queries
    pc = dataclasses.replace(from_jax_config(CONFIGS[name]), batch=2,
                             queue_capacity=64 * 8,
                             precompile_queue_capacity=64 * 8)
    if pc.storage_slots:
        pc = dataclasses.replace(pc, log_queue_capacity=64)
    txs = [block.TxSpec(program=assemble_to_code_words(src),
                        entry_address=addr)
           for src, addr in zip(PROGRAMS * 2, ENTRY * 2)]
    res = block.execute_block(pc, txs, chunk=8, device="cpu")
    assert [t.status == "error" for t in res.txs] == LANE_ERRORS[name] * 2
    empty = commit_precompile_queue([])
    assert all(c["precompile"] == empty for c in res.tx_commitments)
    assert res.commitments["precompile"] \
        == block_commitment([empty] * len(txs))
