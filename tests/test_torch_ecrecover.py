"""The ecrecover unit (K1 slice e) against the JAX engine, and the
signature-checked block path against the JAX pipeline, bit for bit.

The port side runs on CPU tensors (its dispatcher takes the plain torch
cycle step, whose unit is `ops/secp256k1.ecrecover_batched`).  One config
serves every run, so XLA compiles one cycle program with ecrecover (minutes
on XLA:CPU) and reuses it for the block: `ec_config()`,
`tests/test_batched_precompiles._config(24, 96)` with ecrecover on, the
keccak256 and sha256 units at their least (one block, one round: no program
here hashes, and each further block or round is unrolled into the program
XLA compiles) and a round-witness queue of CHUNK blocks of 8 rows (6 in, 2
out).  A cycle in which some lane recovers costs the JAX engine tens of
seconds on the CPU, so the recoveries share cycles: four in the program run
(every program recovers at cycle 9 but the mid-chunk one, at 10, 17 and
28), two in the block (a wave and its refill).
  * every program of `testing/ec_programs.py` (the JAX tests' recoveries,
    the mid-chunk one, and the edge cases) and the nine signatures of
    `tests/test_secp256k1_kernel.py::test_recover_random_signatures`, one
    lane each, one CHUNK-cycle call (the programs end by cycle 35) that
    the port runs in chunks of 8 cycles; every field equal, and the written
    words equal to the golden scalar recovery.  The nine lanes hold the port's `ecrecover_batched`
    against JAX `ecrecover_batched`, each called by its engine's unit;
  * `ecrecover_mix` as a block of 25 txs on 24 lanes (one refill, one
    rejected signature), with fixed and with
    adaptive chunks, against the JAX pipeline's fixed chunks: the JAX
    dynamic chunk refuses ecrecover configs, and a chunk's length cannot
    change a tx's results.
One fixture runs both JAX references back to back, so that the pipeline
finds the cycle program still compiled in memory (the suite's conftest
drops compiled programs between modules and every 10 tests).
"""

import dataclasses

import numpy as np
import pytest

import test_batched_precompiles
import test_fused_cycle
from era_zk_evm_tpu.block import execute_block as jax_execute_block
from era_zk_evm_tpu.golden.precompiles import ecrecover_inner
from era_zk_evm_tpu.models import TxSpec as JTxSpec
from era_zk_evm_tpu.models import make_entry_state, run_cycles
from era_zk_evm_tpu.models.fused_cycle import supported
from era_zk_evm_tpu_torch import block
from era_zk_evm_tpu_torch.config import (
    VmConfig as PVmConfig, check_slice, from_jax_config,
    precompile_queue_slots,
)
from era_zk_evm_tpu_torch.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import ec_programs as ep

from test_torch_block import assert_same_block
from test_torch_log import _words
from test_torch_precompile import _assert_same, _jax_numpy, _method_programs
from test_torch_secp256k1 import _nine_cases, one_intra_op_thread  # noqa: F401
from test_torch_units_off import expect_lane_errors

#: the block's chunk and the programs' one call: the programs end by cycle
#: 35, and one chunk length keeps XLA at one compiled cycle program
CHUNK, ERGS = 40, 1 << 20
BLOCK_KW = dict(chunk=CHUNK, order="cost_desc", refill_frac=0.5)
#: the nine signatures' lanes: each recovers at cycle 9 with the others,
#: its v the low bit of the word (so the bad v = 2 recovers with v = 0)
NINE = [(ep.EC, ep.edge_program(*case)) for case in _nine_cases()]
LANE_PROGRAMS = ep.EC_LANES + NINE
LANES = len(LANE_PROGRAMS)
FIRST_NINE = len(ep.EC_LANES)


def ec_config():
    return dataclasses.replace(test_batched_precompiles._config(LANES, 96),
                               precompile_keccak_blocks=1,
                               precompile_sha_rounds=1,
                               precompile_ecrecover=True,
                               precompile_queue_capacity=CHUNK * 8)


def _heap_word(arrays, lane, word):
    limbs = arrays["heap"][lane, word]
    return sum(int(x) << (32 * i) for i, x in enumerate(limbs.astype(np.uint32)))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine on the programs (one CHUNK-cycle call) and the JAX
    pipeline on the block."""
    config = ec_config()
    words = [assemble_to_code_words(src) for _, src in LANE_PROGRAMS]
    ref = make_entry_state(config, words, ergs=ERGS,
                           entry_address=[e for e, _ in LANE_PROGRAMS])
    ref = run_cycles(ref, config, CHUNK)
    block_ref = jax_execute_block(config, [
        JTxSpec(**dataclasses.asdict(t)) for t in _mix_txs()], engine="jnp",
        **BLOCK_KW)
    return _jax_numpy(ref), block_ref


@pytest.fixture(scope="module")
def programs_run(jax_runs):
    config = from_jax_config(ec_config())
    st = pstate.make_entry_state(
        config, [assemble_to_code_words(src) for _, src in LANE_PROGRAMS],
        ergs=ERGS, entry_address=[e for e, _ in LANE_PROGRAMS], device="cpu")
    fused_cycle.run_cycles(st, config, CHUNK, k_inner=8)
    return jax_runs[0], pstate.state_to_numpy(st)


def test_ec_programs_match_jax(programs_run):
    ref, got = programs_run
    _assert_same(ref, got)
    assert got["done"].all()
    # every recovery but the short-of-ergs one emitted its 4 + 2 rows; the
    # mid-chunk program three times
    assert got["pq_count"][:4].tolist() == [6, 6, 18, 0]
    assert (got["pq_flags"] == 5).any()           # second out rows
    assert (got["pq_flags"] == 5 | 1 << 3).any()  # first out rows


def test_nine_cases_match_jax_through_the_vm(programs_run):
    ref, got = programs_run
    for i, (digest, v, r, s) in enumerate(_nine_cases()):
        lane = FIRST_NINE + i
        want = ecrecover_inner(digest, v & 1, r, s)
        assert [_heap_word(got, lane, w) for w in (4, 5)] \
            == [_heap_word(ref, lane, w) for w in (4, 5)] \
            == [int(want is not None), want or 0], i
        assert (want is not None) == (i < 6)
    assert not got["lane_error"][FIRST_NINE:].any()


def _mix():
    # the txs of up to 16 iterations (a tx of 32 takes 33 journal entries,
    # and the config has 32): one more than the lanes, so that one lane is
    # refilled, and the first corrupted tx among them
    return [t for t in ep.ecrecover_mix(2 * LANES) if t[2] <= 16][:LANES + 1]


def _mix_txs():
    return [block.TxSpec(program=assemble_to_code_words(src), ergs=1 << 22,
                         entry_address=entry, cost_hint=n)
            for entry, src, n, *_ in _mix()]


@pytest.mark.parametrize("adaptive", [False, True])
def test_ecrecover_block_matches_jax(jax_runs, adaptive):
    got = block.execute_block(from_jax_config(ec_config()), _mix_txs(),
                              device="cpu", adaptive_chunk=adaptive,
                              **BLOCK_KW)
    assert got.all_ok
    assert_same_block(jax_runs[1], got)
    assert sorted(got.commitments) == ["decommit", "log", "memory",
                                       "precompile"]
    # every tx recovered its signer once (4 + 2 rows); the corrupted ones
    # took the reject branch and logged the recovered address
    assert all(r.streams["precompile"].shape[0] == 6 for r in got.txs)
    rejected = [t for t, (*_, bad, _) in zip(got.txs, _mix()) if bad]
    assert rejected and all(not r.net_states["final_storage"]
                            for r in rejected)


@pytest.mark.parametrize("case", sorted(ep.EDGE_CASES))
def test_edge_case_outputs_equal_golden(programs_run, case):
    _, got = programs_run
    lane = 4 + list(ep.EDGE_PROGRAMS).index(case)
    digest, v_word, r, s = ep.EDGE_CASES[case]
    want = ecrecover_inner(digest, v_word & 1, r, s)
    if case == "output_passes_frame":
        # hw_ok fails on the window's second word: lane_error, no write
        assert want is not None and got["lane_error"][lane]
        assert _heap_word(got, lane, ep.HEAP_WORDS - 1) == 0
        return
    assert not got["lane_error"][lane]
    assert _heap_word(got, lane, 4) == int(want is not None)
    assert _heap_word(got, lane, 5) == (want or 0)


def test_state_round_trip_on_an_ecrecover_config():
    config = ec_config()
    words = [assemble_to_code_words(src) for _, src in LANE_PROGRAMS]
    entries = [e for e, _ in LANE_PROGRAMS]
    ref = _jax_numpy(make_entry_state(config, words, ergs=ERGS,
                                      entry_address=entries))
    got = pstate.state_to_numpy(pstate.make_entry_state(
        from_jax_config(config), words, ergs=ERGS, entry_address=entries,
        device="cpu"))
    _assert_same(ref, got)
    back = pstate.state_to_numpy(pstate.state_from_numpy(ref, "cpu"))
    _assert_same(ref, back)
    assert precompile_queue_slots(from_jax_config(config)) == (6, 2)
    assert got["pq_meta"].shape == (LANES, CHUNK * 8, 4)


@pytest.mark.parametrize("kw", [
    {"precompile_keccak_blocks": 2},
    {"precompile_keccak_blocks": 1, "precompile_queue_capacity": 12},
    {"precompile_sha_rounds": 2},           # R5: supported, but no unit runs
])
def test_ecrecover_configs_are_in_the_slice(kw):
    from era_zk_evm_tpu.models import VmConfig

    jc = VmConfig(batch=1, storage_slots=4, precompile_ecrecover=True, **kw)
    assert supported(jc)
    check_slice(from_jax_config(jc))
    assert fused_cycle.ecrecover_instance(from_jax_config(jc)) \
        == (jc.precompile_keccak_blocks > 0)


@pytest.mark.parametrize("kw", [{"precompile_ecrecover": True},
                                {"precompile_ecrecover": True,
                                 "precompile_keccak_blocks": 2}])
def test_ecrecover_without_its_couplings_raises(kw):
    # the JAX fused supported() refuses ecrecover without the units or the
    # LOG unit; the JAX jnp engine runs it with the unit off, and so does
    # the port (tests/test_torch_units_off.py holds that against JAX)
    storage = {"storage_slots": 4} if len(kw) == 1 else {}
    from era_zk_evm_tpu.models import VmConfig

    jc = VmConfig(batch=1, **storage, **kw)
    assert not supported(jc)
    pc = PVmConfig(batch=1, **storage, **kw)
    assert not fused_cycle.ecrecover_instance(pc)
    expect_lane_errors(pc)


def test_ec_program_copies_equal_their_sources():
    tb, tf = test_batched_precompiles, test_fused_cycle
    assert _words([ep.VIA_VM_PROGRAM]) == _words(_method_programs(
        tb.TestDeviceEcrecover.test_ecrecover_via_vm))
    assert _words([ep.ROUND_WITNESS_PROGRAM]) == _words(_method_programs(
        tb.TestPrecompileRoundWitness.test_ecrecover_round_witness))
    assert _words([ep.MID_CHUNK_PROGRAM]) == _words(_method_programs(
        tf.TestFusedEcrecover.test_ecrecover_detour_mid_chunk,
        tf.TestFusedEcrecover()))
    assert ep.HEAP_WORDS == tb._config(1, 96).heap_words
