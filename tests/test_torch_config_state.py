"""The port's config and state against the JAX package's: no drift, equal
entry states field for field, and a lossless numpy <-> torch round trip."""

import dataclasses

import numpy as np
import pytest

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import state as jstate
from era_zk_evm_tpu.models.batched_vm import SLOTS_PER_CYCLE as J_SLOTS
from era_zk_evm_tpu_torch import config as pconfig
from era_zk_evm_tpu_torch.models import state as pstate

from test_batched_vm import BASIC_PROGRAMS, UMA_PROGRAMS
from test_fused_cycle import _config
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401


def _bench_config(batch, **kw):
    return jstate.VmConfig(batch=batch, code_words=16, stack_words=256,
                           sweep_gating=False, stack_abs_words=64,
                           stack_sp_base=960, heap_words=64,
                           aux_heap_words=16, max_depth=8, **kw)


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _assert_same(ref: dict, got: dict):
    assert list(ref) == list(got)
    bad = [k for k in ref if ref[k].dtype != got[k].dtype
           or ref[k].shape != got[k].shape or not (ref[k] == got[k]).all()]
    assert not bad, f"fields differ: {bad}"


def test_config_fields_and_defaults_match():
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(jstate.VmConfig)]
    pf = [(f.name, f.default, f.type) for f in dataclasses.fields(pconfig.VmConfig)]
    assert jf == pf


def test_config_constants_match():
    assert pconfig.CS_SCALAR_FIELDS == jstate.CS_SCALAR_FIELDS
    assert pconfig.CS == jstate.CS
    assert pconfig.BATCH_LAST_FIELDS == jstate.BATCH_LAST_FIELDS
    assert pconfig.SLOTS_PER_CYCLE == J_SLOTS
    for kw in ({}, {"precompile_keccak_blocks": 3}, {"precompile_sha_rounds": 4},
               {"precompile_ecrecover": True}):
        jc = jstate.VmConfig(batch=1, **kw)
        assert pconfig.precompile_queue_slots(pconfig.from_jax_config(jc)) \
            == jstate.precompile_queue_slots(jc)


@pytest.mark.parametrize("kw", [
    {"stack_words": 512},                                  # SP outside arena
    {"stack_abs_words": 64, "stack_sp_base": 1100, "stack_words": 256},
    {"queue_capacity": 12},                                # not a multiple of 8
    {"precompile_keccak_blocks": 2, "precompile_queue_capacity": 2},
])
def test_config_post_init_checks_match(kw):
    with pytest.raises(AssertionError):
        jstate.VmConfig(batch=1, **kw)
    with pytest.raises(AssertionError):
        pconfig.VmConfig(batch=1, **kw)


def test_from_jax_config_round_trip():
    jc = _config(3)
    pc = pconfig.from_jax_config(jc)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("kw", [
    {"precompile_sha_rounds": 1},                   # units without LOG
    {"storage_slots": 4, "precompile_queue_capacity": 8},
    {"storage_slots": 4, "precompile_ecrecover": True},
    {"precompile_keccak_blocks": 1},
    {"limb_major_arenas": True},
    {"rolling_commitment": True, "queue_capacity": 64},
])
def test_configs_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError):
        pconfig.check_slice(pconfig.VmConfig(batch=1, **kw))


@pytest.mark.parametrize("case", ["test_geometry", "bench_geometry",
                                  "calldata", "per_lane_entry"])
def test_make_entry_state_matches_jax(case):
    words = [assemble_to_code_words(s) for s in BASIC_PROGRAMS[:3]]
    kwargs = {"ergs": 1 << 20}
    if case == "test_geometry":
        jc = _config(3)
    elif case == "bench_geometry":
        jc = _bench_config(3, queue_capacity=1024)
        kwargs["ergs"] = (1 << 31) - 1
    elif case == "calldata":
        jc = dataclasses.replace(_config(3), heap_frames=2)
        kwargs["calldata"] = [[5, 1 << 200], None, [7]]
        kwargs["heap_init"] = [[1, 2], [], [3]]
    else:
        jc = _bench_config(3, rolling_commitment=True)
        kwargs["entry_address"] = [0x8001, 0x12345, 1 << 150]
        kwargs["context_u128"] = [0, 99, (1 << 128) - 1]
        kwargs["is_static"] = True
    ref = jstate.make_entry_state(jc, words, **kwargs)
    got = pstate.make_entry_state(pconfig.from_jax_config(jc), words,
                                  device="cpu", **kwargs)
    _assert_same(_jax_numpy(ref), pstate.state_to_numpy(got))


def test_numpy_torch_round_trip_is_identity():
    jc = dataclasses.replace(_config(2), heap_frames=2)
    words = [assemble_to_code_words(s) for s in UMA_PROGRAMS[:2]]
    ref = _jax_numpy(jstate.make_entry_state(jc, words,
                                             calldata=[[1, 2], None]))
    rng = np.random.RandomState(7)
    # random bits everywhere, so every u32 value range crosses the round trip
    noisy = {k: (rng.rand(*v.shape) < 0.5 if v.dtype == bool
                 else rng.randint(0, 1 << 32, size=v.shape, dtype=np.uint64)
                 .astype(v.dtype))
             for k, v in ref.items()}
    for arrays in (ref, noisy):
        back = pstate.state_to_numpy(pstate.state_from_numpy(arrays, "cpu"))
        _assert_same(arrays, back)
