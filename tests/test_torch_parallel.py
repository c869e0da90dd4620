"""The port's multi-device layer (`era_zk_evm_tpu_torch/parallel/`) on CPU
shards, against the unsharded port run and against the JAX mesh.

A mesh may name one device more than once, so `["cpu"] * 8` stands where
the JAX tests use their 8-device virtual CPU mesh (`tests/conftest.py`).
Sharded runs must equal the unsharded port run in every field and in the
aggregates; one JAX `parallel.mesh.run_block` on the virtual mesh (the
config, programs and cycle count of `tests/test_fused_cycle.py::
TestFusedSharded::test_collective_block_commitment`'s jnp leg, so a warm
compile cache shares its program) must equal the port in its aggregates,
its block commitment and every field.  The float32 aggregates
(`cycles_retired`, `root_ergs`) are compared with JAX to float32's
rounding, relative 1e-6 (XLA and torch sum in different orders); every
other number exactly.  The dry run must print `MULTICHIP_r05.json`'s
lines.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig
from era_zk_evm_tpu.models import make_entry_state as jax_entry_state
from era_zk_evm_tpu.models.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.models.checkpoint import load_checkpoint
from era_zk_evm_tpu_torch.parallel import (
    ShardedState, make_mesh, run_block, shard_state,
)
from era_zk_evm_tpu_torch.parallel.dryrun import dryrun_multichip
from era_zk_evm_tpu_torch.parallel.fused import run_block_fused
from era_zk_evm_tpu_torch.parallel.mesh import block_aggregates
from era_zk_evm_tpu_torch.parallel.scaling import measure, weak_scaling_report
from era_zk_evm_tpu_torch.testing import log_programs as lp
from era_zk_evm_tpu_torch.witness.commitment import (
    block_commitment, device_rolling_commitments,
)

from test_batched_vm import (
    BASIC_PROGRAMS, CONTROL_FLOW, STACK_PROGRAMS, UMA_PROGRAMS,
)
from test_fused_cycle import N_CYCLES, _config, _log_config
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401
from test_torch_slice import ROOT

CPU8 = ["cpu"] * 8
ERGS = 1 << 20


def _rolling_config(batch=8):
    # tests/test_fused_cycle.py::test_collective_block_commitment
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    sweep_gating=False, stack_abs_words=64,
                    stack_sp_base=960, heap_words=32, aux_heap_words=8,
                    max_depth=8, queue_capacity=0, rolling_commitment=True)


def _rolling_words():
    words = [assemble_to_code_words(s)
             for s in (UMA_PROGRAMS[:4] + STACK_PROGRAMS)[:8]]
    return words + [words[0]] * (8 - len(words))


def _numpy(state):
    return pstate.state_to_numpy(state)


def _assert_same(ref: dict, got: dict):
    bad = [k for k in ref if ref[k].dtype != got[k].dtype
           or ref[k].shape != got[k].shape or not (ref[k] == got[k]).all()]
    assert not bad, f"fields differ: {bad}"


def _random_state(config, seed=3):
    # every field drawn over the whole u32 range, so lane order shows
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, a in pstate._empty_numpy(config).items():
        arrays[name] = (rng.integers(0, 2, a.shape).astype(bool)
                        if a.dtype == bool else
                        rng.integers(0, 1 << 32, a.shape, dtype=np.uint64)
                        .astype(np.uint32).view(a.dtype)
                        if a.dtype == np.int32 else
                        rng.integers(0, 1 << 32, a.shape, dtype=np.uint64)
                        .astype(np.uint32))
    return pstate.state_from_numpy(arrays, "cpu")


def _full_config(batch):
    return from_jax_config(dataclasses.replace(
        _log_config(batch), rolling_commitment=True,
        precompile_keccak_blocks=1, precompile_queue_capacity=16))


def test_shard_gather_round_trip_every_field():
    config = _full_config(8)
    state = _random_state(config)
    before = {k: v.copy() for k, v in _numpy(state).items()}
    sharded = shard_state(state, make_mesh(devices=["cpu"] * 4))
    assert len(sharded.shards) == 4 and sharded.batch == 8
    for i, shard in enumerate(sharded.shards):
        for name in pstate.FIELD_NAMES:
            t, full = getattr(shard, name), getattr(state, name)
            assert t.is_contiguous(), name
            assert t.untyped_storage().data_ptr() \
                != full.untyped_storage().data_ptr(), name
            axis = pstate.LANE_AXIS[name]
            assert torch.equal(t, full.narrow(axis, 2 * i, 2)), name
    # both lane axes, in the reference layout: lanes 2i, 2i + 1
    ref = _numpy(state)
    for i, shard in enumerate(sharded.shards):
        got = _numpy(shard)
        assert (got["regs"] == ref["regs"][2 * i:2 * i + 2]).all()
        assert (got["heap"] == ref["heap"][2 * i:2 * i + 2]).all()
        assert (got["wq_meta"] == ref["wq_meta"][..., 2 * i:2 * i + 2]).all()
    _assert_same(ref, _numpy(sharded.gather("cpu")))
    # the shards are private: writing one leaves the caller's state as it was
    for shard in sharded.shards:
        for name in pstate.FIELD_NAMES:
            t = getattr(shard, name)
            t.copy_(torch.zeros_like(t) if t.dtype != torch.bool else ~t)
    _assert_same(before, _numpy(state))


def _unsharded_and_sharded(config, words, n_cycles, staged=None,
                           fused=False):
    def entry():
        st = pstate.make_entry_state(config, words, ergs=ERGS, device="cpu")
        if staged is not None:
            pstate.populate_storage(st, config, staged[0])
            pstate.populate_code_bank(st, config, staged[1])
        return st

    one = fused_cycle.run_cycles(entry(), config, n_cycles, k_inner=16)
    mesh = make_mesh(devices=CPU8)
    if fused:
        sharded, agg = run_block_fused(entry(), config, n_cycles, mesh,
                                       tile=1, k_inner=16)
    else:
        sharded, agg = run_block(shard_state(entry(), mesh), config,
                                 n_cycles, k_inner=16)
    assert isinstance(sharded, ShardedState)
    _assert_same(_numpy(one), _numpy(sharded.gather("cpu")))
    want = block_aggregates(one, config)
    assert sorted(agg) == sorted(want)
    for k in want:
        assert agg[k].dtype == want[k].dtype, k
        assert torch.equal(agg[k], want[k]), k
    return one, agg


@pytest.mark.parametrize("fused", [False, True], ids=["run_block", "fused"])
@pytest.mark.parametrize("mode", ["queue", "rolling", "storage_far_call"])
def test_sharded_runs_equal_the_unsharded_run(mode, fused):
    if mode == "queue":
        words = [assemble_to_code_words(s)
                 for s in (BASIC_PROGRAMS[:4] + CONTROL_FLOW)[:8]]
        words += [words[0]] * (8 - len(words))
        one, agg = _unsharded_and_sharded(from_jax_config(_config(8)), words,
                                          N_CYCLES, fused=fused)
        assert int(agg["witness_queries"]) == int(one.wq_count.sum()) > 0
    elif mode == "rolling":
        one, agg = _unsharded_and_sharded(from_jax_config(_rolling_config()),
                                          _rolling_words(), N_CYCLES,
                                          fused=fused)
        got = b"".join(int(w).to_bytes(4, "little") for w in
                       agg["memory_block_commitment"].numpy().view(np.uint32))
        assert got == block_commitment(device_rolling_commitments(one))
    else:
        words, entries, banks = lp.stage("far")
        one, agg = _unsharded_and_sharded(
            from_jax_config(_log_config(lp.LANES)), words, N_CYCLES,
            staged=(entries, banks), fused=fused)
        assert int(one.lq_count.sum()) > 0 and int(one.dq_count.sum()) > 0
    assert int(agg["done_lanes"]) == int(one.done.sum())


def test_plain_state_is_a_one_shard_mesh():
    config = from_jax_config(_rolling_config())
    st = pstate.make_entry_state(config, _rolling_words(), ergs=ERGS,
                                 device="cpu")
    out, agg = run_block(st, config, 8)
    assert out is st and int(st.monotonic_cycle_counter.max()) == 8
    assert agg["memory_block_commitment"].shape == (8,)


@pytest.fixture(scope="module")
def jax_mesh_run():
    """One JAX `parallel.mesh.run_block` on the 8-device virtual mesh."""
    from era_zk_evm_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from era_zk_evm_tpu.parallel.mesh import run_block as jax_run_block
    from era_zk_evm_tpu.parallel.mesh import shard_state as jax_shard_state

    config = _rolling_config()
    mesh = jax_make_mesh(8)
    state = jax_shard_state(jax_entry_state(config, _rolling_words(),
                                            ergs=ERGS), mesh)
    state, agg = jax_run_block(state, config, N_CYCLES)
    arrays = {f.name: np.array(getattr(state, f.name))
              for f in dataclasses.fields(state)}
    return state, arrays, {k: np.asarray(v) for k, v in agg.items()}


def test_run_block_equals_the_jax_mesh(jax_mesh_run):
    _, ref, jagg = jax_mesh_run
    config = from_jax_config(_rolling_config())
    st = pstate.make_entry_state(config, _rolling_words(), ergs=ERGS,
                                 device="cpu")
    sharded, agg = run_block(shard_state(st, make_mesh(devices=CPU8)),
                             config, N_CYCLES)
    _assert_same(ref, _numpy(sharded.gather("cpu")))
    assert sorted(agg) == sorted(jagg)
    assert (agg["memory_block_commitment"].numpy().view(np.uint32)
            == jagg["memory_block_commitment"]).all()
    for k in ("done_lanes", "error_lanes", "witness_queries"):
        assert int(agg[k]) == int(jagg[k]), k
    for k in ("cycles_retired", "root_ergs"):      # float32 sums
        assert agg[k].dtype == torch.float32 and jagg[k].dtype == np.float32
        assert float(agg[k]) == pytest.approx(float(jagg[k]), rel=1e-6), k


def test_jax_checkpoint_loads_onto_a_mesh(jax_mesh_run, tmp_path):
    jstate, ref, _ = jax_mesh_run
    jax_save_checkpoint(tmp_path, jstate, _rolling_config())
    mesh = make_mesh(devices=["cpu"] * 4)
    sharded, config = load_checkpoint(tmp_path, mesh=mesh)
    assert isinstance(sharded, ShardedState) and sharded.mesh == mesh
    assert dataclasses.asdict(config) \
        == dataclasses.asdict(from_jax_config(_rolling_config()))
    _assert_same(ref, _numpy(sharded.gather("cpu")))
    # and it resumes: 8 more cycles on the shards equal 8 on one state
    one, _ = load_checkpoint(tmp_path, device="cpu")
    fused_cycle.run_cycles(one, config, 8)
    run_block(sharded, config, 8)
    _assert_same(_numpy(one), _numpy(sharded.gather("cpu")))


def test_dryrun_reproduces_the_multichip_record(capsys):
    record = json.loads((ROOT / "MULTICHIP_r05.json").read_text())
    want = [ln for ln in record["tail"].splitlines()
            if not ln.startswith("dryrun_multichip scaling")]
    out = dryrun_multichip(8, devices=CPU8, scaling=False)
    assert capsys.readouterr().out.splitlines() == want
    assert out["fused+rolling"][1] == out["jnp"][1] == (
        "42a4ed2e9ef08256b0a0289e179e527951beebdce12a185d58c4f556d854f684")


def test_measure_and_weak_scaling_on_cpu_shards():
    for n in (1, 8):
        assert measure(n, lanes_per_device=4, n_cycles=4,
                       devices=CPU8) > 0
    report = weak_scaling_report((1, 2), devices=["cpu"] * 2)
    assert sorted(report) == [1, 2] and report[1] == 1.0 and report[2] > 0


def test_mesh_checks():
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(9, devices=CPU8)
    config = from_jax_config(_rolling_config(batch=6))
    st = pstate.empty_state(config, "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        shard_state(st, make_mesh(devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="another mesh"):
        run_block_fused(shard_state(st, make_mesh(devices=["cpu"] * 2)),
                        config, 1, make_mesh(devices=["cpu"] * 3))
