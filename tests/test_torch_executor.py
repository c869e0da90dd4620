"""The port's segmented block executor (`models/executor.py`).

The two tests of `tests/test_executor.py`, port against port: every spill
protocol composed on tight geometry equals a one-shot run on big geometry
(the concatenated memory, log and decommit streams, the final registers
and the merged storage map), through the plain engine and through K1's
body as g++ builds it for the host; and the executor through K1's body
equals the executor through the plain engine, field for field.  Then one
comparison with the JAX executor at that file's tight geometry and
segment length: every state field, every host map and spilled frame, every
drained stream.  The programs are `testing/spill_programs.py`, held equal
to `tests/test_executor.py`'s here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_executor
from era_zk_evm_tpu.models import executor as jexecutor
from era_zk_evm_tpu.models import run_cycles as jrun_cycles
from era_zk_evm_tpu.models import spill as jspill
from era_zk_evm_tpu.models.executor import (
    BlockHosts as JBlockHosts, run_block_segments as jrun_block_segments,
)
from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.models import batched_vm
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.models.executor import run_block_segments
from era_zk_evm_tpu_torch.models.spill import drain_witness_queues
from era_zk_evm_tpu_torch.testing import spill_programs
from era_zk_evm_tpu_torch.witness.commitment import (
    serialize_decommittment, serialize_log_query, serialize_memory_query,
)
from test_torch_spill import (
    _executor_config, _executor_state, _jax, _k1_host_engine,
    _merged_storage, _plain, assert_same_maps, assert_same_state,
)
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

B = 2
N_CYCLES = 60 + 6 * 16 + 16
SERIALIZERS = (("memory", serialize_memory_query),
               ("log", serialize_log_query),
               ("decommit", serialize_decommittment))


def test_program_copies_equal_their_sources():
    assert (spill_programs.R_ABI, spill_programs.F_ABI) \
        == (test_executor.R_ABI, test_executor.F_ABI)
    for n in (3, 4):
        assert spill_programs.callees(n) == test_executor._callees(n)
    callees = spill_programs.callees(4)
    rotated = callees[1:] + callees[:1]
    for args in ((callees, 1000, 9, 6), (rotated, 4096, 48, 14)):
        assert spill_programs.caller(*args) == test_executor._caller(*args)


@pytest.fixture(scope="module")
def host():
    return _build.load_host()


@pytest.fixture(params=["plain", "k1_host"])
def engine(request):
    if request.param == "plain":
        return batched_vm.run_cycles
    return _k1_host_engine(request.getfixturevalue("host"))


def _programs(callees):
    return [spill_programs.caller(callees, key_base=1000 * (b + 1), depth=9,
                                  iters=6) for b in range(B)]


def _streams(got):
    return {fam: [[ser(q) for q in lane] for lane in got[fam]]
            for fam, ser in SERIALIZERS}


def test_all_spills_composed_equal_one_shot(engine):
    callees = spill_programs.callees(3)
    programs = _programs(callees)
    big_cfg = _executor_config(
        max_depth=16, queue_capacity=N_CYCLES * 8, storage_slots=32,
        log_queue_capacity=N_CYCLES, heap_frames=10, code_pages=4,
        decommit_queue_capacity=N_CYCLES)
    big = engine(_executor_state(big_cfg, programs, callees, callees),
                 big_cfg, N_CYCLES)
    assert bool(big.done.all()) and not bool(big.lane_error.any())
    big_final, want = drain_witness_queues(big, big_cfg)

    config = _executor_config()
    small = _executor_state(config, programs, callees, callees[:2])
    hosts = spill_programs.cold_code_hosts(config, callees[2:])
    small, hosts, got = run_block_segments(small, config, engine, N_CYCLES,
                                           segment=6, hosts=hosts)
    assert bool(small.done.all()) and not bool(small.lane_error.any())
    assert torch.equal(small.regs, big.regs)
    assert _streams(got) == _streams(want)
    assert _merged_storage(pstate.state_to_numpy(small), hosts.storage.maps) \
        == _merged_storage(pstate.state_to_numpy(big_final))
    # every bounded resource was exceeded in the small run
    assert all(hosts.storage.maps) and all(hosts.code.maps)
    assert all(not f for f in hosts.frames.frames)


def test_executor_engines_agree(host):
    # tests/test_executor.py's fused-engine case: the executor through K1's
    # body equals the executor through the plain engine, field for field
    callees = spill_programs.callees(3)
    config = _executor_config(code_pages=4)
    runs = []
    for engine in (batched_vm.run_cycles, _k1_host_engine(host)):
        st = _executor_state(config, _programs(callees), callees, callees)
        runs.append(run_block_segments(st, config, engine, N_CYCLES,
                                       segment=6))
    (p_st, p_hosts, p_got), (k_st, k_hosts, k_got) = runs
    assert bool(k_st.done.all()) and not bool(k_st.lane_error.any())
    a, b = pstate.state_to_numpy(p_st), pstate.state_to_numpy(k_st)
    assert not [k for k in a if not np.array_equal(a[k], b[k])]
    assert _streams(p_got) == _streams(k_got)
    assert_same_maps(p_hosts.storage.maps, k_hosts.storage.maps)
    assert_same_maps(p_hosts.code.maps, k_hosts.code.maps)


def _jax_compact_keeping_bool(state, config):
    """The JAX compaction with `ev_cancelled` kept bool.  Its `jnp.sum`
    returns the flags as int32, and a second compaction of that state
    takes `~ev_cancelled` bitwise (ROADMAP, Queue 3, R10): every event
    counts as kept and the live frames' event snapshots rise by 2 for
    each event below them.  The port keeps the bool."""
    out = jspill.compact_log_state_host(state, config)
    return dataclasses.replace(out, ev_cancelled=out.ev_cancelled.astype(bool))


def test_executor_matches_jax(host, monkeypatch):
    """The JAX executor and the port's (through K1's host body) on the
    same tight-geometry run: every state field, host map, spilled frame
    and drained stream."""
    monkeypatch.setattr(jexecutor, "compact_log_state_host",
                        _jax_compact_keeping_bool)
    callees = spill_programs.callees(3)
    programs = _programs(callees)
    config = _executor_config()
    pst = _executor_state(config, programs, callees, callees[:2])
    jcfg, jst = _jax(config, pstate.state_to_numpy(pst))
    hosts = spill_programs.cold_code_hosts(config, callees[2:])
    jhosts = JBlockHosts.empty(B)
    for b in range(B):
        jhosts.code.maps[b] = {k: dict(v) for k, v in
                               hosts.code.maps[b].items()}
    pst, hosts, got = run_block_segments(pst, config, _k1_host_engine(host),
                                         N_CYCLES, segment=6, hosts=hosts)
    jst, jhosts, jgot = jrun_block_segments(jst, jcfg, jrun_cycles,
                                            N_CYCLES, segment=6,
                                            hosts=jhosts)
    assert_same_state(jst, pst)
    assert_same_maps(jhosts.storage.maps, hosts.storage.maps)
    assert_same_maps(jhosts.code.maps, hosts.code.maps)
    assert [[_plain(f) for f in lane] for lane in hosts.frames.frames] \
        == [[_plain(f) for f in lane] for lane in jhosts.frames.frames]
    assert _streams(got) == _streams(jgot)
    assert all(hosts.storage.maps) and all(got["log"])
    assert dataclasses.asdict(config) == dataclasses.asdict(jcfg)
