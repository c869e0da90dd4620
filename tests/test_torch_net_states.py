"""The port's per-tx net states (`models/net_states.py`) on the bootloader
block of `tests/test_bootloader.py`: one VM runs a bootloader that
far-calls each transaction and advances `tx_number_in_block` between
them.

The port's plain engine runs the block at that file's `_config(2)` and
`MAX_CYCLES`; `net_states_by_tx` and `device_net_states` equal the JAX
package's host functions applied to the port's final arrays (a namespace
of `state_to_numpy`), and each tx's bucket holds its callee's marker event
and storage write."""

import dataclasses
import types

import pytest

import test_bootloader
from era_zk_evm_tpu.models import net_states as jnet
from era_zk_evm_tpu.witness.commitment import device_log_streams as jlogs
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle, net_states
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import witness_programs as wp
from era_zk_evm_tpu_torch.witness.commitment import device_log_streams
from test_torch_packed import as_tuples
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def run():
    """(port config, port state after the block, the same arrays as a
    namespace of numpy arrays in the reference layout)."""
    config = wp.bootloader_config(2)
    st = wp.bootloader_state(config, "cpu")
    fused_cycle.run_cycles(st, config, wp.MAX_CYCLES)
    assert bool(st.done.all()) and not bool(st.lane_error.any())
    return config, st, types.SimpleNamespace(**pstate.state_to_numpy(st))


def _buckets(lane: dict) -> dict:
    return {tx: {k: as_tuples(v) for k, v in b.items()}
            for tx, b in lane.items()}


def _nets(net: dict) -> dict:
    return {"final_storage": net["final_storage"],
            "events": as_tuples(net["events"]),
            "l1_messages": as_tuples(net["l1_messages"])}


def test_program_copies_equal_their_sources():
    for name in ("BOOTLOADER", "TX_ADDRS", "TX_MARKS", "TX_SEQUENCE",
                 "CALLDATA", "MAX_CYCLES"):
        assert getattr(wp, name) == getattr(test_bootloader, name), name
    assert wp.CALLEES == test_bootloader._CALLEES
    assert wp.bootloader_config(2) \
        == from_jax_config(test_bootloader._config(2))


def test_net_states_by_tx_match_jax(run):
    config, st, arrays = run
    logs = device_log_streams(st)
    assert [as_tuples(s) for s in logs] \
        == [as_tuples(s) for s in jlogs(arrays)]
    got = net_states.net_states_by_tx(st, config, logs)
    ref = jnet.net_states_by_tx(arrays, config, jlogs(arrays))
    assert [_buckets(lane) for lane in got] == [_buckets(lane) for lane in ref]
    got = net_states.device_net_states(st, config, logs)
    ref = jnet.device_net_states(arrays, config, jlogs(arrays))
    assert [_nets(n) for n in got] == [_nets(n) for n in ref]
    assert all(n["final_storage"] and n["events"] for n in got)


def test_each_tx_bucket_holds_its_markers(run):
    config, st, _ = run
    for per_tx in net_states.net_states_by_tx(st, config,
                                              device_log_streams(st)):
        assert sorted(per_tx) == list(range(len(wp.TX_SEQUENCE)))
        for tx_i, contract_i in enumerate(wp.TX_SEQUENCE):
            bucket = per_tx[tx_i]
            assert len(bucket["events"]) == 1, tx_i
            ev = bucket["events"][0]
            assert (ev.tx_number_in_block, ev.value, ev.address) \
                == (tx_i, wp.TX_MARKS[contract_i], wp.TX_ADDRS[contract_i])
            writes = [q for q in bucket["storage_writes"]
                      if q.address == wp.TX_ADDRS[contract_i]]
            assert len(writes) == 1 and writes[0].written_value \
                == wp.TX_MARKS[contract_i], tx_i


def test_storage_maps_without_storage_are_empty(run):
    config, st, _ = run
    none = dataclasses.replace(config, storage_slots=0)
    assert net_states.device_storage_maps(st, none) == [{}, {}]
    assert [len(e) for e in net_states.device_event_entries(st)] \
        == [len(wp.TX_SEQUENCE)] * 2
