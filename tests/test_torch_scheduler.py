"""The port's lane-refill scheduler against the JAX scheduler: every
TxResult (tx, status, cycles, registers, packed streams, net states) equal,
bit for bit, on the cases of `tests/test_scheduler.py`.

Both sides collect packed streams; the JAX side runs its jnp engine
(`run_cycles`), the port side its own engine on CPU tensors
(`fused_cycle.run_cycles`, the plain cycle step), including its own
dynamic-length chunk for the adaptive policy.  The policy runs (tail
escalation, longest-first, spec_depth, adaptive chunks) are held against
the JAX scheduler's default-policy results, which the JAX package's own
tests show equal to its policy runs; so XLA compiles one chunk length.
The port builds and merges only the refilled lanes' rows, without their
(just rewound) queues; the equal results show that this is the same as the
JAX scheduler's full-batch merge.
"""

import dataclasses
import functools

import numpy as np
import pytest

import test_scheduler
from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig
from era_zk_evm_tpu.models import net_states as jnet
from era_zk_evm_tpu.models.batched_vm import run_cycles
from era_zk_evm_tpu.models.scheduler import TxSpec as JTxSpec
from era_zk_evm_tpu.models.scheduler import run_block_refill as jax_refill
from era_zk_evm_tpu.witness import packed as jpacked
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle, net_states, scheduler
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import block_programs as bp
from era_zk_evm_tpu_torch.witness import packed
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

CHUNK = 16


def _config() -> VmConfig:
    """tests/test_scheduler.py's geometry with two heap frames (its
    heterogeneous block's config, which runs every case here: one compile
    on the JAX side)."""
    return VmConfig(batch=4, code_words=16, stack_words=96,
                    stack_abs_words=16, stack_sp_base=1000,
                    heap_words=8, aux_heap_words=4, max_depth=4,
                    heap_frames=2, queue_capacity=16 * 8 * 4)


def _port_run(state, config, n):
    return fused_cycle.run_cycles(state, config, n)


def _programs():
    return {n: assemble_to_code_words(bp.scheduler_program(n))
            for n in set(bp.SCHEDULER_LENGTHS)}


def _txs(lengths, hints=False):
    progs = _programs()
    return [scheduler.TxSpec(program=progs[n], ergs=1 << 26,
                             cost_hint=n if hints else 0) for n in lengths]


def _port(config, txs, **kw):
    if kw.get("adaptive_chunk"):
        kw["run_dyn_fn"] = _port_run
    return scheduler.run_block_refill(from_jax_config(config), txs,
                                      _port_run, CHUNK, collect="packed",
                                      device="cpu", **kw)


def _both(config, txs, **kw):
    """(JAX results, JAX stats), (port results, port stats) of one block,
    with the same policy knobs on both sides."""
    jtxs = [JTxSpec(**dataclasses.asdict(t)) for t in txs]
    ref = jax_refill(config, jtxs, run_cycles, CHUNK, collect="packed",
                     **kw)
    return ref, _port(config, txs, **kw)


@functools.lru_cache(maxsize=None)
def _jax_default(repeat: int):
    """The JAX scheduler's results for LENGTHS * repeat, default policy:
    the reference of the policy tests (the JAX package's own tests show its
    results do not depend on the policy, so one compiled chunk length
    serves them all)."""
    jtxs = [JTxSpec(**dataclasses.asdict(t))
            for t in _txs(bp.SCHEDULER_LENGTHS * repeat)]
    return jax_refill(_config(), jtxs, run_cycles, CHUNK, collect="packed")


def _messages(msgs):
    return [dataclasses.astuple(m) for m in msgs]


def _assert_same_nets(a, b):
    if a.net_states is None:
        assert b.net_states is None
        return
    assert a.net_states["final_storage"] == b.net_states["final_storage"]
    for key in ("events", "l1_messages"):
        assert _messages(a.net_states[key]) \
            == _messages(b.net_states[key]), (a.tx, key)


def assert_same_object_results(ref_results, got_results):
    """TxResults of the objects form: streams of query structs compared as
    tuples (the classes differ across the packages)."""
    from test_torch_packed import as_tuples

    assert len(ref_results) == len(got_results)
    for a, b in zip(ref_results, got_results):
        assert (a.tx, a.status, a.cycles) == (b.tx, b.status, b.cycles)
        assert np.array_equal(a.registers, b.registers), a.tx
        assert sorted(a.streams) == sorted(b.streams), a.tx
        for name in a.streams:
            assert as_tuples(a.streams[name]) == as_tuples(b.streams[name]), \
                (a.tx, name)
        _assert_same_nets(a, b)


def assert_same_results(ref_results, got_results):
    assert len(ref_results) == len(got_results)
    for a, b in zip(ref_results, got_results):
        assert (a.tx, a.status, a.cycles) == (b.tx, b.status, b.cycles)
        assert b.registers.dtype == np.uint32
        assert np.array_equal(a.registers, b.registers), a.tx
        assert sorted(a.streams) == sorted(b.streams), a.tx
        for name in a.streams:
            assert np.array_equal(a.streams[name], b.streams[name]), \
                (a.tx, name)
        _assert_same_nets(a, b)


@pytest.mark.parametrize("refill", [True, False])
def test_refill_matches_jax(refill):
    config = _config()
    if refill:
        (ref, rs), (got, gs) = _jax_default(1), _port(
            config, _txs(bp.SCHEDULER_LENGTHS))
    else:
        (ref, rs), (got, gs) = _both(config, _txs(bp.SCHEDULER_LENGTHS),
                                     refill=False)
    assert_same_results(ref, got)
    assert all(r.status == "ok" for r in got)
    for key in ("rounds", "lane_cycles", "useful_cycles"):
        assert rs[key] == gs[key], key


def test_heterogeneous_block_matches_jax():
    # tests/test_scheduler.py's heterogeneous block: mixed entry addresses,
    # calldata or none, context_u128
    config = _config()
    prog_cd = assemble_to_code_words("""
        ctx.this r5
        ctx.get_u128 r6
        ld.ptr r1, r7
        add r1, r0, r8
        ret r0
    """)
    prog_plain = assemble_to_code_words("""
        ctx.this r5
        ctx.get_u128 r6
        add r1, r0, r8
        add 7, r0, r7
        ret r0
    """)
    T = scheduler.TxSpec
    txs = [
        T(program=prog_cd, ergs=1 << 26, entry_address=0x8001,
          calldata=[0xAA11, 0xBB22], context_u128=(5 << 64) | 9),
        T(program=prog_plain, ergs=1 << 26, entry_address=0x9999),
        T(program=prog_cd, ergs=1 << 26, entry_address=0x17001,
          calldata=[0xC0FFEE], context_u128=1 << 127),
        T(program=prog_plain, ergs=1 << 26, entry_address=0x8001,
          context_u128=42),
        T(program=prog_plain, ergs=1 << 26, entry_address=0x8002),
    ]
    (ref, _), (got, _) = _both(config, txs)
    assert_same_results(ref, got)
    assert all(r.status == "ok" for r in got)


def test_scheduling_policies_match_jax():
    config = _config()
    got, gs = _port(config, _txs(bp.SCHEDULER_LENGTHS, hints=True),
                    spec_depth=3, tail_chunk_mult=2, order="cost_desc",
                    refill_frac=0.5)
    assert_same_results(_jax_default(1)[0], got)
    # escalated tail chunks are accounted in lane_cycles
    assert gs["lane_cycles"] > gs["rounds"] * CHUNK * config.batch


def test_adaptive_chunk_through_the_port_engine_matches_jax():
    # the shrunk launches run the port's own dynamic-length chunk
    # (fused_cycle.run_cycles with n < chunk, which honours n), held
    # against the JAX scheduler's TxResults (JAX run_cycles(n))
    config = _config()
    got, gs = _port(config, _txs(bp.SCHEDULER_LENGTHS * 2, hints=True),
                    adaptive_chunk=True, min_chunk=8, refill_frac=0.5)
    assert gs["adaptive_launches"] > 0
    assert_same_results(_jax_default(2)[0], got)
    assert gs["useful_cycles"] == _jax_default(2)[1]["useful_cycles"]


def test_compacted_drains_match_jax():
    compact, _ = _port(_config(), _txs(bp.SCHEDULER_LENGTHS),
                       drain_compact_frac={"memory": 0.5})
    assert_same_results(_jax_default(1)[0], compact)


def test_txspec_ergs_out_of_range_rejected():
    from era_zk_evm_tpu_torch.isa import params

    config = from_jax_config(dataclasses.replace(_config(), batch=2))
    bad = scheduler.TxSpec(program=_programs()[1],
                           ergs=params.VM_INITIAL_FRAME_ERGS + 1)
    with pytest.raises(ValueError, match="TxSpec.ergs"):
        scheduler.run_block_refill(config, [bad], _port_run, chunk=16,
                                   collect="packed", device="cpu")
    with pytest.raises(ValueError, match="unknown collect"):
        scheduler.run_block_refill(config, [], _port_run, chunk=16,
                                   collect="arrays", device="cpu")


def test_default_collect_is_the_references_and_raises():
    """A call without `collect` takes the reference's default, "objects":
    the query structs, equal to the JAX scheduler's default run on this
    file's config (its one compiled chunk)."""
    import inspect

    default = inspect.signature(scheduler.run_block_refill) \
        .parameters["collect"].default
    assert default == inspect.signature(jax_refill) \
        .parameters["collect"].default == "objects"
    txs = _txs(bp.SCHEDULER_LENGTHS)
    ref, rs = jax_refill(_config(), [JTxSpec(**dataclasses.asdict(t))
                                     for t in txs], run_cycles, CHUNK)
    got, gs = scheduler.run_block_refill(from_jax_config(_config()), txs,
                                         _port_run, CHUNK, device="cpu")
    assert all(r.status == "ok" and r.streams["memory"] for r in got)
    assert_same_object_results(ref, got)
    for key in ("rounds", "lane_cycles", "useful_cycles"):
        assert rs[key] == gs[key], key


def test_merge_lanes_replaces_only_the_given_lanes():
    config = from_jax_config(_config())
    progs = _programs()
    st = pstate.make_entry_state(config, [progs[3]] * 4, device="cpu")
    fused_cycle.run_cycles(st, config, 5)
    before = pstate.state_to_numpy(st)
    fresh = scheduler._build_entries(
        config, [scheduler.TxSpec(program=progs[7], ergs=5)] * 2, "cpu")
    scheduler.merge_lanes(st, fresh, pstate.to_device(np.array([1, 3]),
                                                     "cpu"))
    after, new = pstate.state_to_numpy(st), pstate.state_to_numpy(fresh)
    for name in pstate.FIELD_NAMES:
        if name in ("wq_meta", "wq_value", "wq_flags") or name.startswith(
                ("lq_", "dq_", "pq_")) or name in ("global_step",
                                                   "wq_count"):
            assert (after[name] == before[name]).all(), name
            continue
        assert (after[name][[0, 2]] == before[name][[0, 2]]).all(), name
        assert (after[name][[1, 3]] == new[name]).all(), name


def test_program_and_net_state_copies_equal_their_sources():
    for n in (1, 7, 11):
        assert assemble_to_code_words(bp.scheduler_program(n)) \
            == test_scheduler._prog(n)
    assert bp.SCHEDULER_LENGTHS == test_scheduler.LENGTHS
    # net-state readers on random rows, and the log join columns
    rng = np.random.RandomState(3)
    B, S, E = 3, 4, 5
    st_key = rng.randint(0, 1 << 32, (B, S, 14), dtype=np.uint64) \
        .astype(np.uint32)
    st_val = rng.randint(0, 1 << 32, (B, S, 8), dtype=np.uint64) \
        .astype(np.uint32)
    st_used = rng.rand(B, S) < 0.6
    ev = [rng.randint(0, 1 << 32, (B, E, w), dtype=np.uint64)
          .astype(np.uint32) for w in (2, 8, 8)]
    ev_cancelled = rng.rand(B, E) < 0.3
    ev_count = np.array([5, 2, 0], dtype=np.int32)
    for b in range(B):
        assert net_states.storage_map_of(st_key, st_val, st_used, b) \
            == jnet.storage_map_of(st_key, st_val, st_used, b)
        entries = net_states.event_entries_of(*ev, ev_cancelled, ev_count, b)
        assert entries == jnet.event_entries_of(*ev, ev_cancelled, ev_count,
                                                b)
        by_ts = {e[0]: (rng.randint(1 << 20), rng.randint(2))
                 for e in entries}
        for mine, theirs in zip(net_states.messages_from_join(entries, by_ts),
                                jnet.messages_from_join(entries, by_ts)):
            assert _messages(mine) == _messages(theirs)
    assert [f.name for f in dataclasses.fields(net_states.EventMessage)] \
        == [f.name for f in dataclasses.fields(jnet.EventMessage)]
    words = rng.randint(0, 1 << 32, (7, 32), dtype=np.uint64) \
        .astype(np.uint32)
    for mine, theirs in zip(packed.log_join_columns(words),
                            jpacked.log_join_columns(words)):
        assert (np.asarray(mine) == np.asarray(theirs)).all()
