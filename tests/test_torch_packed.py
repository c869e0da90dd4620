"""The port's packed witness streams (`witness/packed.py`) against the JAX
package's: the record serializers, the dense and compacted drains, the
per-stream keccak256 digests, the block folds and the sorted-log grand
products, all bit for bit; then the log family's witness path end to end, a
tiny-mix wave run to its end with compacted drains (`testing/wave.py`).
The objects form too: the query structs (`witness/queries.py`, a copy of
the golden module), the `device_*_streams` readers, the round counts, the
host commitments and the object drain (`models/spill.py`) against the JAX
package's on the same state, and `queries_from_packed` of the packed
drain against the object drain.

The port side runs on the CPU, so its K3 wrapper takes the plain
permutation."""

import dataclasses
import enum

import jax
import numpy as np
import pytest

from era_zk_evm_tpu.golden import queries as jqueries
from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig, make_entry_state, run_cycles
from era_zk_evm_tpu.models import spill as jspill
from era_zk_evm_tpu.ops.goldilocks import GOLDILOCKS_P
from era_zk_evm_tpu.witness import commitment as jcommitment
from era_zk_evm_tpu.witness import packed as jpacked
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import spill
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import programs
from era_zk_evm_tpu_torch.testing.wave import run_wave, wave_commitments
from era_zk_evm_tpu_torch.witness import commitment, packed, queries

from test_packed import _rich_state
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

FAMILIES = ("memory", "log", "decommit", "precompile")
#: bench.py bench_block's drain budget fractions
FRACS = {"memory": 0.125, "log": 0.5}
SEGMENT = 256


def as_tuples(stream) -> list[tuple]:
    """Query structs of either package as comparable tuples: the class
    name, then the fields, enums as ints (a frozen dataclass compares
    equal to its own class only)."""
    return [(type(q).__name__,) + tuple(
        int(v) if isinstance(v, enum.Enum) else v
        for v in dataclasses.astuple(q)) for q in stream]


def assert_same_streams(ref: list, got: list, what: str = "") -> None:
    """Per-lane (or per-tx) query-struct streams equal as tuples."""
    assert len(ref) == len(got), what
    for i, (a, b) in enumerate(zip(ref, got)):
        assert as_tuples(a) == as_tuples(b), (what, i)


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def rich():
    """(JAX state, JAX config, port state on the CPU, port config)."""
    state, config = _rich_state()
    port = pstate.state_from_numpy(_jax_numpy(state), "cpu")
    return state, config, port, from_jax_config(config)


@pytest.fixture(scope="module")
def jax_streams(rich):
    """{family: per-lane record arrays} from the JAX dense drain."""
    state, config, _, _ = rich
    _, dense = jpacked.drain_witness_queues_packed(state, config)
    return {name: jpacked.split_records_by_lane(*rec)
            for name, rec in dense.items()}


def test_serializers_match_jax(rich):
    state, _, port, _ = rich
    ref = jax.device_get(jpacked._serialize_all(state, FAMILIES))
    got = packed.serialize_all(port, FAMILIES)
    for name in FAMILIES:
        words, valid = got[name]
        assert np.array_equal(words.numpy().view(np.uint32), ref[name][0])
        assert np.array_equal(valid.numpy(), ref[name][1])
        assert valid.any(), f"family {name} not exercised"


def test_dense_and_compacted_drains_match(rich, jax_streams):
    _, _, port, pc = rich
    _, dense = packed.drain_witness_queues_packed(pstate.clone_state(port),
                                                  pc)
    dense = packed.fetch_dense_records(dense)
    st = pstate.clone_state(port)
    _, compact = packed.drain_witness_queues_packed(
        st, pc, compact_frac={name: 0.5 for name in FAMILIES})
    compact = packed.fetch_compacted_rows(compact)
    assert not st.lq_count.any() and not st.wq_meta.any()   # rewound
    for name in FAMILIES:
        want = jax_streams[name]
        got_dense = packed.split_records_by_lane(*dense[name])
        rows, counts, count = compact[name]
        got_compact = packed.split_compacted_by_lane(rows, counts, int(count))
        assert len(got_dense) == len(got_compact) == len(want)
        for w, a, b in zip(want, got_dense, got_compact):
            assert np.array_equal(w, a) and np.array_equal(w, b), name
    # an overflowing budget is detected, not silent
    _, tiny = packed.drain_witness_queues_packed(pstate.clone_state(port), pc,
                                                 compact_frac=0.001)
    with pytest.raises(RuntimeError, match="overflow"):
        packed.fetch_compacted_rows(tiny)


def test_commitments_match_jax(jax_streams):
    for name, streams in jax_streams.items():
        got = packed.commit_packed_streams(streams, "cpu")
        assert got == jpacked.commit_packed_streams(streams), name
        assert packed.fold_digests_device(got, "cpu") \
            == jpacked.fold_digests_device(got), name
    assert packed.fold_digests_device([], "cpu") \
        == jpacked.fold_digests_device([])
    logs = jax_streams["log"]
    assert packed.packed_grand_products(logs, device="cpu") \
        == jpacked.packed_grand_products(logs)
    empty = [np.zeros((0, 32), np.uint32)] * 2
    assert packed.packed_grand_products(empty, device="cpu") == [1, 1]


def _wave_config(batch):
    # bench.py bench_block's geometry (chunk 64, tail_mult 4)
    return VmConfig(batch=batch, code_words=16, stack_words=256,
                    sweep_gating=False, stack_abs_words=64,
                    stack_sp_base=960, heap_words=32, aux_heap_words=16,
                    max_depth=8, queue_capacity=64 * 8 * 4, storage_slots=8,
                    journal_slots=64, event_slots=64,
                    log_queue_capacity=64 * 4)


def _wave_words(batch):
    # bench.py bench_block's tiny mix: iteration counts from RandomState(11)
    lengths = np.random.RandomState(11).choice(
        [4, 8, 16, 32], size=batch, p=[0.5, 0.25, 0.15, 0.1])
    return [assemble_to_code_words(programs.tiny_mix_program(int(n)))
            for n in lengths]


def _jax_wave(config, words):
    st = make_entry_state(config, words, ergs=(1 << 31) - 1)
    parts = {name: [[] for _ in words] for name in ("memory", "log")}
    while True:
        st = run_cycles(st, config, SEGMENT)
        st, drained = jpacked.drain_witness_queues_packed_async(
            st, config, compact_frac=FRACS)
        for name, (rows, counts, count) in \
                jpacked.fetch_compacted_rows(drained).items():
            for b, r in enumerate(jpacked.split_compacted_by_lane(
                    rows, counts, int(count))):
                parts[name][b].append(r)
        if np.asarray(st.done).all():
            assert not np.asarray(st.lane_error).any()
            return {name: [np.concatenate(p) for p in lanes]
                    for name, lanes in parts.items()}


def test_wave_matches_jax():
    config = _wave_config(8)
    words = _wave_words(8)
    ref = _jax_wave(config, words)
    pc = from_jax_config(config)
    st = pstate.make_entry_state(pc, words, ergs=(1 << 31) - 1, device="cpu")
    got = run_wave(st, pc, SEGMENT, compact_frac=FRACS)
    assert bool(st.done.all()) and not bool(st.lane_error.any())
    for name in ("memory", "log"):
        for w, g in zip(ref[name], got[name]):
            assert np.array_equal(w, g), name
    assert all(s.shape[0] for s in got["log"])

    out = wave_commitments(got, "cpu")
    for name in ("memory", "log"):
        digests = jpacked.commit_packed_streams(ref[name])
        assert out["digests"][name] == digests, name
        assert out["folds"][name] == jpacked.fold_digests_device(digests)
    products = jpacked.packed_grand_products(ref["log"])
    assert out["products"] == products
    block = 1
    for p in products:
        block = block * p % GOLDILOCKS_P
    assert out["block_product"] == block


def test_query_structs_equal_their_source():
    for name in ("MemoryType", "MemoryQuery", "LogQuery",
                 "DecommittmentQuery", "RefundType", "EventMessage"):
        mine, theirs = getattr(queries, name), getattr(jqueries, name)
        if issubclass(theirs, enum.Enum):
            assert [(m.name, m.value) for m in mine] \
                == [(m.name, m.value) for m in theirs], name
        else:
            assert [(f.name, f.type) for f in dataclasses.fields(mine)] \
                == [(f.name, f.type) for f in dataclasses.fields(theirs)], name
    assert queries.RefundType.REPEATED_WRITE.pubdata_refund() == 0
    q = queries.LogQuery(*range(11))
    assert q.with_(key=70).key == 70 and q.key == 5


_READERS = ("device_queue_streams", "device_log_streams",
            "device_decommit_streams", "device_precompile_streams")


def test_device_streams_match_jax(rich):
    state, config, port, pc = rich
    for name in _READERS:
        ref = getattr(jcommitment, name)(state)
        got = getattr(commitment, name)(port)
        assert any(ref), f"{name} not exercised"
        assert_same_streams(ref, got, name)
    rounds = commitment.device_precompile_rounds(port, pc)
    assert any(rounds)
    assert rounds == jcommitment.device_precompile_rounds(state, config)
    assert commitment.commit_all_device_queues(port) \
        == jcommitment.commit_all_device_queues(state)
    assert commitment.commit_device_queues(port) \
        == jcommitment.commit_device_queues(state)


def test_object_drain_matches_jax_and_the_packed_drain(rich):
    state, config, port, pc = rich
    _, ref = jspill.drain_witness_queues(state, config)
    st, got = spill.drain_witness_queues(pstate.clone_state(port), pc)
    assert not st.lq_count.any() and not st.wq_meta.any()     # rewound
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert_same_streams(ref[name], got[name], name)
    _, dense = packed.drain_witness_queues_packed(pstate.clone_state(port),
                                                  pc)
    for name, rec in packed.fetch_dense_records(dense).items():
        lanes = packed.split_records_by_lane(*rec)
        assert [packed.queries_from_packed(name, w) for w in lanes] \
            == got[name], name
    with pytest.raises(ValueError, match="family"):
        packed.queries_from_packed("storage", lanes[0])
