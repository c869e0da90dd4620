"""The port's sorted queue (`witness/sorted_queue.py`), Goldilocks field
(`ops/goldilocks.py`) and device fold (`witness/device_fold.py`) against
the JAX package's.

The port's plain engine runs `tests/test_sorted_queue.py`'s log mixes at
its geometry (batch 2, 32 cycles); the sort, the fingerprints, the grand
products and the block product equal the JAX functions applied eagerly to
the port's final arrays in the reference layout, and the host references
on the port's object streams; the sorted queue commits to the product of
the emission-ordered one.  Equality is exact: these are integers."""

import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_sorted_queue
from era_zk_evm_tpu.golden import queries as jqueries
from era_zk_evm_tpu.ops import goldilocks as jgl
from era_zk_evm_tpu.witness import commitment as jcommitment
from era_zk_evm_tpu.witness import device_fold as jfold
from era_zk_evm_tpu.witness import sorted_queue as jsq
from era_zk_evm_tpu_torch.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.ops import goldilocks as gl
from era_zk_evm_tpu_torch.testing import witness_programs as wp
from era_zk_evm_tpu_torch.witness import commitment, device_fold, queries
from era_zk_evm_tpu_torch.witness import sorted_queue as sq
from test_torch_packed import as_tuples
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

P = gl.GOLDILOCKS_P
CYCLES = 32


@pytest.fixture(scope="module")
def run():
    """(port state after the run, the same arrays as a namespace of jnp
    arrays in the reference layout)."""
    config = wp.sorted_queue_config(2)
    words = [assemble_to_code_words(p) for p in (wp.PROG, wp.PROG2)]
    st = pstate.make_entry_state(config, words, ergs=1 << 20, device="cpu")
    fused_cycle.run_cycles(st, config, CYCLES)
    assert not bool(st.lane_error.any())
    arrays = pstate.state_to_numpy(st)
    return st, types.SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in arrays.items()})


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


def _ints(lo, hi) -> list[int]:
    return [int(a) | (int(b) << 32)
            for a, b in zip(np.asarray(lo).reshape(-1),
                            np.asarray(hi).reshape(-1))]


def test_program_copies_equal_their_sources():
    assert (wp.PROG, wp.PROG2) == (test_sorted_queue.PROG,
                                   test_sorted_queue.PROG2)
    src = inspect.getsource(test_sorted_queue._run)
    config = wp.sorted_queue_config(2)
    for f in ("queue_capacity", "heap_words", "stack_words", "code_words",
              "max_depth", "storage_slots", "journal_slots", "event_slots",
              "log_queue_capacity"):
        assert f"{f}={getattr(config, f)}" in src, f
    assert f"config, {CYCLES})" in src


def test_sort_and_blocks_match_jax(run):
    st, ns = run
    got = sq.sort_log_queue(st)
    ref = jsq.sort_log_queue(ns)
    for a, b in zip(ref, got):
        assert a.shape == b.shape
        assert (np.asarray(a) == _u32(b)).all()
    assert (np.asarray(jsq.log_queue_blocks(ns))
            == _u32(sq.log_queue_blocks(st))).all()


def test_fingerprints_and_products_match_jax(run):
    st, ns = run
    (lo, hi), valid = sq.log_queue_fingerprints(st)
    (jlo, jhi), jvalid = jsq.log_queue_fingerprints(ns)
    assert (np.asarray(jvalid) == valid.numpy()).all() and valid.any()
    assert _ints(jlo, jhi) == _ints(lo, hi)
    plo, phi = sq.grand_product(lo, hi, valid)
    jplo, jphi = jsq.grand_product(jlo, jhi, jvalid)
    assert _ints(jplo, jphi) == _ints(plo, phi)
    blo, bhi = sq.block_grand_product(plo, phi)
    jblo, jbhi = jsq.block_grand_product(jplo, jphi)
    assert _ints(jblo[None], jbhi[None]) == _ints(blo[None], bhi[None])
    want = 1
    for x in _ints(plo, phi):
        want = want * x % P
    assert _ints(blo[None], bhi[None]) == [want]


def test_host_references_and_permutation_identity(run):
    st, _ = run
    (lo, hi), valid = sq.log_queue_fingerprints(st)
    fps = np.array(_ints(lo, hi), dtype=object).reshape(valid.shape)
    plo, phi = sq.grand_product(lo, hi, valid)
    products = _ints(plo, phi)
    streams = commitment.device_log_streams(st)
    for b, lane in enumerate(streams):
        assert lane
        assert list(fps[b][valid[b].numpy()]) \
            == [sq.host_fingerprint(q) for q in lane]
        assert products[b] == sq.host_grand_product(lane)
    # the sorted copy: the host sort of the same stream, and the same
    # product (the permutation identity)
    sorted_st = pstate.clone_state(st)
    ref = pstate.reference_view(sorted_st)
    for name, arr in zip(("lq_meta", "lq_addr", "lq_key", "lq_read",
                          "lq_written"), sq.sort_log_queue(st)):
        getattr(ref, name).copy_(arr)
    for lane, got in zip(streams, commitment.device_log_streams(sorted_st)):
        assert as_tuples(sorted(lane, key=sq.host_sort_key)) \
            == as_tuples(got)
    (slo, shi), svalid = sq.log_queue_fingerprints(sorted_st)
    assert _ints(*sq.grand_product(slo, shi, svalid)) == products


def test_goldilocks_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.integers(0, P, size=512, dtype=np.uint64)
    b = rng.integers(0, P, size=512, dtype=np.uint64)
    edge = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, 1 << 63,
                     (1 << 64) - 1 - (1 << 32)], dtype=np.uint64) % P
    a[:8], b[:8] = edge, edge[::-1]
    a[8:16], b[8:16] = edge, edge

    def halves(v, dtype):
        return ((v & 0xFFFFFFFF).astype(dtype), (v >> 32).astype(dtype))

    for mine, theirs, op in ((gl.gl_mul, jgl.gl_mul, lambda x, y: x * y),
                             (gl.gl_add, jgl.gl_add, lambda x, y: x + y)):
        got = mine(*(torch.from_numpy(h) for h in
                     halves(a, np.int64) + halves(b, np.int64)))
        ref = theirs(*(jnp.asarray(h) for h in
                       halves(a, np.uint32) + halves(b, np.uint32)))
        want = [op(int(x), int(y)) % P for x, y in zip(a, b)]
        assert _ints(*got) == _ints(*ref) == want
    vals = np.array([0, 1, P - 1, P, P + 5, (1 << 64) - 1], dtype=np.uint64)
    got = gl.gl_reduce64(*(torch.from_numpy(h)
                           for h in halves(vals, np.int64)))
    assert _ints(*got) == [int(v) % P for v in vals]


def _memory_queries(module, n, rng):
    return [module.MemoryQuery(
        timestamp=int(rng.integers(1 << 32)),
        memory_type=module.MemoryType(int(rng.integers(5))),
        page=int(rng.integers(1 << 32)), index=int(rng.integers(1 << 32)),
        value=int.from_bytes(rng.bytes(32), "big"),
        value_is_pointer=bool(rng.integers(2)), rw_flag=bool(rng.integers(2)))
        for _ in range(n)]


@pytest.mark.parametrize("n", [0, 1, 4, 17, 34])
def test_device_fold_and_rolling_commit_match_jax(n):
    rng = np.random.default_rng(n)
    state = rng.integers(0, 1 << 32, (n, 25, 2), dtype=np.uint64) \
        .astype(np.uint32)
    count = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    rows = device_fold.finalize_rolling_device(
        torch.from_numpy(state.view(np.int32)),
        torch.from_numpy(count.view(np.int32)))
    ref = jfold.finalize_rolling_device(jnp.asarray(state), jnp.asarray(count))
    assert (np.asarray(ref) == _u32(rows)).all()
    digests = device_fold.digest_rows_to_bytes(rows)
    assert digests == jfold.digest_rows_to_bytes(ref)
    stream = device_fold.keccak256_device_stream(rows)
    assert (np.asarray(jfold.keccak256_device_stream(ref)) == _u32(stream)) \
        .all()
    assert device_fold.digest_rows_to_bytes(stream[None])[0] \
        == commitment.block_commitment(digests) \
        == jcommitment.block_commitment(digests)
    seed = int(rng.integers(1 << 31))
    mine = _memory_queries(queries, n, np.random.default_rng(seed))
    theirs = _memory_queries(jqueries, n, np.random.default_rng(seed))
    assert as_tuples(mine) == as_tuples(theirs)
    assert commitment.rolling_commit(mine) \
        == jcommitment.rolling_commit(theirs)
    assert commitment.commit_memory_queue(mine) \
        == jcommitment.commit_memory_queue(theirs)


def test_device_rolling_commitments_match_jax():
    rng = np.random.default_rng(5)
    wc_state = rng.integers(0, 1 << 32, (3, 25, 2), dtype=np.uint64) \
        .astype(np.uint32)
    wc_count = np.array([0, 1, 77], dtype=np.uint32)
    mine = types.SimpleNamespace(
        wc_state=torch.from_numpy(wc_state.view(np.int32)),
        wc_count=torch.from_numpy(wc_count.view(np.int32)))
    theirs = types.SimpleNamespace(wc_state=wc_state, wc_count=wc_count)
    assert commitment.device_rolling_commitments(mine) \
        == jcommitment.device_rolling_commitments(theirs)
