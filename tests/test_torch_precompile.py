"""The keccak256 / sha256 precompile units and their round-witness queue
against the JAX engine `run_cycles`: every BatchedVmState field, bit for
bit, the precompile rows included.

The port side runs on CPU tensors (its dispatcher takes the plain torch
cycle step).  One config serves every run, the block test of
`tests/test_torch_block.py` included, so XLA compiles one cycle program:
`precompile_config()`, 16 lanes, the units on (2 keccak blocks, 2 sha256
rounds) and a round-witness queue of CHUNK blocks.  The runs:
  * the precompile programs of `tests/test_batched_precompiles.py` and
    `tests/test_fused_cycle.py` (keccak, sha256, out of ergs, the round
    witness and the block clock), one lane each, in a CHUNK-cycle call that
    the port runs in chunks of 5 cycles;
  * the precompile mix's two loops at 16 phases, two chained calls with no
    drain: the batch-global block clock passes the queue's capacity, so the
    queue overflows (lane_error on every emitting lane), and every field
    still agrees.
"""

import ast
import dataclasses
import hashlib
import inspect
import textwrap

import numpy as np
import pytest

import test_batched_precompiles
import test_fused_cycle
from era_zk_evm_tpu.golden.precompiles import keccak256
from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig, make_entry_state, run_cycles
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import block_programs as bp

from test_torch_log import _words
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

LANES, CHUNK, ERGS = 16, 32, 1 << 20
PAD = (bp.params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS, "ret r0")


def precompile_config(batch: int = LANES) -> VmConfig:
    """The units on, a round-witness queue of CHUNK blocks; the memory, log
    and decommit queues hold 4 * CHUNK cycles, so chained calls overflow
    only the precompile queue."""
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    sweep_gating=False, stack_abs_words=64,
                    stack_sp_base=960, heap_words=32, aux_heap_words=16,
                    max_depth=8, queue_capacity=4 * CHUNK * 8,
                    storage_slots=8, journal_slots=64, event_slots=16,
                    log_queue_capacity=4 * CHUNK, heap_frames=2,
                    code_pages=2, decommit_queue_capacity=4 * CHUNK,
                    precompile_keccak_blocks=2, precompile_sha_rounds=2,
                    precompile_queue_capacity=CHUNK * 11)


def _lanes(lanes):
    lanes = list(lanes) + [PAD] * (LANES - len(lanes))
    return ([assemble_to_code_words(src) for _, src in lanes],
            [entry for entry, _ in lanes])


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _assert_same(ref, got):
    bad = [k for k in ref if ref[k].shape != got[k].shape
           or not (ref[k] == got[k]).all()]
    assert not bad, f"port/jax mismatch in fields: {bad}"


def _both(lanes, calls, k_inner):
    """`calls` chained CHUNK-cycle calls on both engines, no drain."""
    config = precompile_config()
    words, entries = _lanes(lanes)
    ref = make_entry_state(config, words, ergs=ERGS, entry_address=entries)
    st = pstate.make_entry_state(from_jax_config(config), words, ergs=ERGS,
                                 entry_address=entries, device="cpu")
    for _ in range(calls):
        ref = run_cycles(ref, config, CHUNK)
        fused_cycle.run_cycles(st, from_jax_config(config), CHUNK,
                               k_inner=k_inner)
    return _jax_numpy(ref), pstate.state_to_numpy(st)


def _heap_word(arrays, lane, word):
    limbs = arrays["heap"][lane, word]
    return sum(int(x) << (32 * i) for i, x in enumerate(limbs))


def test_precompile_programs_match_jax():
    ref, got = _both(bp.PRECOMPILE_LANES, calls=1, k_inner=5)
    _assert_same(ref, got)
    assert got["done"].all() and not got["lane_error"].any()
    # the units' results: keccak256 of 4 bytes, sha256("abc")
    assert _heap_word(got, 0, 2) == int.from_bytes(
        keccak256(b"abcd"), "big")
    sha_lane = next(i for i, (e, p) in enumerate(bp.PRECOMPILE_LANES)
                    if p == bp.SHA_PROGRAM)
    assert _heap_word(got, sha_lane, 2) == int.from_bytes(
        hashlib.sha256(b"abc").digest(), "big")
    # the round-witness queue: rows for every call but the out-of-ergs one
    assert got["pq_count"].sum() > 0 and got["pq_blocks"].min() > 1
    assert (got["pq_flags"] & 4).any()


def _shifted(source: str, k: int) -> str:
    """The program with k one-cycle instructions before its loop."""
    return source.replace("loop:", "add 0, r0, r0\n" * k + "loop:", 1)


def test_round_witness_overflow_matches_jax():
    # the mix's two loops at 16 phases: nearly every cycle is flagged, so
    # two chained calls take more blocks than the queue holds
    lanes = [(bp.params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS,
              _shifted(bp.keccak_mapping_program(32), k)) for k in range(9)]
    lanes += [(bp.params.SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS,
               _shifted(bp.sha_rounds_program(32, 1 + k % 2), k))
              for k in range(7)]
    ref, got = _both(lanes, calls=2, k_inner=CHUNK)
    _assert_same(ref, got)
    cap, ps = precompile_config().precompile_queue_capacity, 11
    assert got["pq_blocks"].min() * ps > cap
    assert got["lane_error"].all()
    # the lanes' credited slots fill the queue's blocks, no more
    assert got["pq_count"].sum() <= cap * LANES


_RUNS_AN_ENGINE = ("diff_run", "self.", "run_cycles", "make_entry_state",
                   "assert")


def _method_programs(func, self_obj=None) -> list[str]:
    """The program sources written as string literals in a test method, in
    source order, evaluated with the method's own local definitions (its
    statements are replayed up to the engine runs, which are skipped).
    With `self_obj`, statements that call the test class's helpers run
    too, on that instance."""
    module = inspect.getmodule(func)
    tree = ast.parse(textwrap.dedent(inspect.getsource(func)))
    body = tree.body[0].body
    ns = dict(vars(module))
    skip = _RUNS_AN_ENGINE
    if self_obj is not None:
        ns["self"] = self_obj
        skip = tuple(w for w in skip if w != "self.")
    for stmt in body:
        src = ast.unparse(stmt)
        if any(word in src for word in skip):
            continue
        try:
            exec(compile(ast.Module([stmt], []), "<test>", "exec"), ns)
        except Exception:        # a statement that needs an engine's result
            continue
    out = []

    def visit(node):
        if isinstance(node, ast.JoinedStr) or (
                isinstance(node, ast.Constant) and isinstance(node.value, str)):
            if "ret" in ast.unparse(node):
                out.append(eval(compile(ast.Expression(node), "<test>",
                                        "eval"), ns))
            return                       # not into an f-string's parts
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in body:
        visit(stmt)
    return out


def test_precompile_program_copies_equal_their_sources():
    tb, tf = test_batched_precompiles, test_fused_cycle
    pp = tb.TestDevicePrecompiles
    assert _words(bp.KECCAK_PROGRAMS) == _words(
        _method_programs(pp.test_keccak_cases))
    assert _words([bp.SHA_PROGRAM]) == _words(
        _method_programs(pp.test_sha256_rounds))
    assert _words([bp.OUT_OF_ERGS_PROGRAM]) == _words(
        _method_programs(pp.test_precompile_extra_cost_out_of_ergs))
    assert _words(bp.ROUND_WITNESS_PROGRAMS) == _words(_method_programs(
        tb.TestPrecompileRoundWitness.test_keccak_and_sha_round_witness))
    assert _words(bp.FUSED_KECCAK_PROGRAMS) == _words(
        _method_programs(tf.TestFusedPrecompiles.test_keccak_cases))
    assert _words([bp.FUSED_SHA_PROGRAM]) == _words(
        _method_programs(tf.TestFusedPrecompiles.test_sha256_rounds))
    assert _words([bp.PQ_CLOCK_PROGRAM]) == _words(_method_programs(
        tf.TestFusedPrecompileRoundWitness.test_pq_streams_and_clock))
    for args in ((3, 40, 3), (0, 0, 0)):
        assert bp.keccak_abi(*args) == tb.keccak_abi(*args)
    assert bp.sha_abi(0, 2, 4) == tb.sha_abi(0, 2, 4)


@pytest.mark.parametrize("kw", [
    {"precompile_keccak_blocks": 2},
    {"precompile_sha_rounds": 2, "precompile_queue_capacity": 8},
    {"precompile_keccak_blocks": 3, "precompile_sha_rounds": 3,
     "precompile_queue_capacity": 64},
])
def test_configs_with_the_units_are_in_the_slice(kw):
    from era_zk_evm_tpu.models.fused_cycle import supported
    from era_zk_evm_tpu_torch.config import check_slice

    jc = VmConfig(batch=1, storage_slots=4, **kw)
    assert supported(jc)
    check_slice(from_jax_config(jc))
    assert fused_cycle.precompile_instance(from_jax_config(jc)) \
        == (jc.precompile_keccak_blocks > 0)


def test_precompile_block_matches_jax():
    # the precompile mix as a block (its short txs): 16 lanes refilled from
    # 24 txs, the round-witness family among the commitments
    from era_zk_evm_tpu.block import execute_block as jax_execute_block
    from era_zk_evm_tpu.models import TxSpec as JTxSpec
    from era_zk_evm_tpu_torch import block
    from test_torch_block import assert_same_block

    mix = [t for t in bp.precompile_mix(4 * LANES, seed=3) if t[2] <= 8]
    txs = [block.TxSpec(program=assemble_to_code_words(src), ergs=1 << 22,
                        entry_address=entry, cost_hint=n)
           for entry, src, n, _ in mix[:LANES + 8]]
    kw = dict(chunk=CHUNK, order="cost_desc", refill_frac=0.25)
    ref = jax_execute_block(precompile_config(), [
        JTxSpec(**dataclasses.asdict(t)) for t in txs], engine="jnp", **kw)
    got = block.execute_block(from_jax_config(precompile_config()), txs,
                              device="cpu", **kw)
    assert got.all_ok
    assert_same_block(ref, got)
    assert sorted(got.commitments) == ["decommit", "log", "memory",
                                       "precompile"]
    assert all(r.streams["precompile"].shape[0] for r in got.txs)
