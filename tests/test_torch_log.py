"""The storage-enabled engine, LOG family and FAR_CALL, against the JAX
engine `run_cycles`: every BatchedVmState field, bit for bit.

The port side runs on CPU tensors, so its dispatcher takes the plain torch
cycle step.  All runs use `test_fused_cycle._log_config(16, 128)` (storage,
journal and event slots, the memory, log and decommit queues, four heap
frames and code pages), so XLA compiles one shape.  The program sets of
`tests/test_batched_vm.py`, `tests/test_fused_cycle.py` and
`tests/test_batched_far_call.py`, in the port's jax-free copy
(`testing/log_programs.py`, held equal to them here), share two 16-lane
runs, each lane with its own storage entries and code bank, padded with
`ret r0` lanes; the tests then compare each set's lanes, and the whole
state.
"""

import ast
import dataclasses
import importlib.util
import inspect
import pathlib
import textwrap

import numpy as np
import pytest

import test_batched_far_call
import test_batched_vm
import test_fused_cycle
from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig, make_entry_state, run_cycles
from era_zk_evm_tpu.models.spill import _rewind_queues_jit
from era_zk_evm_tpu.models.state import populate_code_bank, populate_storage
from era_zk_evm_tpu_torch.config import BATCH_LAST_FIELDS, from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.models.spill import rewind_queues
from era_zk_evm_tpu_torch.testing import log_programs as lp
from era_zk_evm_tpu_torch.testing import programs

from test_fused_cycle import _config, _log_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
LANES, N_CYCLES, ERGS = lp.LANES, 128, 1 << 20
RUNS, SETS = lp.RUNS, lp.SETS
_lane_plan, _stage = lp.lane_plan, lp.stage


def _jax_entry(config, run):
    words, entries, banks = _stage(run)
    st = make_entry_state(config, words, ergs=ERGS)
    st = populate_storage(st, config, entries)
    return populate_code_bank(st, config, banks)


def _port_entry(config, run):
    words, entries, banks = _stage(run)
    pc = from_jax_config(config)
    st = pstate.make_entry_state(pc, words, ergs=ERGS, device="cpu")
    pstate.populate_storage(st, pc, entries)
    return pstate.populate_code_bank(st, pc, banks)


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _lanes(arrays, lo, hi):
    return {k: (v[..., lo:hi] if k in BATCH_LAST_FIELDS else v[lo:hi])
            for k, v in arrays.items()}


def _assert_same(ref, got):
    bad = [k for k in ref if ref[k].shape != got[k].shape
           or not (ref[k] == got[k]).all()]
    assert not bad, f"port/jax mismatch in fields: {bad}"


@pytest.fixture(scope="module")
def config():
    return _log_config(LANES, N_CYCLES)


@pytest.fixture(scope="module")
def reference(config):
    """run -> the JAX state after N_CYCLES, as numpy."""
    return {run: _jax_numpy(run_cycles(_jax_entry(config, run), config,
                                       N_CYCLES))
            for run in RUNS}


@pytest.fixture(scope="module")
def port_runs(config):
    out = {}
    for run in RUNS:
        st = _port_entry(config, run)
        fused_cycle.run_cycles(st, from_jax_config(config), N_CYCLES)
        out[run] = pstate.state_to_numpy(st)
    return out


def test_populate_builders_match_jax(config):
    for run in RUNS:
        _assert_same(_jax_numpy(_jax_entry(config, run)),
                     pstate.state_to_numpy(_port_entry(config, run)))


@pytest.mark.parametrize("run,name", SETS, ids=[n for _, n in SETS])
def test_set_matches_jax(run, name, reference, port_runs):
    lo, hi = _lane_plan(run)[2][name]
    ref, got = reference[run], port_runs[run]
    _assert_same(_lanes(ref, lo, hi), _lanes(got, lo, hi))
    _assert_same(ref, got)
    if name == "precompile_off":
        # the precompile units are off: lane_error, as in the JAX engine
        assert got["lane_error"][lo:hi].all() and got["lq_count"][lo:hi].all()
        return
    assert not got["lane_error"][lo:hi].any()
    if name in ("log_programs", "far_programs"):
        assert got["lq_count"][lo:hi].any()
    if name == "far_programs":
        assert got["dq_count"][lo:hi].any()
    if name == "bad_hash":
        # an invalid versioned hash panics to the handler, no lane_error
        assert got["done"][lo:hi].all()


def test_chunked_run_matches_jax(config, reference):
    st = _port_entry(config, "far")
    fused_cycle.run_cycles(st, from_jax_config(config), N_CYCLES, k_inner=20)
    _assert_same(reference["far"], pstate.state_to_numpy(st))


def test_resumed_run_with_rewind_matches_jax(config, reference):
    # two calls with a queue rewind between them, on both engines
    ref = _rewind_queues_jit(run_cycles(_jax_entry(config, "log"), config,
                                        N_CYCLES))
    ref = _jax_numpy(run_cycles(ref, config, N_CYCLES))
    st = _port_entry(config, "log")
    pc = from_jax_config(config)
    fused_cycle.run_cycles(st, pc, N_CYCLES, k_inner=64)
    rewind_queues(st)
    fused_cycle.run_cycles(st, pc, N_CYCLES, k_inner=64)
    _assert_same(ref, pstate.state_to_numpy(st))


def test_storage_workload_matches_jax():
    # bench.py bench_storage's geometry at 8 lanes, 2 x 128 cycles
    config = VmConfig(batch=8, code_words=16, stack_words=256,
                      sweep_gating=False, stack_abs_words=64,
                      stack_sp_base=960, heap_words=16, aux_heap_words=16,
                      max_depth=8, queue_capacity=0, storage_slots=8,
                      journal_slots=64, event_slots=64, log_queue_capacity=0)
    words = [assemble_to_code_words(programs.STORAGE_WORKLOAD)] * 8
    ref = make_entry_state(config, words, ergs=(1 << 31) - 1)
    st = pstate.make_entry_state(from_jax_config(config), words,
                                 ergs=(1 << 31) - 1, device="cpu")
    for _ in range(2):
        ref = run_cycles(ref, config, N_CYCLES)
        fused_cycle.run_cycles(st, from_jax_config(config), N_CYCLES)
    got = pstate.state_to_numpy(st)
    _assert_same(_jax_numpy(ref), got)
    assert not got["lane_error"].any()
    assert (got["j_count"] > 0).all() and (got["ev_count"] > 0).all()


@pytest.mark.parametrize("source", [lp.LOG_PROGRAMS[0],
                                    lp.FAR_PROGRAMS[0]],
                         ids=["log", "far_call"])
def test_no_storage_sets_lane_error(source):
    # without storage slots the LOG unit is off: LOG and FAR_CALL are
    # unsupported, as in the JAX engine
    config = from_jax_config(_config(1))
    st = pstate.make_entry_state(config, [assemble_to_code_words(source)],
                                 ergs=ERGS, device="cpu")
    fused_cycle.run_cycles(st, config, 16)
    assert bool(st.lane_error.all())


def _bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def _fstring(func, start: str, **names) -> str:
    """The f-string template of a bench function that starts at `start`,
    filled with `names`."""

    src = inspect.getsource(func)
    body = src[src.index(start) + len(start):]
    return eval('f"""' + body[:body.index('"""')] + '"""', names)


def test_bench_program_copies_equal_bench():
    from era_zk_evm_tpu.isa.abi import (
        FarCallABI, FatPointer, ForwardingMode, RetABI,
    )

    bench = _bench()
    assert programs.STORAGE_WORKLOAD == bench.STORAGE_WORKLOAD
    assert (f"callee_addr = {programs.FARCALL_CALLEE_ADDRESS:#x}"
            in inspect.getsource(bench.bench_farcall))
    for iters in (4, 8, 16, 32):
        want = _fstring(bench.bench_block, 'assemble_to_code_words(f"""',
                        iters=iters)
        assert assemble_to_code_words(programs.tiny_mix_program(iters)) \
            == assemble_to_code_words(want)
    r_abi = RetABI(FatPointer(0, 0, 0, 32), ForwardingMode.USE_HEAP).to_u256()
    f_abi = FarCallABI(FatPointer(0, 0, 0, 32), (1 << 32) - 1, 0,
                       ForwardingMode.USE_HEAP, False, False).to_u256()
    callee = _fstring(bench.bench_farcall, 'callee_words = '
                      'assemble_to_code_words(f"""', r_abi=r_abi)
    caller = _fstring(bench.bench_farcall, 'caller = '
                      'assemble_to_code_words(f"""', f_abi=f_abi,
                      callee_addr=programs.FARCALL_CALLEE_ADDRESS)
    assert assemble_to_code_words(programs.farcall_callee()) \
        == assemble_to_code_words(callee)
    assert assemble_to_code_words(programs.farcall_caller()) \
        == assemble_to_code_words(caller)


def _method_programs(func) -> list[str]:
    """The program sources written as string literals in a test method, in
    source order, evaluated in the method's module."""
    module = inspect.getmodule(func)
    out = []

    def visit(node):
        if isinstance(node, ast.JoinedStr) or (
                isinstance(node, ast.Constant) and isinstance(node.value, str)):
            if "ret" in ast.unparse(node):
                out.append(eval(compile(ast.Expression(node), "<test>",
                                        "eval"), vars(module)))
            return                       # not into an f-string's parts
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(ast.parse(textwrap.dedent(inspect.getsource(func))))
    return out


def _words(sources) -> list:
    return [assemble_to_code_words(s) for s in sources]


def _contract_words(contracts) -> list:
    return [(a, assemble_to_code_words(s)) for a, s in contracts]


def test_program_set_copies_equal_their_sources():
    fc, vm, fu = test_batched_far_call, test_batched_vm, test_fused_cycle
    assert _words(lp.LOG_PROGRAMS) == _words(vm.LOG_PROGRAMS)
    for name in ("FAR_PROGRAMS", "DELEGATE_PROGRAMS", "PTR_FWD_PROGRAMS"):
        assert _words(getattr(lp, name)) == _words(getattr(fc, name)), name
    for name in ("CONTRACTS", "DELEGATE_CONTRACTS", "PTR_FWD_CONTRACTS",
                 "REVERTDATA_CONTRACT", "NESTED_CONTRACTS", "EDGE_CONTRACT"):
        assert _contract_words(getattr(lp, name)) \
            == _contract_words(getattr(fc, name)), name
    inline = {
        "ROLLBACK": fu.TestFusedLogFamily.test_rollback_on_panic,
        "PUBDATA_OUT_OF_ERGS": fu.TestFusedLogFamily.test_pubdata_out_of_ergs,
        "BAD_HASH": fu.TestFusedFarCall.test_far_call_bad_hash_panics_to_handler,
        "NESTED": fc.TestNestedFarCalls.test_two_level_call_chain,
        "EDGE_TAIL": fc.TestFatPointerEdges.test_tail_masking_and_oob_reads,
    }
    for name, method in inline.items():
        assert _words([getattr(lp, name)]) == _words(_method_programs(method)), \
            name
    prog, callee = _method_programs(
        fc.TestFatPointerEdges.test_unaligned_calldata_window)
    assert _words([lp.EDGE_UNALIGNED]) == _words([prog])
    assert _words([lp.UNALIGNED_CALLEE[0][1]]) == _words([callee])
