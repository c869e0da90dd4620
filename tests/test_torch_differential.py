"""The port's golden-backed differential harness (`testing/differential.py`,
`testing/harness.py`): the port's engine against the port's own golden
copy, with no JAX involved.

`diff_run` replays program sets of the JAX package's differential tests
(`tests/test_batched_vm.py`, `tests/test_batched_far_call.py`,
`tests/test_batched_precompiles.py`, in the port's jax-free copies, held
equal here) through the port's engine on CPU tensors (the plain versions
of its kernels) and through golden, comparing every observable.  One run
happens in a subprocess in which `import jax` fails, and a deliberately
perturbed device state must raise `DifferentialMismatch`, so the harness
is shown not to pass vacuously.
"""

import ast
import inspect
import subprocess
import sys
import textwrap

import pytest

import test_batched_vm
from era_zk_evm_tpu_torch.config import VmConfig
from era_zk_evm_tpu_torch.isa import params
from era_zk_evm_tpu_torch.testing import differential, harness
from era_zk_evm_tpu_torch.testing import log_programs as lp
from era_zk_evm_tpu_torch.testing import vm_programs as vp
from era_zk_evm_tpu_torch.testing.block_programs import (
    KECCAK_PROGRAMS, ROUND_WITNESS_PROGRAMS,
)
from era_zk_evm_tpu_torch.testing.differential import (
    DifferentialMismatch, diff_run,
)

from test_torch_slice import ROOT
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401


def _precompile_config(batch, max_cycles, **kw):
    # tests/test_batched_precompiles.py::_config
    return VmConfig(
        batch=batch, queue_capacity=max_cycles * 8, heap_words=64,
        stack_words=2048, code_words=64, max_depth=8,
        storage_slots=16, journal_slots=32, event_slots=32,
        log_queue_capacity=max_cycles, heap_frames=2, code_pages=2,
        decommit_queue_capacity=max_cycles,
        precompile_keccak_blocks=3, precompile_sha_rounds=3, **kw)


KECCAK = params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS
SETS = {
    "basic": (vp.BASIC_PROGRAMS, dict(max_cycles=64)),
    "control_flow": (vp.CONTROL_FLOW, dict(max_cycles=64)),
    "stack_uma": (vp.STACK_PROGRAMS[:2] + vp.UMA_PROGRAMS[:2],
                  dict(max_cycles=64)),
    "far_calls": (lp.FAR_PROGRAMS, dict(contracts=lp.CONTRACTS,
                                        max_cycles=128)),
    "precompile": (KECCAK_PROGRAMS, dict(
        config=_precompile_config(len(KECCAK_PROGRAMS), 128),
        max_cycles=128, entry_address=KECCAK)),
    "round_witness": (ROUND_WITNESS_PROGRAMS, dict(
        config=_precompile_config(len(ROUND_WITNESS_PROGRAMS), 96,
                                  precompile_queue_capacity=15 * 4),
        max_cycles=96, entry_address=KECCAK)),
    "calldata": (vp.CALLDATA_PROGRAMS, dict(calldata=vp.CALLDATA,
                                            max_cycles=64)),
}


@pytest.mark.parametrize("name", list(SETS))
def test_diff_run_against_golden(name):
    programs, kw = SETS[name]
    diff_run(programs, device="cpu", **kw)


def test_program_copies_equal_their_sources():
    tv = test_batched_vm
    assert vp.BASIC_PROGRAMS == tv.BASIC_PROGRAMS
    assert vp.CONTROL_FLOW == tv.CONTROL_FLOW
    assert vp.STACK_PROGRAMS == tv.STACK_PROGRAMS
    assert vp.UMA_PROGRAMS == tv.UMA_PROGRAMS
    # the calldata programs live inside a test method of the source file
    src = inspect.getsource(tv.TestDifferential.test_bootloader_calldata)
    assert "diff_run(progs, calldata=[0xDEADBEEF << 128, 0x1234, " \
        "(1 << 255) | 7])" in src
    assert [textwrap.dedent(p) for p in vp.CALLDATA_PROGRAMS] == [
        textwrap.dedent(p) for p in ast.literal_eval(
            src[src.index("progs = [") + 8:src.index("]\n", src.index(
                "progs = [")) + 1])]


def test_perturbed_state_raises(monkeypatch):
    run = differential.fused_cycle.run_cycles

    def perturbed(state, config, n):
        run(state, config, n)
        state.regs[1, 2, 0] ^= 1          # lane 1, r3, lowest limb
        return state

    monkeypatch.setattr(differential.fused_cycle, "run_cycles", perturbed)
    with pytest.raises(DifferentialMismatch, match="lane 1: r3"):
        diff_run(vp.BASIC_PROGRAMS[:2], max_cycles=32, device="cpu")


def test_limb_major_arenas_raise():
    with pytest.raises(NotImplementedError):
        diff_run(vp.BASIC_PROGRAMS[:1], max_cycles=32, device="cpu",
                 config_overrides={"limb_major_arenas": True})


def test_harness_helpers_match_golden():
    vm, tools, cycles = harness.run_golden_like(vp.BASIC_PROGRAMS[0])
    assert vm.execution_has_ended() and cycles == 5
    assert harness.reg(vm, 3) == 42 and harness.reg(vm, 4) == 35
    assert not harness.flags(vm).overflow_or_less_than
    nets = harness.get_final_net_states(tools)
    assert nets["events"] == [] and nets["storage_history"] == []
    vm, _, _ = differential.run_golden(vp.BASIC_PROGRAMS[0], 64)
    assert harness.reg(vm, 3) == 42


def test_harness_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from era_zk_evm_tpu_torch.testing import differential, harness\n"
        "from era_zk_evm_tpu_torch.testing import vm_programs as vp\n"
        "differential.diff_run(vp.BASIC_PROGRAMS[:2], max_cycles=32,\n"
        "                      device='cpu')\n"
        "vm, tools, cycles = harness.run_golden_like(vp.BASIC_PROGRAMS[0])\n"
        "assert harness.reg(vm, 3) == 42\n"
        "bad = [m for m in sys.modules if m.startswith('jax.')\n"
        "       or m == 'era_zk_evm_tpu' or m.startswith('era_zk_evm_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_default_config_is_the_references():
    # diff_run's default geometry is the JAX harness's, as written
    from era_zk_evm_tpu.testing import differential as jdiff

    def default_block(module):
        src = inspect.getsource(module.diff_run)
        return src[src.index("config = config or VmConfig("):
                   src.index("if config_overrides:")]

    assert default_block(differential) == default_block(jdiff)
