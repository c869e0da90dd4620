"""The ported slice as a whole, at the bench geometry: WORKLOAD in two
chained 128-cycle calls with a queue rewind between them, against the JAX
engine, in both modes; plus the port's import hygiene."""

import dataclasses
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig, make_entry_state, run_cycles
from era_zk_evm_tpu.models.spill import _rewind_queues_jit
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.models.spill import rewind_queues
from era_zk_evm_tpu_torch.testing import programs

ROOT = pathlib.Path(__file__).resolve().parent.parent
LANES, K, ERGS = 8, 128, (1 << 31) - 1


def _bench_config(rolling):
    # bench.py's geometry (bench() / bench_rolling()) at 8 lanes
    return VmConfig(batch=LANES, code_words=16, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=64, aux_heap_words=16, max_depth=8,
                    queue_capacity=0 if rolling else K * 8,
                    rolling_commitment=rolling)


def _two_calls(rolling):
    config = _bench_config(rolling)
    words = [assemble_to_code_words(programs.WORKLOAD)] * LANES
    ref = make_entry_state(config, words, ergs=ERGS)
    st = pstate.make_entry_state(from_jax_config(config), words, ergs=ERGS)
    for _ in range(2):
        ref = _rewind_queues_jit(run_cycles(ref, config, K))
        fused_cycle.run_cycles(st, from_jax_config(config), K)
        rewind_queues(st)
    ref = {f.name: np.asarray(getattr(ref, f.name))
           for f in dataclasses.fields(ref)}
    return ref, pstate.state_to_numpy(st)


@pytest.mark.parametrize("mode", ["queue", "rolling"])
def test_workload_two_chained_calls_match_jax(mode):
    ref, got = _two_calls(rolling=mode == "rolling")
    bad = [k for k in ref if ref[k].shape != got[k].shape
           or not (ref[k] == got[k]).all()]
    assert not bad, f"port/jax mismatch in fields: {bad}"
    assert not got["lane_error"].any()
    assert (got["monotonic_cycle_counter"] == 2 * K).all()
    if mode == "rolling":
        assert got["wc_count"].all()


def test_workload_copy_equals_bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert programs.WORKLOAD == bench.WORKLOAD


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from era_zk_evm_tpu_torch.config import VmConfig\n"
        "from era_zk_evm_tpu_torch.models import fused_cycle, state\n"
        "from era_zk_evm_tpu_torch.models.spill import rewind_queues\n"
        "from era_zk_evm_tpu_torch.testing.programs import WORKLOAD, assemble\n"
        "from era_zk_evm_tpu_torch.witness.rolling import finalize_rolling\n"
        "from era_zk_evm_tpu_torch import _build\n"
        "cfg = VmConfig(batch=2, code_words=16, stack_words=256,\n"
        "               stack_abs_words=64, stack_sp_base=960, heap_words=64,\n"
        "               aux_heap_words=16, max_depth=8,\n"
        "               rolling_commitment=True)\n"
        "st = state.make_entry_state(cfg, [assemble(WORKLOAD)] * 2)\n"
        "fused_cycle.run_cycles(st, cfg, 8)\n"
        "rewind_queues(st)\n"
        "finalize_rolling(st.wc_state, st.wc_count)\n"
        "assert int(st.monotonic_cycle_counter[0]) == 8\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)

