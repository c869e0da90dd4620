"""The ported slice as a whole, at the bench geometry: WORKLOAD in two
chained 128-cycle calls with a queue rewind between them, against the JAX
engine, in both modes; plus the port's import hygiene: it imports neither
jax nor anything of the JAX package `era_zk_evm_tpu`."""

import ast
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
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

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
    st = pstate.make_entry_state(from_jax_config(config), words, ergs=ERGS,
                                 device="cpu")
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
    # the CPU paths of the slices, a precompile block through execute_block
    # and the tool probes included, then sys.modules: no jax and no module
    # of the JAX package
    code = (
        "import sys, torch\n"
        "from era_zk_evm_tpu_torch.config import VmConfig\n"
        "from era_zk_evm_tpu_torch.models import compaction, fused_cycle, state\n"
        "from era_zk_evm_tpu_torch.models.spill import rewind_queues\n"
        "from era_zk_evm_tpu_torch.testing.programs import (\n"
        "    STORAGE_WORKLOAD, WORKLOAD, assemble)\n"
        "from era_zk_evm_tpu_torch.testing import wave\n"
        "from era_zk_evm_tpu_torch.witness import packed\n"
        "from era_zk_evm_tpu_torch.witness.rolling import finalize_rolling\n"
        "from era_zk_evm_tpu_torch import _build\n"
        "_build.generate_header()\n"
        "cfg = VmConfig(batch=2, code_words=16, stack_words=256,\n"
        "               stack_abs_words=64, stack_sp_base=960, heap_words=64,\n"
        "               aux_heap_words=16, max_depth=8,\n"
        "               rolling_commitment=True)\n"
        "st = state.make_entry_state(cfg, [assemble(WORKLOAD)] * 2,\n"
        "                            device='cpu')\n"
        "fused_cycle.run_cycles(st, cfg, 8)\n"
        "rewind_queues(st)\n"
        "finalize_rolling(st.wc_state, st.wc_count)\n"
        "assert int(st.monotonic_cycle_counter[0]) == 8\n"
        "cfg = VmConfig(batch=2, code_words=16, stack_words=256,\n"
        "               stack_abs_words=64, stack_sp_base=960, heap_words=16,\n"
        "               aux_heap_words=16, max_depth=8, queue_capacity=64,\n"
        "               storage_slots=4, journal_slots=8, event_slots=8,\n"
        "               log_queue_capacity=8)\n"
        "st = state.make_entry_state(cfg, [assemble(STORAGE_WORKLOAD)] * 2,\n"
        "                            device='cpu')\n"
        "_, d = packed.drain_witness_queues_packed(\n"
        "    fused_cycle.run_cycles(st, cfg, 8), cfg, compact_frac=0.5)\n"
        "rows = packed.fetch_compacted_rows(d)['log']\n"
        "logs = packed.split_compacted_by_lane(rows[0], rows[1], int(rows[2]))\n"
        "wave.wave_commitments({'log': logs}, 'cpu')\n"
        "compaction.compact_log_state(st, cfg)\n"
        "from era_zk_evm_tpu_torch import block\n"
        "from era_zk_evm_tpu_torch.testing import block_programs as bp\n"
        "cfg = VmConfig(batch=2, code_words=16, stack_words=256,\n"
        "               stack_abs_words=64, stack_sp_base=960, heap_words=16,\n"
        "               aux_heap_words=16, max_depth=8, queue_capacity=128,\n"
        "               storage_slots=4, journal_slots=8, event_slots=8,\n"
        "               log_queue_capacity=16, precompile_keccak_blocks=2,\n"
        "               precompile_sha_rounds=2, precompile_queue_capacity=176)\n"
        "txs = [block.TxSpec(program=assemble(bp.keccak_mapping_program(2)),\n"
        "                    entry_address=0x8010),\n"
        "       block.TxSpec(program=assemble(bp.sha_rounds_program(2, 2)),\n"
        "                    entry_address=0x02)]\n"
        "r = block.execute_block(cfg, txs, chunk=16, device='cpu')\n"
        "assert r.all_ok and sorted(r.commitments) == [\n"
        "    'log', 'memory', 'precompile']\n"
        "from era_zk_evm_tpu_torch.tools import (\n"
        "    bisect_fold, probe_keccak, probe_uniform)\n"
        "probe_keccak.main(['--cpu', '--batch', '256', '--iters', '1',\n"
        "                   'rows2d_t8', 'roundrate_t8', 'vpu_andnot_t16',\n"
        "                   'bitslice_g1'])\n"
        "probe_uniform.main(['--cpu', '--w', '48', '--tb', '8',\n"
        "                    '--reps', '2'])\n"
        "bisect_fold.main(['--cpu', '--batch', '8'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'era_zk_evm_tpu' or m.startswith('era_zk_evm_tpu.')]\n"
        "assert not bad, f'the port imported {bad}'\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)



def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [ROOT / "chip_smoke.py", *(ROOT / "era_zk_evm_tpu_torch").rglob("*.py")]))
def test_port_source_imports_no_jax_package(path):
    # absolute imports only: the port's own relative imports stay inside it
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in ("jax", "jaxlib", "era_zk_evm_tpu")]
    assert not bad, f"{path} imports {bad}"
