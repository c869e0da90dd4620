"""The comparison fails where the timed path is broken underneath: the
harness's whole run on the CPU at a tiny size, with `run_cycles` replaced
by a broken one, must come out `correct` false (a cell on one chip has no
exchange between chips to leave out); and the control, the reference's
witness without its code reads put in the program's place, must too."""

import json

import pytest
import torch

from eravm_bench import cells
from era_zk_evm_tpu_torch.config import BATCH_LAST_FIELDS
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate

CELLS = [w["name"] for w in json.loads(
    (cells.ROOT / "BENCHMARK.json").read_text())["workloads"]]
REAL = fused_cycle.run_cycles


def unchanged(state, config, n_cycles, k_inner=128):
    """A step that returns its state unchanged."""
    return state


def half_batch(state, config, n_cycles, k_inner=128):
    """Half of the batch left out: the upper lanes keep their state."""
    before = pstate.clone_state(state)
    REAL(state, config, n_cycles, k_inner=k_inner)
    half = config.batch // 2
    ref, old = pstate.reference_view(state), pstate.reference_view(before)
    for name in pstate.FIELD_NAMES:
        t, o = getattr(ref, name), getattr(old, name)
        if name in BATCH_LAST_FIELDS:
            t[..., half:] = o[..., half:]
        else:
            t[half:] = o[half:]
    return state


def altered(state, config, n_cycles, k_inner=128):
    """An answer altered where it is produced: one bit of one register."""
    REAL(state, config, n_cycles, k_inner=k_inner)
    state.regs.view(-1)[0] ^= torch.tensor(1, dtype=torch.int32)
    return state


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cpu_run, monkeypatch, cell, fault):
    monkeypatch.setattr(fused_cycle, "run_cycles", fault)
    res = cpu_run(cell)
    assert not res.correct
    assert sum(res.checks.values()) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cpu_run, cell):
    res = cpu_run(cell, control=True)
    assert not res.correct
