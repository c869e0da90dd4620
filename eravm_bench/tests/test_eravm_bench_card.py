"""On the card, at each cell's own size (B = 32768, a short window): the
control, the reference's witness without its code reads put in the
program's place, comes out not correct on three seeds, and a sound run of
the same seeds comes out correct.  Run on the GPU machine with
`python -m pytest -m cuda eravm_bench/tests/test_eravm_bench_card.py`."""

import json
import time

import pytest

from eravm_bench import cells, harness

CELLS = [w["name"] for w in json.loads(
    (cells.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 3 * 10**9 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_sound_run_passes_at_full_size(card, cell, seed):
    c = cells.load_cell(cell)
    ctrl = harness.run(c, seed, 2.0, False, time.perf_counter(),
                       control=True)
    print(f"{cell} seed {seed} control {ctrl.checks}")
    assert not ctrl.correct
    sound = harness.run(c, seed, 2.0, False, time.perf_counter())
    print(f"{cell} seed {seed} sound {sound.checks}")
    assert sound.correct
