"""Fixtures of the benchmark's tests: `card` skips a test without a CUDA
card (decided when the test runs, never at import), and `cpu_run` runs a
cell through the harness on the CPU at a tiny size, on the port's plain
engine."""

import time

import pytest

#: the tiny size of the CPU runs: lanes, chunks, calls a chunk, lanes judged
TINY = dict(batch=4, window_chunks=1, warm_chunks=1, calls_per_sync=2,
            judged=4)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def cpu_run():
    from eravm_bench import cells, harness

    def run(cell_name: str, seed: int = 2**31 + 77, **kw):
        cell = cells.load_cell(cell_name)
        return harness.run(cell, seed, None, False, time.perf_counter(),
                           device="cpu", **{**TINY, **kw})

    return run
