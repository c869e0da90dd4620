"""What the benchmark imports: no module whose top-level name (the part
before the first dot, compared whole) is `jax`, `jaxlib`, `flax` or the JAX
package `era_zk_evm_tpu`, in its sources or in a process that has run the
harness; and nothing of the program in the plain reference."""

import ast
import json
import pathlib
import subprocess
import sys

from eravm_bench import cells
from eravm_bench.run import FORBIDDEN

PKG = cells.PKG
PROGRAM = "era_zk_evm_tpu_torch"


def imported_tops(path: pathlib.Path) -> set[str]:
    """Top-level names of the absolute imports in a source file; relative
    imports as '.'."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add("." if node.level else node.module.split(".")[0])
    return tops


def sources(where: pathlib.Path) -> list[pathlib.Path]:
    return sorted(p for p in where.rglob("*.py") if "_build" not in p.parts)


def test_no_jax_in_sources():
    bad = {str(p.relative_to(PKG)): sorted(imported_tops(p) & set(FORBIDDEN))
           for p in sources(PKG)}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    ref = PKG / "reference"
    allowed = {".", "__future__", "ctypes", "functools", "hashlib",
               "pathlib", "platform", "shutil", "subprocess", "tempfile",
               "numpy"}
    for p in sources(ref):
        assert imported_tops(p) <= allowed, (p.name, imported_tops(p))
        assert PROGRAM not in imported_tops(p)


def test_no_jax_in_a_process_that_ran_the_harness():
    """A CPU dry run of the harness's whole control flow in a fresh
    process, then its sys.modules."""
    name = json.loads((cells.ROOT / "BENCHMARK.json").read_text()
                      )["workloads"][0]["name"]
    code = f"""
import sys, time
from eravm_bench import cells, harness
from eravm_bench.run import forbidden_modules
cell = cells.load_cell({name!r})
res = harness.run(cell, 3, None, True, time.perf_counter(), device="cpu",
                  batch=4, window_chunks=1, warm_chunks=0, calls_per_sync=1,
                  judged=2)
assert res.correct, res.checks
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
