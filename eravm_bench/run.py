"""The benchmark of the PyTorch + CUDA port of EraVM (`era_zk_evm_tpu_torch`)
on one NVIDIA H100: witness-traced cycles per second, bit-exact.

    python -m eravm_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process runs one cell of `BENCHMARK.json` once: it loads the port's
kernels (built on the first run in a checkout, into the port's fixed build
directory), makes every input from the seed, builds the entry state, warms
the cell's shapes, runs the window, judges the window's outputs against the
plain reference (reference/), and prints one JSON line last on standard
output: `correct`, `attempted` and `failed` (lane-calls), `metrics` (with
`--trace 0` the end-to-end metrics, with `--trace 1` the per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks`, each number
compared with its limit (also the last lines on standard error).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; so it does, with code 3, if the JAX
package or JAX is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from eravm_bench import cells  # noqa: E402

#: top-level module names that the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "era_zk_evm_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def card() -> str:
    """The card's name, power limit and highest SM clock, as nvidia-smi
    reads them (the peaks of roofline.py assume 700 W and 1980 MHz)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi did not answer)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(cells.ROOT) not in sys.path:
        sys.path.insert(0, str(cells.ROOT))
    cell = cells.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"eravm_bench: needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2

    from eravm_bench import harness

    res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      T_START)
    found = forbidden_modules()
    if found:
        print(f"eravm_bench: the process holds {found}", file=sys.stderr)
        return 3
    for note in res.notes:
        print(f"eravm_bench: {note}", file=sys.stderr)
    print(f"eravm_bench: {res.window}", file=sys.stderr)
    print(f"eravm_bench: card {card()}", file=sys.stderr)
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": res.metrics,
            "device": res.device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = {k: {"value": v, "limit": res.limits[k]}
                      for k, v in res.checks.items()}
    for k, v in res.checks.items():
        print(f"{k} {v} limit {res.limits[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
