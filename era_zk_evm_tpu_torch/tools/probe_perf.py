"""Perf probe on the card: where does the cycle-step time go?

The counterpart of `tools/probe_perf.py`: times `run_cycles` under varied
programs and configs to attribute cost: batch scaling, arena sizes, opcode
mix, witness mode, call depth.  The JAX tool times its plain-ops engine
(`batched_vm.run_cycles`); on the card the port's engine is K1, so this
times `fused_cycle.run_cycles` by default, and `--engine plain` the port's
plain torch engine (`batched_vm.run_cycles`, no yardstick: it repeats K1's
arithmetic in many small torch ops).

    python -m era_zk_evm_tpu_torch.tools.probe_perf [mix|arena|batch|depth|all]
        [--engine k1|plain]

Each line: ms a cycle step (the best of 3 CUDA-event times of a 128-cycle
call after a warm call, over 128), cycles/s, the lanes with `lane_error`,
and for K1 the build's seconds and the launched instance's ptxas line
(`ablate_fused.timed`'s figures).  The card's name and power limit come
first; the last line is every row as JSON.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import VmConfig
from ..models import batched_vm, fused_cycle
from .ablate_fused import (
    BUILD_S, prebuild, ptxas_line, ptxas_text, time_run,
)
from .k1_times import card

N_CYCLES = 128

PROG_ALU = """
    add 1, r0, r10
    add code[@n], r0, r1
    loop:
    add r1, r1, r2
    xor r2, r1, r3
    shl r3, r10, r4
    and r4, r3, r5
    or r5, r2, r6
    add r6, r2, r7
    sub r7, r2, r8
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    n: .word 32768
"""

PROG_STACK = """
    add 1, r0, r10
    add code[@n], r0, r1
    loop:
    add r1, r1, r2
    xor r2, r1, r3
    add r3, r0, stack+=[1]
    add stack-=[1], r0, r4
    add r4, r0, stack[0]
    add stack[0], r0, r5
    add r5, r2, r6
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    n: .word 32768
"""

PROG_HEAP = """
    add 1, r0, r10
    add code[@n], r0, r1
    loop:
    add r1, r1, r2
    xor r2, r1, r3
    st.h 0, r3
    ld.h 32, r4
    st.h 64, r4
    ld.h 0, r5
    add r5, r2, r6
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    n: .word 32768
"""


def timed(config: VmConfig, program: str, label: str, engine: str = "k1",
          rows: list | None = None) -> dict:
    """One line: a 128-cycle `run_cycles` call of `engine`."""
    run = (fused_cycle.run_cycles if engine == "k1"
           else batched_vm.run_cycles)
    if engine == "k1":
        prebuild([])
    best, times, errors = time_run(config, program,
                                   lambda st: run(st, config, N_CYCLES))
    rate = config.batch * N_CYCLES / (best / 1e3)
    ms_per_step = best / N_CYCLES
    p = ptxas_line(config, ()) if engine == "k1" else {}
    tail = (f" (build {BUILD_S[()]:.1f}s; {ptxas_text(p)})"
            if engine == "k1" else "")
    print(f"{label:44s} B={config.batch:6d} {ms_per_step:8.5f} ms/step "
          f"{rate / 1e6:9.2f}M cyc/s err={errors}{tail}", flush=True)
    row = {"label": label, "engine": engine, "batch": config.batch,
           "stack_words": config.stack_words,
           "heap_words": config.heap_words, "max_depth": config.max_depth,
           "queue_capacity": config.queue_capacity, "ms_call": best,
           "ms_call_all": times, "ms_per_step": ms_per_step,
           "cycles_per_sec": rate, "lane_errors": errors, "ptxas": p}
    if rows is not None:
        rows.append(row)
    return row


def cfg(batch=32768, stack_words=256, heap_words=64, witness=False,
        max_depth=8, **kw):
    q = N_CYCLES * 8 * 5 if witness else 0
    # keep INITIAL_SP (1024) inside the sliding sp window for any SW
    # (960 kept for SW>=256 so default shapes stay compile-cache-warm)
    sp_base = 960 if stack_words >= 256 else 1024 - stack_words + 64 + 32
    return VmConfig(batch=batch, code_words=16, stack_words=stack_words,
                    sweep_gating=False,
                    stack_abs_words=64, stack_sp_base=sp_base,
                    heap_words=heap_words, aux_heap_words=16,
                    max_depth=max_depth, queue_capacity=q, **kw)


#: each group's lines: (config keywords, program, label)
GROUPS = {
    "mix": [
        ({}, PROG_ALU, "alu-only"),
        ({}, PROG_STACK, "stack 4/10"),
        ({}, PROG_HEAP, "heap 4/10"),
        ({"witness": True}, PROG_ALU, "alu-only +witness"),
        ({"witness": True}, PROG_HEAP, "heap 4/10 +witness"),
    ],
    "arena": [
        ({"stack_words": 128}, PROG_STACK, "stack 4/10, SW=128"),
        ({"stack_words": 512}, PROG_STACK, "stack 4/10, SW=512"),
        ({"stack_words": 1024}, PROG_STACK, "stack 4/10, SW=1024"),
        ({"heap_words": 256}, PROG_HEAP, "heap 4/10, HW=256"),
        ({"heap_words": 1024}, PROG_HEAP, "heap 4/10, HW=1024"),
    ],
    "batch": [
        ({"batch": 4096}, PROG_ALU, "alu-only"),
        ({"batch": 8192}, PROG_ALU, "alu-only"),
        ({"batch": 16384}, PROG_ALU, "alu-only"),
        ({"batch": 65536}, PROG_ALU, "alu-only"),
        ({"batch": 65536}, PROG_HEAP, "heap 4/10"),
        ({"batch": 131072}, PROG_ALU, "alu-only"),
    ],
    "depth": [
        ({"max_depth": 4}, PROG_ALU, "alu-only, D=4"),
        ({"max_depth": 16}, PROG_ALU, "alu-only, D=16"),
        ({"max_depth": 32}, PROG_ALU, "alu-only, D=32"),
    ],
}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("group", nargs="?", default="all",
                    choices=["all", *GROUPS])
    ap.add_argument("--engine", default="k1", choices=["k1", "plain"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_perf: no CUDA card")
    print(f"card: {card()}; device {torch.cuda.get_device_name(0)}; "
          f"engine {args.engine}", flush=True)
    rows = []
    for group, lines in GROUPS.items():
        if args.group in ("all", group):
            for cfg_kw, program, label in lines:
                timed(cfg(**cfg_kw), program, label, args.engine, rows)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
