"""K1's cycle time on the card, ablated: where does it go?

The counterpart of `tools/ablate_fused.py`: times `fused_cycle.run_cycles`
(K1 on the card) under varied geometries, opcode mixes and K1's development
hooks (`models/fused_cycle.py`: DEBUG_SKIP, DEBUG_STAGE, DEBUG_PASSTHROUGH;
`csrc/cycle_kernel.cu` says what each does) to attribute the cycle's cost
(arena reads and stores, the 256-bit units, sections of the cycle).  A
hooked launch computes wrong results by design: its line is a time only.

    python -m era_zk_evm_tpu_torch.tools.ablate_fused [group ...]

Groups: mix geom skip stage rt rtw cache tile (default: mix geom).  Each
line: K1's device time a 128-cycle call (CUDA events, the best of 3 after a
warm call; the state runs on from call to call, as the JAX tool's does),
cycles/s, the lanes with `lane_error`, and where the JAX tool prints its
compile time the build's seconds (a group's hooked libraries are built
together, one nvcc a source, before its first line) and the launched
instance's ptxas line: registers, stack frame, spilled bytes (stores /
loads).  The card's name and power limit come first; the last line is
every row as JSON.  `stage` cuts at every stage of `K1_STAGES`, in the
cycle's order (the JAX group cuts at 1, 13 and 2-10 of the same numbers),
after the uncut baseline.

Left out, with no counterpart on the card: `tile=128` / `tile=512` (in
`tile`, `rt`, `rtw` and `cache`), the TPU's lanes a grid step: K1's block
size is its own (`k1_block_threads`, from the SM count), so those lines
run at it; and the `wc` group and the `_WORD_CACHE` toggle of `rt` /
`rtw`: the word cache serves the TPU kernel's one-hot arena sweeps
(`fused_cycle.py:412-417`), and K1 loads by index, so it has no sweep to
cache.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .. import _build
from ..config import VmConfig
from ..models import fused_cycle
from ..models.state import make_entry_state
from ..testing.programs import WORKLOAD, assemble
from .k1_times import card, elapsed_ms, ptxas

N_CYCLES = 128

# the bench.py headline workload (mixed: alu, mul, stack push/pop, heap)
PROG_BENCH = WORKLOAD

PROG_ALU = """
    add 1, r0, r10
    add code[@n], r0, r1
    loop:
    add r1, r1, r2
    xor r2, r1, r3
    and r3, r2, r4
    or r4, r2, r5
    add r5, r2, r6
    sub r6, r2, r7
    add r7, r2, r8
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

#: each library's build seconds, by its hook flags (() the default build)
BUILD_S: dict = {}


def hook_flags(skip=frozenset(), stage=None) -> tuple:
    """The -D flags of K1's build for these hooks (`k1_hook_flags`)."""
    with fused_cycle.k1_hooks(skip, stage):
        return tuple(fused_cycle.k1_hook_flags())


def prebuild(variants) -> None:
    """Build the hooked libraries of `variants` ((skip, stage) pairs) that
    are not built yet, all together, and the default one."""
    if () not in BUILD_S:
        t0 = time.time()
        _build.build()
        BUILD_S[()] = time.time() - t0
    todo = sorted({hook_flags(*v) for v in variants} - set(BUILD_S) - {()})
    if todo:
        t0 = time.time()
        _build.build_hooked([list(f) for f in todo])
        for flags in todo:
            BUILD_S[flags] = time.time() - t0


def ptxas_line(config: VmConfig, flags: tuple) -> dict:
    """The ptxas figures of the K1 instance that `config` launches, from its
    library's build log."""
    lib = (_build.build_hooked([list(flags)])[0] if flags
           else _build.build())
    inst = "k1_kernelILb{:d}ELb{:d}ELb{:d}E".format(
        config.storage_slots > 0, fused_cycle.precompile_instance(config),
        fused_cycle.ecrecover_instance(config))
    found = [v for k, v in ptxas((lib.parent / "build.log").read_text())
             .items() if inst in k]
    return found[0] if found else {}


def time_run(config: VmConfig, program: str, run, reps: int = 3) -> tuple:
    """The best of `reps` CUDA-event times (ms) of `run(state)` after a warm
    call, on one entry state of `program` in every lane that runs on from
    call to call, and the lanes with `lane_error` after them."""
    words = assemble(program)
    state = make_entry_state(config, [words] * config.batch,
                             ergs=(1 << 31) - 1, device="cuda")
    run(state)
    times = [elapsed_ms(lambda: run(state)) for _ in range(reps)]
    errors = int(state.lane_error.sum())
    del state
    torch.cuda.empty_cache()
    return min(times), times, errors


def ptxas_text(p: dict) -> str:
    return ("{registers} regs, {frame} B frame, {spill_stores}/{spill_loads}"
            " B spilled".format(**p) if p else "ptxas: not in the log")


def timed(config: VmConfig, program: str, label: str, k_inner: int = 128,
          skip=frozenset(), stage=None, rows: list | None = None) -> dict:
    """One line: `run_cycles(state, config, 128, k_inner)` with K1 built
    with these hooks (the hooks reset after it)."""
    flags = hook_flags(skip, stage)
    prebuild([(skip, stage)])
    with fused_cycle.k1_hooks(skip, stage):
        best, times, errors = time_run(
            config, program,
            lambda st: fused_cycle.run_cycles(st, config, N_CYCLES,
                                              k_inner=k_inner))
    p = ptxas_line(config, flags)
    rate = config.batch * N_CYCLES / (best / 1e3)
    print(f"{label:40s} B={config.batch:6d} K={k_inner:3d} {best:8.4f} "
          f"ms/call {rate / 1e6:9.2f}M cyc/s err={errors} "
          f"(build {BUILD_S[flags]:.1f}s; {ptxas_text(p)})", flush=True)
    row = {"label": label, "batch": config.batch, "k_inner": k_inner,
           "skip": sorted(skip), "stage": stage, "ms": best, "ms_all": times,
           "cycles_per_sec": rate, "lane_errors": errors,
           "build_s": BUILD_S[flags], "ptxas": p}
    if rows is not None:
        rows.append(row)
    return row


def cfg(batch=32768, stack_words=256, heap_words=64, witness=True,
        max_depth=8, **kw):
    q = N_CYCLES * 8 * 5 if witness else 0
    sp_base = 960 if stack_words >= 256 else 1024 - stack_words + 64 + 32
    return VmConfig(batch=batch, code_words=16, stack_words=stack_words,
                    sweep_gating=False,
                    stack_abs_words=64, stack_sp_base=sp_base,
                    heap_words=heap_words, aux_heap_words=16,
                    max_depth=max_depth, queue_capacity=q, **kw)


#: each group's lines: (config keywords, program, label, timed keywords)
GROUPS = {
    "mix": [
        ({}, PROG_BENCH, "bench mix (headline geometry)", {}),
        ({"witness": False}, PROG_BENCH, "bench mix, no witness", {}),
        ({"witness": False}, PROG_ALU, "alu-only", {}),
        ({"witness": False}, PROG_STACK, "stack 4/10", {}),
        ({"witness": False}, PROG_HEAP, "heap 4/10", {}),
    ],
    "geom": [
        ({"stack_words": 128}, PROG_BENCH, "bench mix, SW=128", {}),
        ({"heap_words": 16}, PROG_BENCH, "bench mix, HW=16", {}),
        ({"stack_words": 128, "heap_words": 16}, PROG_BENCH,
         "bench mix, SW=128 HW=16", {}),
        ({"max_depth": 4}, PROG_BENCH, "bench mix, D=4", {}),
    ],
    "skip": [({}, PROG_BENCH, f"bench mix, skip {name}", {"skip": {name}})
             for name in ("mul", "div", "shift", "uma_shift")] + [
        ({}, PROG_BENCH, "bench mix, skip all 4",
         {"skip": {"mul", "div", "shift", "uma_shift"}})],
    # a cumulative profile of the cycle via the DEBUG_STAGE early return
    "stage": [({}, PROG_BENCH, "bench mix, no cut (baseline)", {})] + [
        ({}, PROG_BENCH, f"bench mix, cut at stage {st} ({name})",
         {"stage": st}) for st, name in fused_cycle.K1_STAGES.items()],
    # does a run-time false branch cost what removed code does?
    "rt": [
        ({}, PROG_STACK, "stack mix, baseline", {}),
        ({}, PROG_STACK, "stack mix, read rt-false",
         {"skip": {"stack_rw_rt"}}),
        ({}, PROG_STACK, "stack mix, compile-false", {"skip": {"stack_rw"}}),
    ],
    "rtw": [
        ({}, PROG_STACK, "stack mix, baseline", {}),
        ({}, PROG_STACK, "stack mix, store rt-false",
         {"skip": {"stack_st_rt"}}),
        ({}, PROG_STACK, "stack mix, store removed",
         {"skip": {"stack_st_off"}}),
    ],
    # upper bound for a perfect top-of-stack / hot-heap-word cache: the
    # arena reads and stores forced off (WRONG results, perf only)
    "cache": [
        ({}, PROG_BENCH, "baseline", {}),
        ({}, PROG_BENCH, "skip stack_rw", {"skip": {"stack_rw"}}),
        ({}, PROG_BENCH, "skip heap_rw", {"skip": {"heap_rw"}}),
        ({}, PROG_BENCH, "skip both", {"skip": {"stack_rw", "heap_rw"}}),
    ],
    "tile": [
        ({}, PROG_BENCH, "bench mix, K=64", {"k_inner": 64}),
        ({"batch": 65536}, PROG_BENCH, "bench mix, B=64k", {}),
    ],
}


def main(argv=None) -> list:
    groups = (sys.argv[1:] if argv is None else list(argv)) or ["mix", "geom"]
    if set(groups) - set(GROUPS):
        raise SystemExit(f"ablate_fused: groups are {list(GROUPS)}")
    if not torch.cuda.is_available():
        raise SystemExit("ablate_fused: no CUDA card")
    print(f"card: {card()}; device {torch.cuda.get_device_name(0)}",
          flush=True)
    rows = []
    for group in groups:
        lines = GROUPS[group]
        prebuild([(kw.get("skip", frozenset()), kw.get("stage"))
                  for *_, kw in lines])
        for cfg_kw, program, label, kw in lines:
            timed(cfg(**cfg_kw), program, label, rows=rows, **kw)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
