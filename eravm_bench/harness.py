"""One run of one cell: set-up, the measured window, the traced stretch and
the judgement, as `run.py` drives them.

The window drives the port's entry point,
`era_zk_evm_tpu_torch.models.fused_cycle.run_cycles(state, config, 128,
k_inner=128)`, on the whole batch; in the capture cells each call is
followed by `models.spill.rewind_queues`.  Calls are dispatched ahead, with
one synchronisation every `calls_per_sync` calls to read the clock (the
steady-state chunk pattern of the block pipeline).  The window's cycles are
the sum over lanes of the cycle counter after it less before it, so a lane
that ends or errs stops counting; `cycles_per_s` is that sum over the
window's wall time.

The port is imported inside `run`, never at import time, and only the
modules named here: the state builder, the dispatcher, the queue rewind,
the kernels' build, and the launch counters.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import types

import numpy as np

from . import cells, judge, profile
from .reference import oracle

#: chunks of calls run to warm up every shape the window uses
WARM_CHUNKS = 4
#: the traced stretch: chunks of the window before it, and its length
TRACE_FROM, TRACE_CHUNKS = 2, 8
#: lanes the reference judges
JUDGED = 32


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    limits: dict
    notes: list
    breakdown: dict | None = None
    window: str = ""


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", batch: int | None = None,
        window_chunks: int | None = None, warm_chunks: int = WARM_CHUNKS,
        calls_per_sync: int | None = None, judged: int = JUDGED,
        control: bool = False) -> Result:
    """Run `cell` once.  On the card the window lasts `seconds`; the CPU
    path (tests) runs `window_chunks` chunks at a small `batch` on the
    port's plain engine.  `control` judges the reference's control (its
    witness without code reads) in the program's place."""
    import torch

    from era_zk_evm_tpu_torch.config import VmConfig
    from era_zk_evm_tpu_torch.models import fused_cycle, spill
    from era_zk_evm_tpu_torch.models import state as pstate

    seed = int(seed) % 2**64
    on_card = device != "cpu"
    marks = [("start", time.perf_counter() - t_start)]
    # the reference's g++ build runs beside the kernels' nvcc build
    built = {}

    def build_oracle():
        try:
            oracle.build()
        except Exception as exc:          # raised on the main thread below
            built["error"] = exc

    builder = threading.Thread(target=build_oracle)
    builder.start()
    if on_card:
        from era_zk_evm_tpu_torch import _build

        _build.load()
        torch.cuda.reset_peak_memory_stats()
    builder.join()
    if "error" in built:
        raise built["error"]
    marks.append(("kernels and oracle built or loaded",
                  time.perf_counter() - t_start))

    vm = cell.vm
    B = batch or vm["batch"]
    cfg = VmConfig(**{**vm, "batch": B})
    call = cell.traffic["call"]
    cycles, k_inner = call["cycles"], call["k_inner"]
    per_sync = calls_per_sync or call["calls_per_sync"]
    programs = cells.lane_programs(cell.traffic, B, seed)
    lanes = cells.judged_lanes(B, seed, judged)
    marks.append(("inputs made", time.perf_counter() - t_start))
    state = pstate.make_entry_state(cfg, programs, ergs=cell.traffic["ergs"],
                                    device=device)
    marks.append(("entry state built", time.perf_counter() - t_start))
    idx = torch.as_tensor(lanes, dtype=torch.int64, device=device)
    ctx = types.SimpleNamespace(cell=cell, config=cfg, programs=programs,
                                lanes=lanes, idx=idx, clock=0, store={})
    parts = judge.parts(cell)
    for part in parts:
        if hasattr(part, "setup"):
            part.setup(ctx)
    calls_run = 0
    spans: list[float] = []

    def one_call(judged_call: bool):
        fused_cycle.run_cycles(state, cfg, cycles, k_inner=k_inner)
        if judged_call:
            for part in parts:
                if hasattr(part, "on_judged_call"):
                    part.on_judged_call(ctx, state)
        if cell.capture:
            spill.rewind_queues(state)

    def sync():
        if on_card:
            with torch.profiler.record_function(profile.SPAN_PREFIX + "sync"):
                torch.cuda.synchronize()

    def chunk(timed: bool):
        nonlocal calls_run
        for i in range(per_sync):
            t0 = time.perf_counter()
            with torch.profiler.record_function(profile.SPAN_PREFIX + "call"):
                one_call(judged_call=i == per_sync - 1)
            if timed:
                spans.append(time.perf_counter() - t0)
        calls_run += per_sync
        sync()

    def lane_cycles() -> int:
        return int((state.monotonic_cycle_counter.to(torch.int64)
                    & 0xFFFFFFFF).sum())

    for _ in range(warm_chunks):
        chunk(timed=False)
    sync()
    cycles0 = lane_cycles()
    calls0 = calls_run
    setup_s = time.perf_counter() - t_start
    marks.append(("warmed up", setup_s))

    # -- the window ----------------------------------------------------
    reading = None
    t0 = time.perf_counter()
    n_chunks = 0
    ends = []
    while True:
        if trace and on_card and n_chunks == TRACE_FROM and reading is None:
            reading = profile.measure(lambda: chunk(timed=True), fused_cycle,
                                      per_sync, TRACE_CHUNKS)
            n_chunks += TRACE_CHUNKS
        chunk(timed=True)
        n_chunks += 1
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if (window_chunks is not None and n_chunks >= window_chunks) or \
                (window_chunks is None and elapsed >= seconds
                 and (reading is not None or not (trace and on_card))):
            break
    window_s = time.perf_counter() - t0
    window_calls = calls_run - calls0
    cycles1 = lane_cycles()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # -- what the window produced -----------------------------------------
    stopped = state.done | state.lane_error
    bad_lanes = int(stopped.sum())
    total_cycles = calls_run * cycles
    ctx.clock = cycles if cell.capture else total_cycles
    got = {part.NAME: part.collect(ctx, state) for part in parts}
    extra = _trace_counts(cell, cfg, state, fused_cycle, pstate, reading,
                          spans, cycles, k_inner) if trace else None
    del state
    ctx.store.clear()
    if on_card:
        torch.cuda.empty_cache()

    # -- the judgement (after the window, the state freed) ------------------
    t_judge = time.perf_counter()
    outs = judge.reference_lanes(cell, programs, lanes, total_cycles, cycles)
    if control:
        ctrl = judge.reference_lanes(cell, programs, lanes, total_cycles,
                                     cycles, drop_type=4)
        got = {part.NAME: part.control(ctx, ctrl) for part in parts}
    checks, limits, notes = {}, {}, []
    for part in parts:
        checks[part.NAME], found = part.compare(ctx, got[part.NAME], outs)
        limits[part.NAME] = part.LIMIT
        notes += found
    correct = all(checks[k] <= limits[k] for k in checks)
    judge_s = time.perf_counter() - t_judge

    metrics = {"setup_s": {"value": setup_s, "unit": "s"},
               "cycles_per_s": {"value": (cycles1 - cycles0) / window_s,
                                "unit": "cycles/s"}}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        metrics = extra["metrics"]
        if on_card:
            dev["busy_s"] = extra["busy_s"]
            dev["window_s"] = extra["window_s"]
            breakdown = extra["breakdown"]
    return Result(correct=correct, attempted=B * window_calls,
                  failed=bad_lanes * window_calls, metrics=metrics,
                  device=dev, checks=checks, limits=limits, notes=notes,
                  breakdown=breakdown,
                  window=_window_note(ends, B * per_sync * cycles,
                                      window_calls, total_cycles)
                  + "; set-up s: " + ", ".join(f"{m} {t:.3f}"
                                               for m, t in marks)
                  + f"; judged {len(lanes)} lanes in {judge_s:.3f} s")


def _window_note(ends: list, chunk_cycles: int, calls: int,
                 total_cycles: int) -> str:
    """How steady the window ran: its chunks' walls and the rate of its
    first and last quarter of chunks (a diagnostic on standard error)."""
    walls = np.diff([0.0] + ends)
    q = max(1, len(walls) // 4)
    rate = lambda w: chunk_cycles * len(w) / w.sum()      # noqa: E731
    return (f"window: {calls} calls in {len(walls)} chunks, chunk ms "
            f"min {1e3 * walls.min():.3f} median "
            f"{1e3 * np.median(walls):.3f} max {1e3 * walls.max():.3f}; "
            f"cycles/s first quarter {rate(walls[:q]):.6g}, last quarter "
            f"{rate(walls[-q:]):.6g}; lanes ran {total_cycles} cycles")


def _trace_counts(cell, cfg, state, fused_cycle, pstate, reading, spans,
                  cycles, k_inner) -> dict:
    """The per-layer metrics: the traced stretch's readings, one more call
    (after the window) whose work each metric's own `count` hook counts on
    the state around it, and each metric's reader (metrics/<name>.py)."""
    from . import metrics as readers

    on_card = reading is not None
    modules = {m["name"]: readers.load(m["name"]) for m in cell.per_layer}
    hooked = [n for n, mod in modules.items() if hasattr(mod, "count")]
    counts = {}
    if hooked:
        view = pstate.reference_view(state)
        before = {n: getattr(view, n).clone() for n in pstate.FIELD_NAMES}
        live = int((~(state.done | state.lane_error)).sum())
        fused_cycle.run_cycles(state, cfg, cycles, k_inner=k_inner)
        view = pstate.reference_view(state)
        call = {"cell": cell, "config": cfg, "cycles": cycles, "live": live,
                "before": before,
                "after": {n: getattr(view, n) for n in pstate.FIELD_NAMES}}
        counts = {n: modules[n].count(call) for n in hooked}
        del before, call
    common = {"dispatch_s": spans, "reading": reading, "cycles": cycles}
    values = {}
    for m in cell.per_layer:
        v = modules[m["name"]].read({**common,
                                     "count": counts.get(m["name"])}) \
            if on_card else None
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"metrics": values}
    if on_card:
        out["busy_s"] = reading["busy_s"]
        out["window_s"] = reading["window_s"]
        top = sorted(reading["device_ops"].items(), key=lambda kv: -kv[1][0])
        out["breakdown"] = {
            "device_ops": [[name[:120], s] for name, (s, _) in top[:10]],
            "idle_gaps": [[name, s] for name, s in reading["idle_gaps"][:10]]}
    return out
