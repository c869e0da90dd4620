"""The traced run's readings: a device trace of a steady stretch of the
window, read from `torch.profiler`'s Chrome trace, and the harness's own
spans.

`Stretch` profiles a few chunks of calls (the host's spans named by
`record_function`, the device's kernels, fills and copies) and reduces the
trace to what the per-layer readers (metrics/<name>.py) take: the device
time and count of each device item by name, the device's busy time (the
union of its items' intervals) and the stretch's wall, the longest idle gaps
named by the harness span the host was in when the device went idle, and
the port's launch counters over the stretch.  A stretch whose kernel events
do not match the launch counters is refused (a profile that misses launches
is no measurement); `measure` tries three stretches, then raises.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

#: the Chrome trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
#: the port's launch counters (models/fused_cycle.py) and the kernel name
#: each counts
COUNTERS = {"K1_LAUNCHES": "k1_kernel", "K2_LAUNCHES": "k2_kernel",
            "PQ_SPLICE_LAUNCHES": "pq_move_kernel"}
SPAN_PREFIX = "eravm_bench."


def counters(fused_cycle) -> dict:
    return {name: getattr(fused_cycle, name) for name in COUNTERS}


def _union_s(intervals: list) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def reduce_trace(events: list, wall_s: float, n_calls: int,
                 launches: dict) -> dict:
    """The readings of one stretch's Chrome trace events (`traceEvents`):
    device items by name, busy and window seconds, idle gaps named by the
    host span, the launches."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(SPAN_PREFIX))
    ops: dict[str, list] = {}
    for e in dev:
        o = ops.setdefault(e["name"], [0.0, 0])
        o[0] += e["dur"] / 1e6
        o[1] += 1
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps = []
    end = None
    for a, b in iv:
        if end is not None and a > end:
            where = next((n for s0, s1, n in spans if s0 <= end < s1),
                         "harness")
            gaps.append((where, (a - end) / 1e6))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": ops, "busy_s": _union_s(iv), "window_s": wall_s,
            "calls": n_calls, "launches": launches, "idle_gaps": gaps}


def kernel_count(reading: dict, key: str) -> int:
    return sum(c for name, (_, c) in reading["device_ops"].items()
               if key in name)


def device_s(reading: dict, key: str) -> float:
    """Device seconds of the items whose name holds `key`."""
    return sum(s for name, (s, _) in reading["device_ops"].items()
               if key in name)


def measure(run_chunk, fused_cycle, calls_per_chunk: int, chunks: int,
            tries: int = 3) -> dict:
    """Profile `chunks` calls of `run_chunk()` (each ends in a
    synchronisation) and reduce them; a stretch whose kernel events do not
    match the launch counters is tried again, at most `tries` times."""
    import torch

    problems = []
    for _ in range(tries):
        torch.cuda.synchronize()
        c0 = counters(fused_cycle)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(chunks):
                run_chunk()
            wall = time.perf_counter() - t0
        launches = {k: v - c0[k] for k, v in counters(fused_cycle).items()}
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        reading = reduce_trace(events, wall, calls_per_chunk * chunks,
                               launches)
        bad = {name: (kernel_count(reading, key), launches[name])
               for name, key in COUNTERS.items()
               if kernel_count(reading, key) != launches[name]}
        if not bad and reading["busy_s"] > 0:
            return reading
        problems.append(bad or "no device time")
    raise RuntimeError(f"the profiler missed launches in {tries} stretches "
                       f"(kernel events, launches): {problems}")
