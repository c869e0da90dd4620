"""k1_roofline: K1's share of its bound, in %: the frozen
`roofline.bound_ms` of one call's needed bytes and operations over K1's
device time a launch.  `count` takes them from the state around one call:
`roofline.k1_bytes` (in mode (b) with the compacted records K1 writes, one
a new count of the lane's sponge) and `roofline.k1_ops` of the live lanes'
cycles.  The units' work is not counted: the cells that report this metric
run with the precompile units off."""

from eravm_bench import roofline
from eravm_bench.profile import device_s


def count(call):
    import torch

    cell, before, after = call["cell"], call["before"], call["after"]
    records = None
    if cell.rolling:
        records = (after["wc_count"].to(torch.int64)
                   - before["wc_count"].to(torch.int64)) & 0xFFFFFFFF
    return {"bytes": roofline.k1_bytes(
                before, after, cell.capture,
                call["config"].precompile_queue_capacity > 0, records),
            "ops": roofline.k1_ops(call["live"] * call["cycles"])}


def read(trace):
    n = trace["reading"]["launches"]["K1_LAUNCHES"]
    if not n or not trace["count"]:
        return None
    ms = 1e3 * device_s(trace["reading"], "k1_kernel") / n
    bound, _ = roofline.bound_ms(trace["count"]["bytes"],
                                 trace["count"]["ops"])
    return 100.0 * bound / ms
