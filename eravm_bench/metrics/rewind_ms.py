"""rewind_ms: the queue rewind's device time a call
(`models/spill.rewind_queues`: one fill a queue tensor), over the traced
stretch; nothing in a cell that never rewinds."""

from eravm_bench.profile import device_s


def read(trace):
    reading = trace["reading"]
    s = device_s(reading, "FillFunctor") + sum(
        t for name, (t, _) in reading["device_ops"].items()
        if name.lower().startswith("memset"))
    return 1e3 * s / reading["calls"] if s > 0 else None
