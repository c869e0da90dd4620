"""dispatch_ms: the host's ms to enqueue one call of the window (the
dispatcher, `models/fused_cycle.run_cycles`, and in the capture cells the
rewind), by the host clock around each call, over every call of the
window."""


def read(trace):
    spans = trace["dispatch_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
