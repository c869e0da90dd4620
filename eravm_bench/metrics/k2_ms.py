"""k2_ms: K2's device time a launch (`k2_kernel`, csrc/rolling_fold.cu)
over the traced stretch; nothing where K2 does not run."""

from eravm_bench.profile import device_s


def read(trace):
    n = trace["reading"]["launches"]["K2_LAUNCHES"]
    return 1e3 * device_s(trace["reading"], "k2_kernel") / n if n else None
