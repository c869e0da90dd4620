"""k1_ms: K1's device time a launch (`k1_kernel*`, csrc/cycle_kernel.cu and
cycle_kernel_ec.cu) over the traced stretch."""

from eravm_bench.profile import device_s


def read(trace):
    n = trace["reading"]["launches"]["K1_LAUNCHES"]
    return 1e3 * device_s(trace["reading"], "k1_kernel") / n if n else None
