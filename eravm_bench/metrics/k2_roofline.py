"""k2_roofline: K2's share of its bound, in %: the frozen
`roofline.k2_bound` of one call's records (the permutations their sponges
need, or their bytes), counted on the sponge counts around one call, over
K2's device time a launch."""

from eravm_bench import roofline
from eravm_bench.profile import device_s


def count(call):
    c0, c1 = call["before"]["wc_count"], call["after"]["wc_count"]
    return roofline.k2_bound(c0, (c1 - c0))


def read(trace):
    n = trace["reading"]["launches"]["K2_LAUNCHES"]
    if not n or not trace["count"]:
        return None
    ms = 1e3 * device_s(trace["reading"], "k2_kernel") / n
    return 100.0 * trace["count"]["bound_ms"] / ms
