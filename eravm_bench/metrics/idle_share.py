"""idle_share: the share of the traced stretch's wall in which no device
item ran, in %: 1 - busy / wall."""


def read(trace):
    reading = trace["reading"]
    return 100.0 * (1.0 - reading["busy_s"] / reading["window_s"])
