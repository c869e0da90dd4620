"""The per-layer metrics, one file a metric: `metrics/<name>.py`, found here
by the metric's name in `BENCHMARK.json`.  Each file defines
`read(trace) -> float | None`; a reader that finds nothing to read returns
None, and the metric is left out of the run's line.  A metric that needs a
count of the work of one call defines `count(call) -> dict` too: `call`
holds the state around one more call after the window (`before`, `after`:
field name -> tensor, the reference layout), the cell, the engine's
`config`, the call's `cycles` and the `live` lanes before it; what `count`
returns reaches `read` as `trace["count"]`.

`trace` also holds the traced stretch's `reading` (profile.reduce_trace:
device items by name, busy and window seconds, launches, calls),
`dispatch_s` (the host's seconds around each window call's enqueue) and
`cycles` (a call's).
"""

from __future__ import annotations

import importlib.util
import pathlib

_DIR = pathlib.Path(__file__).resolve().parent


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"eravm_bench.metrics.{name.replace('-', '_').replace('.', '_')}",
        _DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
