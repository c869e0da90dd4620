"""The numbers that decide `correct`, one file a number: `checks/<name>.py`,
found here by the name a configuration or a traffic mix lists under
`judge`.  Each file defines

- `LIMIT`, the number's limit (a run is correct when every number is at or
  under its limit);
- `collect(run, state)`: the program's outputs this number judges, read
  from the state after the window (on the host);
- `compare(run, got, outs) -> (number, notes)`: `got` against the
  reference's runs of the judged lanes (`judge.reference_lanes`), with a
  few readable differences;
- `control(run, outs)`: the reference's control runs shaped as `collect`
  returns the program's outputs, to be put in their place;

and may define `setup(run)` (before the window: buffers of its own under
`run.store[<name>]`) and `on_judged_call(run, state)` (after the window's
last call, before the queues' rewind).  `run` holds the cell, the engine's
config, the lanes' programs, the judged lanes (`lanes`, and `idx` on the
device), the batch's cycles since the last rewind (`clock`) and `store`.
"""

from __future__ import annotations

import importlib.util
import pathlib

_DIR = pathlib.Path(__file__).resolve().parent


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"eravm_bench.checks.{name.replace('-', '_').replace('.', '_')}",
        _DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.NAME = name
    return module
