"""The comparison that decides `correct`: the judged lanes of the timed
path's output against the plain reference (reference/).

The numbers compared are the cell's `judge` list, one file each under
`checks/` (the configuration's and the mix's names); each has its limit.
Here is what they share: the reference's run of each judged lane.
"""

from __future__ import annotations

import concurrent.futures
import os

from . import checks
from .reference import expected as ref_expected
from .reference import oracle

#: the reference's stack page, in words (the oracle's whole page from 0)
STACK_WORDS = 2048


def parts(cell) -> list:
    """The cell's numbers compared, as loaded `checks/<name>.py` modules."""
    return [checks.load(name) for name in cell.judge]


def reference_lanes(cell, programs: list, lanes: list, total_cycles: int,
                    call_cycles: int, drop_type: int = -1) -> list[dict]:
    """The oracle's run of each judged lane for `total_cycles` cycles, in
    parallel threads (each ctypes call releases the interpreter lock);
    with `drop_type` the control's witness."""
    vm = cell.vm

    def one(lane):
        return oracle.run(
            programs[lane], ergs=cell.traffic["ergs"], max_cycles=total_cycles,
            stack_words=STACK_WORDS, heap_words=vm["heap_words"],
            aux_words=vm["aux_heap_words"], n_frames=vm["max_depth"],
            witness_from=total_cycles - call_cycles if cell.capture else -1,
            witness_cap=call_cycles * ref_expected.SLOTS_PER_CYCLE,
            sponge=cell.rolling, drop_type=drop_type)

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(one, lanes))
