"""records_differing: over the judged lanes, the lanes whose captured
memory-queue records of the judged call (the window's last call, read
before its rewind) are not the reference's records of the same cycles, in
order.  Exact: the limit is 0."""

import numpy as np

from eravm_bench.reference import expected

LIMIT = 0
ROWS = (("meta", "wq_meta", 4), ("value", "wq_value", 8),
        ("flags", "wq_flags", None))


def setup(run):
    import torch

    Q, J = run.config.queue_capacity, len(run.lanes)
    run.store["records_differing"] = {
        key: torch.empty((Q, n, J) if n else (Q, J), dtype=torch.int32,
                         device=run.idx.device) for key, _, n in ROWS}


def on_judged_call(run, state):
    import torch

    snap = run.store["records_differing"]
    for key, name, _ in ROWS:
        torch.index_select(getattr(state, name), -1, run.idx, out=snap[key])


def collect(run, state):
    import torch

    snap = run.store.pop("records_differing")
    rows = {k: torch.movedim(v.cpu(), -1, 0).contiguous().numpy()
            .view(np.uint32) for k, v in snap.items()}
    return [expected.records_from_rows(rows["meta"][j], rows["value"][j],
                                       rows["flags"][j])
            for j in range(len(run.lanes))]


def control(run, outs):
    return [expected.oracle_records(o["witness"]) for o in outs]


def compare(run, got, outs):
    bad, notes = 0, []
    for lane, have, out in zip(run.lanes, got, outs):
        want = expected.oracle_records(out["witness"])
        if have.shape != want.shape or not np.array_equal(have, want):
            bad += 1
            if len(notes) < 8:
                notes.append(f"lane {lane}: {len(have)} records of the "
                             f"judged call, the reference {len(want)}, "
                             f"not equal")
    return bad, notes
