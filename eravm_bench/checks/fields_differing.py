"""fields_differing: over the judged lanes, the state fields not equal to the
reference's in every value: every field of the engine's state, `lane_error`
and `done` among them, and in the rolling cells the sponge `wc_state` and
its count `wc_count`.  Of the callstack (`cs_*`, a row a frame) the frames
up to the lane's depth are compared: a frame above it was popped, and
EraVM's callstack no longer holds it (the engine leaves its old contents
in the slot, the reference those it pushed).  Exact: the limit is 0."""

import numpy as np

from eravm_bench.reference import expected

LIMIT = 0


def collect(run, state):
    """The judged lanes of every state field, in the reference layout with
    the lane first (u32 data as uint32)."""
    import torch

    from era_zk_evm_tpu_torch.config import BATCH_LAST_FIELDS
    from era_zk_evm_tpu_torch.models import state as pstate

    ref = pstate.reference_view(state)
    out = {}
    for name in pstate.FIELD_NAMES:
        t = getattr(ref, name)
        axis = t.dim() - 1 if name in BATCH_LAST_FIELDS else 0
        a = t.index_select(axis, run.idx).cpu()
        a = torch.movedim(a, axis, 0).contiguous().numpy()
        out[name] = a if a.dtype == bool else a.view(np.uint32)
    return out


def _expected(run, lane, out):
    return expected.expected_lane(run.cell.vm, run.programs[lane],
                                  run.cell.traffic["ergs"], out, run.clock,
                                  rewound=run.cell.capture)


def control(run, outs):
    exp = [_expected(run, b, o) for b, o in zip(run.lanes, outs)]
    return {k: np.stack([e[k] for e in exp]) for k in exp[0]}


def compare(run, got, outs):
    bad, notes = 0, []
    for j, (lane, out) in enumerate(zip(run.lanes, outs)):
        exp = _expected(run, lane, out)
        live = int(exp["depth"]) + 1
        for name, want in exp.items():
            have = got[name][j] if name in got else None
            if name.startswith("cs_") and have is not None:
                have, want = have[:live], want[:live]
            if have is None or np.shape(have) != np.shape(want) or \
                    not np.array_equal(np.asarray(have).astype(np.uint64),
                                       np.asarray(want).astype(np.uint64)):
                bad += 1
                if len(notes) < 8:
                    notes.append(f"lane {lane}: {name} differs")
        missing = set(got) - set(exp)
        if missing:
            bad += len(missing)
            notes.append(f"fields the reference does not model: "
                         f"{sorted(missing)}")
    return bad, notes
