"""The port's `compact_log_state` against the JAX package's, field for field,
in the three scenarios of `tests/test_compaction.py`: mid-frame compaction
before a rollback, cancelled events below the base frame, and repeated
compaction of a long-running frame with a small journal."""

import dataclasses

import numpy as np
import pytest

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import make_entry_state, run_cycles
from era_zk_evm_tpu.models.compaction import compact_log_state as jcompact
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.models.compaction import compact_log_state

from test_compaction import PROG_OK, PROG_PANIC, _config
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

LOOP = """
    add 16, r0, r13
    add 1, r0, r10
    loop:
    add r13, r0, r1
    log.swrite r1, r13
    log.event r1, r13
    sub! r13, r10, r13
    jump.if_ne @loop
    ret r0
"""

#: scenario -> (programs, config kwargs, [(cycles, compact after?)])
SCENARIOS = {
    "midframe_rollback": ([PROG_PANIC, PROG_OK], {}, [(10, True), (22, False)]),
    "cancelled_events": ([PROG_PANIC], {}, [(32, True)]),
    "repeated_small_journal": (
        [LOOP], {"journal_slots": 6, "event_slots": 32, "storage_slots": 16},
        [(5, True)] * 20 + [(16, False)]),
}


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _assert_same(ref, got):
    bad = [k for k in ref if ref[k].shape != got[k].shape
           or not (ref[k] == got[k]).all()]
    assert not bad, f"port/jax mismatch in fields: {bad}"


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_compaction_matches_jax(scenario):
    sources, kw, steps = SCENARIOS[scenario]
    config = _config(len(sources), **kw)
    pc = from_jax_config(config)
    words = [assemble_to_code_words(s) for s in sources]
    ref = make_entry_state(config, words, ergs=1 << 20)
    st = pstate.make_entry_state(pc, words, ergs=1 << 20, device="cpu")
    compactions = 0
    for cycles, compact in steps:
        ref = run_cycles(ref, config, cycles)
        fused_cycle.run_cycles(st, pc, cycles)
        if compact:
            ref = jcompact(ref, config)
            assert compact_log_state(st, pc) is st      # in place
            compactions += 1
            _assert_same(_jax_numpy(ref), pstate.state_to_numpy(st))
    got = pstate.state_to_numpy(st)
    _assert_same(_jax_numpy(ref), got)
    assert compactions and not got["lane_error"].any()
