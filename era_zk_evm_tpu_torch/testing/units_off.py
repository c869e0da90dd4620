"""Configs whose precompile settings outrun their units, and their lanes.

The JAX jnp engine runs a config that asks for the precompile units,
ecrecover or a precompile queue without what they need with those units
simply off, and so does the port.  Two configs
cover the four cases:

  * X: the keccak256 / sha256 units, ecrecover and a precompile queue asked
    for, no storage: without the LOG unit every LOG opcode sets
    `lane_error`;
  * Y: storage, ecrecover and a precompile queue, but no keccak blocks: the
    LOG unit runs, `log.precompile` sets `lane_error`.

`PROGRAMS` are three lanes (a plain arithmetic and heap program, a
`log.precompile` at the keccak256 precompile's address, an sstore /
sload), `ENTRY` their entry addresses and `LANE_ERRORS` the `lane_error`
each config gives them.  `tests/test_torch_units_off.py` holds both
configs against the JAX jnp engine, `chip_smoke.py` and
`tests/test_torch_cuda.py` K1 against the plain engine.
"""

from __future__ import annotations

from ..config import VmConfig
from ..isa import params
from .block_programs import KECCAK_PROGRAMS

N_CYCLES, ERGS = 16, 1 << 20
HEAP = """
    add 7, r0, r1
    add 35, r0, r2
    mul r1, r2, r3, r4
    st.h 64, r3
    ld.h 64, r5
    add! r5, r1, r6
    ret r0
"""
STORAGE = """
    add 5, r0, r1
    add 77, r0, r2
    log.swrite r1, r2
    log.sread r1, r3
    st.h 0, r3
    ret r0
"""
PROGRAMS = [HEAP, KECCAK_PROGRAMS[0], STORAGE]
ENTRY = [0x8001, params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS, 0x8001]
#: lane_error of (heap, log.precompile, sstore / sload)
LANE_ERRORS = {"X": [False, True, True], "Y": [False, True, False]}


def configs(batch: int = 3) -> dict[str, VmConfig]:
    """Configs X and Y at `batch` lanes."""
    geometry = dict(batch=batch, code_words=32, stack_words=256,
                    sweep_gating=False, stack_abs_words=64,
                    stack_sp_base=960, heap_words=64, aux_heap_words=16,
                    max_depth=8, queue_capacity=N_CYCLES * 8,
                    precompile_ecrecover=True, precompile_queue_capacity=16)
    return {
        "X": VmConfig(**geometry, precompile_keccak_blocks=1,
                      precompile_sha_rounds=1),
        "Y": VmConfig(**geometry, storage_slots=4, journal_slots=8,
                      event_slots=8, log_queue_capacity=N_CYCLES),
    }
