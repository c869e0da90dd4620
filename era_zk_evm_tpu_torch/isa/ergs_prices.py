"""Pinned per-variant ergs price table (`OPCODES_PRICES` equivalent).

The reference prices every decoded variant with a table lookup
(/root/reference/src/vm_state/cycle.rs:147-148); the table itself lives in
the non-vendored `zkevm_opcode_defs` crate (SURVEY.md §2.9), so this module
is the framework's single swappable pin for it.

Structure (VERDICT round-1 item 5):

  * `PINNED_PRICES_RLE` — the checked-in expected table, run-length encoded
    over the 1098-entry variant index space of `isa/opcodes.VARIANTS`.
    It was generated ONCE from the `opcodes._price` synthesis (which builds
    prices from the [E]-grade circuit-cost atoms in `isa/params.py`:
    VM_CYCLE_COST_IN_ERGS=4, RAM_PERMUTATION_COST_IN_ERGS=1, the IO prices,
    CALL_LIKE_ERGS_COST=20) and is now an independent artifact: if the
    synthesis drifts, tests/test_isa.py fails; if a value is verified
    against the public v1.4.1 crate and differs, the correction goes in
    `DOCUMENTED_DIVERGENCES` — a one-line data change — without touching
    the synthesis.
  * `DOCUMENTED_DIVERGENCES` — variant_index -> (price, provenance note)
    overrides applied BOTH to the pinned expected table here and to the
    executed `opcodes.VARIANTS` prices (opcodes._synthesize applies them),
    so one data edit swaps the price in every engine — golden, jnp, fused,
    native (tests/test_ergs_sensitivity.py proves the mechanism and that
    prices are behavior-bearing end to end).  Empty as of round 4: the
    environment has zero egress, and an exhaustive grep of the retrieved
    public content (PAPERS.md, SNIPPETS.md — searched for price/ergs/cost
    constants, round 4) surfaced NO v1.4.1 `OPCODES_PRICES` values, so
    none of the [E] atoms could be checked against the public crate; every
    entry added later MUST cite its source.

Provenance grades per price class (see isa/params.py header for grades):

  * alu/ptr/nop/jump reg-only = 5, with-memory-operand = 6   [E]
  * context = 5                                              [E]
  * log.sread = 150, log.swrite = 250, log.event = 25,
    log.to_l1 = 100, log.precompile = 10                     [E]
  * near_call = 25, far_call = 179, ret = 5, uma = 9         [E]
  * invalid (explicit panic variant) = u32::MAX              [V] semantics
    (the masked panic must always be affordable-or-drain; cycle.rs:147-163)

All consumers (golden model, jnp interpreter, fused kernel, native C++
oracle via gen_tables.py) read prices from `isa/opcodes.VARIANTS`, which is
asserted equal to this table at import of the test suite.
"""

from __future__ import annotations

import numpy as np

#: (price, run_length) pairs covering variant indices 0..1097 in order.
PINNED_PRICES_RLE: tuple[tuple[int, int], ...] = (
    (5, 1), (6, 15), (5, 1), (6, 7), (5, 2), (6, 30), (5, 2), (6, 14),
    (5, 4), (6, 60), (5, 4), (6, 28), (5, 2), (6, 30), (5, 2), (6, 14),
    (5, 4), (6, 60), (5, 4), (6, 28), (5, 1), (6, 3), (5, 1), (6, 1),
    (5, 14), (6, 60), (5, 4), (6, 28), (5, 4), (6, 60), (5, 4), (6, 28),
    (5, 4), (6, 60), (5, 4), (6, 28), (5, 4), (6, 60), (5, 4), (6, 28),
    (5, 2), (6, 30), (5, 2), (6, 14), (5, 2), (6, 30), (5, 2), (6, 14),
    (5, 2), (6, 30), (5, 2), (6, 14), (5, 2), (6, 30), (5, 2), (6, 14),
    (5, 2), (6, 30), (5, 2), (6, 14), (5, 2), (6, 30), (5, 2), (6, 14),
    (5, 2), (6, 30), (5, 2), (6, 14), (25, 1), (150, 2), (250, 2),
    (25, 2), (100, 2), (10, 2), (179, 12), (5, 6), (9, 20),
    (4294967295, 1),
)

#: variant_index -> (verified_price, provenance citation).  Applied over
#: the RLE blob by expected_price_table().  MUST stay empty until a value
#: is actually verified against the public zkevm_opcode_defs v1.4.1 branch.
DOCUMENTED_DIVERGENCES: dict[int, tuple[int, str]] = {}


def expected_price_table() -> np.ndarray:
    """The pinned 1098-entry price table with divergences applied."""
    out = np.concatenate([
        np.full(n, p, dtype=np.uint32) for p, n in PINNED_PRICES_RLE])
    for idx, (price, _why) in DOCUMENTED_DIVERGENCES.items():
        out[idx] = price
    return out
