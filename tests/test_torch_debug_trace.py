"""The port's debug trace (`testing/debug_trace.py`) against golden's hooks.

The two device cases of `tests/test_aux_subsystems.py:45-130`: the
per-cycle snapshots of a traced lane line up 1:1 with golden's tracer
events (golden's before-decoding view: pc, sp, ergs, depth, flags,
timestamp, and the raw instruction of its after-decoding event), and the
page dumps of heap, stack and code pages equal golden's `dump_page`.
Golden is plain Python: no XLA program is compiled.
"""

import numpy as np

from era_zk_evm_tpu.golden.state import Flags
from era_zk_evm_tpu.golden.tracing import CollectingDebugTracer
from era_zk_evm_tpu.testing.harness import build_vm, run
from era_zk_evm_tpu_torch.config import VmConfig
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing.debug_trace import (
    dump_full_page, dump_page_content, format_trace, resolve_page,
    trace_cycles,
)
from era_zk_evm_tpu_torch.testing.programs import assemble
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

TRACED = """
add 7, r0, r1
add 3, r0, r9
near_call r9, @sub, @h
back:
sub! r1, r1, r2
add.if_ne 99, r0, r3
ret r0
sub:
add r1, r1, r4
ret r0
h:
jump @back
"""
DUMPED = """
add 77, r0, r5
st.h 32, r5
add r5, r0, stack[3]
sub! r5, r5, r6
ret r0
"""
# tests/test_aux_subsystems.py's config
CONFIG = VmConfig(batch=2, code_words=32, stack_words=2048, heap_words=16,
                  aux_heap_words=8, max_depth=8, queue_capacity=0)


class ViewTracer(CollectingDebugTracer):
    """Golden's collecting tracer, also recording the before-decoding view
    the device snapshot holds."""

    def before_decoding(self, local_state, memory) -> None:
        super().before_decoding(local_state, memory)
        cur, f = local_state.callstack.current, local_state.flags
        self.events.append(("view", (
            cur.pc, cur.sp, cur.ergs_remaining,
            local_state.callstack.depth(),
            (f.overflow_or_less_than, f.equality, f.greater_than),
            local_state.timestamp)))


def test_trace_matches_golden_hooks():
    tracer = ViewTracer()
    vm = build_vm(assemble(TRACED), ergs=1 << 20)
    cycles = run(vm, 32, tracer=tracer)
    views = [v for k, v in tracer.events if k == "view"]
    raws = [d.raw_opcode_unmasked for k, d in tracer.events
            if k == "after_decoding"]
    assert len(views) == len(raws) == cycles

    state = pstate.make_entry_state(CONFIG, [assemble(TRACED)] * 2,
                                    ergs=1 << 20, device="cpu")
    state, traces = trace_cycles(state, CONFIG, cycles, lanes=[1],
                                 with_registers=True)
    assert bool(state.done.all())
    trace = traces[0]
    assert [(s.pc, s.sp, s.ergs, s.depth, s.flags, s.timestamp)
            for s in trace] == views
    assert [s.instruction for s in trace] == raws
    assert [s.cycle for s in trace] == list(range(cycles))
    assert any("near_call" in s.asm for s in trace)
    assert trace[1].registers[0] == 7 and len(trace[1].registers) == 15
    listing = format_trace(trace)
    assert "pc=" in listing and "near_call" in listing
    # the state advanced exactly as an untraced run
    plain = fused_cycle.run_cycles(pstate.make_entry_state(
        CONFIG, [assemble(TRACED)] * 2, ergs=1 << 20, device="cpu"),
        CONFIG, cycles)
    a, b = pstate.state_to_numpy(plain), pstate.state_to_numpy(state)
    assert not [k for k in a if not np.array_equal(a[k], b[k])]


def test_page_dumps_match_golden():
    assert repr(Flags(True, False, True)) == "lt+ eq- gt+"
    vm = build_vm(assemble(DUMPED), ergs=1 << 20)
    run(vm, 16)
    state = fused_cycle.run_cycles(pstate.make_entry_state(
        CONFIG, [assemble(DUMPED)] * 2, ergs=1 << 20, device="cpu"),
        CONFIG, 16)
    assert bool(state.done.all())
    base = 8                 # make_entry_state's default base_page
    for page, lo, hi, kind in ((base + 2, 0, 4, "heap"),
                               (base + 1, 0, 8, "stack"),
                               (base, 0, 4, "code")):
        assert resolve_page(state, CONFIG, 0, page)[0] == kind
        got = dump_page_content(state, CONFIG, 0, page, lo, hi)
        assert got == [f"{w:064x}" for w in vm.memory.dump_page(page, lo, hi)]
    assert int(dump_page_content(state, CONFIG, 0, base + 2, 1, 2)[0],
               16) == 77
    # a range past the arena and a page that is not materialized read as
    # zeros (the reference's sparse pages)
    heap = dump_full_page(state, CONFIG, 1, base + 2)
    assert len(heap) == CONFIG.heap_words and int(heap[1], 16) == 77
    assert dump_page_content(state, CONFIG, 0, base + 2, 14, 18)[2:] \
        == ["0" * 64] * 2
    assert resolve_page(state, CONFIG, 0, 0x7FFF) is None
    assert dump_page_content(state, CONFIG, 0, 0x7FFF, 0, 2) \
        == ["0" * 64] * 2
