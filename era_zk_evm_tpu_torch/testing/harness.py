"""Testing harness (capability of `src/testing` in the reference).

Bundles the golden backends (`BasicTestingTools` role), offers an
assembly-level program runner with a bootloader-style entry frame, and
final-state extraction (`get_final_net_states` role).
"""

from __future__ import annotations

import dataclasses

from ..golden import (
    BlockProperties, CallStackEntry, CollectingWitnessTracer, GoldenDecommitter,
    GoldenEventSink, GoldenMemory, GoldenPrecompilesProcessor, GoldenStorage,
    GoldenVm,
)
from ..isa import params
from ..isa.assembler import assemble_to_code_words

#: base page of the entry frame (code page 8, stack 9, heap 10, aux heap 11)
ENTRY_BASE_PAGE = 8
ENTRY_ADDRESS = 0x8001        # bootloader formal address: kernel mode
ENTRY_ERGS = 1 << 27


@dataclasses.dataclass
class Tools:
    storage: GoldenStorage
    memory: GoldenMemory
    event_sink: GoldenEventSink
    precompiles: GoldenPrecompilesProcessor
    decommitter: GoldenDecommitter
    witness: CollectingWitnessTracer


def create_default_tools() -> Tools:
    return Tools(
        storage=GoldenStorage(),
        memory=GoldenMemory(),
        event_sink=GoldenEventSink(),
        precompiles=GoldenPrecompilesProcessor(),
        decommitter=GoldenDecommitter(),
        witness=CollectingWitnessTracer(),
    )


def build_vm(code_words: list[int], tools: Tools | None = None,
             entry_address: int = ENTRY_ADDRESS,
             ergs: int = ENTRY_ERGS,
             block_properties: BlockProperties | None = None,
             heap_init: list[int] | None = None,
             is_static: bool = False) -> GoldenVm:
    """Construct a VM with the given entry-point bytecode loaded and a
    bootloader-style frame pushed (vm_state/helpers.rs:289-316 pattern)."""
    tools = tools or create_default_tools()
    vm = GoldenVm(
        storage=tools.storage, memory=tools.memory, event_sink=tools.event_sink,
        precompiles=tools.precompiles, decommitter=tools.decommitter,
        witness_tracer=tools.witness,
        block_properties=block_properties or BlockProperties())
    vm.memory.populate_code(ENTRY_BASE_PAGE, code_words)
    entry = CallStackEntry(
        this_address=entry_address,
        msg_sender=0,
        code_address=entry_address,
        base_memory_page=ENTRY_BASE_PAGE,
        code_page=ENTRY_BASE_PAGE,
        sp=params.INITIAL_SP_ON_FAR_CALL,
        pc=0,
        exception_handler_location=(1 << 16) - 1,
        ergs_remaining=ergs,
        is_static=is_static,
        is_local_frame=False,
        heap_bound=params.NEW_FRAME_MEMORY_STIPEND,
        aux_heap_bound=params.NEW_FRAME_MEMORY_STIPEND,
    )
    vm.local_state.memory_page_counter = max(
        vm.local_state.memory_page_counter,
        ENTRY_BASE_PAGE + params.NEW_MEMORY_PAGES_PER_FAR_CALL)
    vm.push_bootloader_context(0, entry)
    if heap_init:
        vm.memory.populate_heap(heap_init)
    return vm


def run(vm: GoldenVm, max_cycles: int = 10_000, tracer=None) -> int:
    """Cycle until execution ends; returns the number of cycles executed.

    The final non-local `ret` wipes the register file and flags (the
    reference's register-file protocol, ret.rs:213-236), so the state as of
    *just before the exit cycle* is snapshotted onto ``vm.pre_exit_registers``
    / ``vm.pre_exit_flags`` for assertions.
    """
    cycles = 0
    while not vm.execution_has_ended():
        vm.pre_exit_registers = [r.copy() for r in vm.local_state.registers]
        vm.pre_exit_flags = dataclasses.replace(vm.local_state.flags)
        vm.cycle(tracer)
        cycles += 1
        if cycles >= max_cycles:
            raise RuntimeError(f"program did not terminate in {max_cycles} cycles")
    return cycles


def run_asm(source: str, max_cycles: int = 10_000, **kwargs):
    """Assemble, run, and return (vm, tools, cycles)."""
    tools = kwargs.pop("tools", None) or create_default_tools()
    vm = build_vm(assemble_to_code_words(source), tools=tools, **kwargs)
    cycles = run(vm, max_cycles)
    return vm, tools, cycles


def get_final_net_states(tools: Tools):
    """Flattened histories + net states (testing/mod.rs:42-71 role)."""
    storage_history, per_slot = tools.storage.flatten_and_net_history()
    event_history, events, l1_messages = tools.event_sink.flatten()
    return {
        "storage_history": storage_history,
        "per_slot_history": per_slot,
        "final_storage": tools.storage.inner,
        "event_history": event_history,
        "events": events,
        "l1_messages": l1_messages,
    }


def run_golden_like(source: str, max_cycles: int = 256, ergs: int = 1 << 20):
    """Golden run with the native oracle's default entry setup."""
    tools = create_default_tools()
    vm = build_vm(assemble_to_code_words(source), tools=tools, ergs=ergs)
    cycles = run(vm, max_cycles)
    return vm, tools, cycles


def reg(vm: GoldenVm, n: int) -> int:
    """Architectural register rN value as of just before the exit cycle."""
    assert 1 <= n <= params.REGISTERS_COUNT
    regs = getattr(vm, "pre_exit_registers", None) \
        if vm.execution_has_ended() else None
    if regs is None:
        regs = vm.local_state.registers
    return regs[n - 1].value


def flags(vm: GoldenVm):
    """Flags as of just before the exit cycle (the final ret resets them)."""
    f = getattr(vm, "pre_exit_flags", None) if vm.execution_has_ended() else None
    return f if f is not None else vm.local_state.flags
