"""VM local state: flags, callstack, registers (SURVEY.md §2.1, §2.8)."""

from __future__ import annotations

import dataclasses

from ..isa import params

U256_MASK = (1 << 256) - 1
U16_MASK = (1 << 16) - 1


@dataclasses.dataclass
class PrimitiveValue:
    """256-bit value + pointer tag (vm_state/mod.rs:31-51)."""

    value: int = 0
    is_pointer: bool = False

    @classmethod
    def empty(cls) -> "PrimitiveValue":
        return cls(0, False)

    def copy(self) -> "PrimitiveValue":
        return PrimitiveValue(self.value, self.is_pointer)


@dataclasses.dataclass
class Flags:
    """of/lt, eq, gt (flags.rs:4-37)."""

    overflow_or_less_than: bool = False
    equality: bool = False
    greater_than: bool = False

    def reset(self) -> None:
        self.overflow_or_less_than = False
        self.equality = False
        self.greater_than = False

    def __repr__(self) -> str:
        # the reference's custom Debug: `lt± eq± gt±` (flags.rs:39-56)
        return (f"lt{'+' if self.overflow_or_less_than else '-'} "
                f"eq{'+' if self.equality else '-'} "
                f"gt{'+' if self.greater_than else '-'}")


@dataclasses.dataclass
class CallStackEntry:
    """One frame (vm_state/execution_stack.rs:6-24)."""

    this_address: int = 0
    msg_sender: int = 0
    code_address: int = 0
    base_memory_page: int = params.UNMAPPED_PAGE
    code_page: int = params.UNMAPPED_PAGE
    sp: int = 0
    pc: int = 0
    exception_handler_location: int = 0
    ergs_remaining: int = 0
    this_shard_id: int = 0
    caller_shard_id: int = 0
    code_shard_id: int = 0
    is_static: bool = False
    is_local_frame: bool = False
    context_u128_value: int = 0
    heap_bound: int = 0
    aux_heap_bound: int = 0

    @classmethod
    def empty_context(cls) -> "CallStackEntry":
        return cls(
            sp=params.INITIAL_SP_ON_FAR_CALL,
            ergs_remaining=params.VM_INITIAL_FRAME_ERGS,
        )

    def copy(self) -> "CallStackEntry":
        return dataclasses.replace(self)

    def is_kernel_mode(self) -> bool:
        return self.this_address < params.KERNEL_SPACE_BOUND

    # page mapping: base+0 code candidate, +1 stack, +2 heap, +3 aux heap
    @staticmethod
    def code_page_candidate_from_base(base: int) -> int:
        return base

    @staticmethod
    def stack_page_from_base(base: int) -> int:
        return base + 1

    @staticmethod
    def heap_page_from_base(base: int) -> int:
        return base + 2

    @staticmethod
    def aux_heap_page_from_base(base: int) -> int:
        return base + 3


class Callstack:
    """current + inner stack with depth cap (execution_stack.rs:90-140)."""

    def __init__(self) -> None:
        self.current = CallStackEntry.empty_context()
        self.inner: list[CallStackEntry] = []

    def push_entry(self, entry: CallStackEntry) -> None:
        self.inner.append(self.current)
        self.current = entry
        assert self.depth() <= params.VM_MAX_STACK_DEPTH

    def pop_entry(self) -> CallStackEntry:
        old = self.current
        self.current = self.inner.pop()
        return old

    def depth(self) -> int:
        return len(self.inner)

    def is_empty(self) -> bool:
        return not self.inner

    def is_full(self) -> bool:
        return self.depth() == params.VM_MAX_STACK_DEPTH


class VmLocalState:
    """Full architectural state (vm_state/mod.rs:53-107)."""

    def __init__(self) -> None:
        self.previous_code_word = 0
        self.previous_code_memory_page = 0
        self.registers = [PrimitiveValue.empty() for _ in range(params.REGISTERS_COUNT)]
        self.flags = Flags()
        self.timestamp = params.STARTING_TIMESTAMP
        self.monotonic_cycle_counter = 0
        self.spent_pubdata_counter = 0
        self.memory_page_counter = params.STARTING_BASE_PAGE
        self.absolute_execution_step = 0
        self.current_ergs_per_pubdata_byte = 0
        self.tx_number_in_block = 0
        self.pending_exception = False
        self.previous_super_pc = 0
        self.context_u128_register = 0
        self.callstack = Callstack()

    def execution_has_ended(self) -> bool:
        return self.callstack.is_empty()

    def callstack_is_full(self) -> bool:
        return self.callstack.is_full()

    # timestamp discipline (vm_state/mod.rs:220-234): 4 slots per cycle
    def timestamp_for_code_or_src_read(self) -> int:
        return self.timestamp

    def timestamp_for_first_decommit_or_precompile_read(self) -> int:
        return self.timestamp + 1

    def timestamp_for_second_decommit_or_precompile_write(self) -> int:
        return self.timestamp + 2

    def timestamp_for_dst_write(self) -> int:
        return self.timestamp + 3
