"""Debug tracer interface (L5) — the reference's `Tracer` hook system.

Mirrors src/tracing.rs:11-72: four hook sites gated by class-level constants
(zero cost when disabled, like the reference's compile-time consts), with the
same payload surface: raw vs masked opcode, accumulated error flags, resolved
condition, operand values, memory locations.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class AfterDecodingData:
    raw_opcode_unmasked: int
    opcode_masked: Any              # DecodedOpcode
    error_flags_accumulated: int    # ErrorFlags
    resolved_condition: bool
    did_skip_cycle: bool


@dataclasses.dataclass
class BeforeExecutionData:
    opcode: Any
    src0_value: Any                 # PrimitiveValue
    src1_value: Any
    src0_mem_location: Any          # (MemoryType, page, index) | None
    new_pc: int


@dataclasses.dataclass
class AfterExecutionData:
    opcode: Any
    dst0_mem_location: Any


class Tracer:
    """Subclass and flip the CALL_* gates to receive hooks (tracing.rs:40-72)."""

    CALL_BEFORE_DECODING = False
    CALL_AFTER_DECODING = False
    CALL_BEFORE_EXECUTION = False
    CALL_AFTER_EXECUTION = False

    def before_decoding(self, local_state, memory) -> None: ...
    def after_decoding(self, local_state, data: AfterDecodingData, memory) -> None: ...
    def before_execution(self, local_state, data: BeforeExecutionData, memory) -> None: ...
    def after_execution(self, local_state, data: AfterExecutionData, memory) -> None: ...


class NoopTracer(Tracer):
    """utils.rs:50-92 / testing/simple_tracer.rs role."""


class CollectingDebugTracer(Tracer):
    """Records every hook payload — the debugging workhorse."""

    CALL_BEFORE_DECODING = True
    CALL_AFTER_DECODING = True
    CALL_BEFORE_EXECUTION = True
    CALL_AFTER_EXECUTION = True

    def __init__(self) -> None:
        self.events: list[tuple[str, Any]] = []

    def before_decoding(self, local_state, memory) -> None:
        self.events.append(("before_decoding",
                            local_state.callstack.current.pc))

    def after_decoding(self, local_state, data, memory) -> None:
        self.events.append(("after_decoding", data))

    def before_execution(self, local_state, data, memory) -> None:
        self.events.append(("before_execution", data))

    def after_execution(self, local_state, data, memory) -> None:
        self.events.append(("after_execution", data))
