"""Witness tracer implementations (witness_trace/mod.rs surface).

`DummyTracer` ignores everything; `CollectingWitnessTracer` records the full
ordered query streams — these streams are the golden targets the batched TPU
witness queues are differentially tested (and their commitments compared)
against.
"""

from __future__ import annotations

import dataclasses

from .queries import DecommittmentQuery, LogQuery, MemoryQuery, RefundType


class DummyTracer:
    def start_new_execution_cycle(self, local_state) -> None: ...
    def end_execution_cycle(self, local_state) -> None: ...
    def add_memory_query(self, mcc: int, q: MemoryQuery) -> None: ...
    def record_refund_for_query(self, mcc: int, q: LogQuery, refund: RefundType) -> None: ...
    def add_log_query(self, mcc: int, q: LogQuery) -> None: ...
    def add_decommittment(self, mcc: int, q: DecommittmentQuery, words: list[int]) -> None: ...
    def add_precompile_call_result(self, mcc, q, mem_in, mem_out, round_witness) -> None: ...
    def add_revertable_precompile_call(self, mcc: int, q: LogQuery) -> None: ...
    def start_new_execution_context(self, mcc: int, previous, new) -> None: ...
    def finish_execution_context(self, mcc: int, panicked: bool) -> None: ...


@dataclasses.dataclass
class PrecompileCallResult:
    monotonic_cycle_counter: int
    call_params: LogQuery
    mem_in: list[MemoryQuery]
    mem_out: list[MemoryQuery]
    round_witness: object


class CollectingWitnessTracer(DummyTracer):
    """Records every hook invocation in order (SURVEY.md §5.1)."""

    def __init__(self) -> None:
        self.memory_queries: list[tuple[int, MemoryQuery]] = []
        self.log_queries: list[tuple[int, LogQuery]] = []
        self.refunds: list[tuple[int, LogQuery, RefundType]] = []
        self.decommittments: list[tuple[int, DecommittmentQuery, list[int]]] = []
        self.precompile_calls: list[PrecompileCallResult] = []
        self.context_events: list[tuple[int, str, bool | None]] = []
        self.cycle_count = 0

    def start_new_execution_cycle(self, local_state) -> None:
        self.cycle_count += 1

    def add_memory_query(self, mcc: int, q: MemoryQuery) -> None:
        self.memory_queries.append((mcc, q))

    def record_refund_for_query(self, mcc: int, q: LogQuery, refund: RefundType) -> None:
        self.refunds.append((mcc, q, refund))

    def add_log_query(self, mcc: int, q: LogQuery) -> None:
        self.log_queries.append((mcc, q))

    def add_decommittment(self, mcc: int, q: DecommittmentQuery, words: list[int]) -> None:
        self.decommittments.append((mcc, q, words))

    def add_precompile_call_result(self, mcc, q, mem_in, mem_out, round_witness) -> None:
        self.precompile_calls.append(
            PrecompileCallResult(mcc, q, mem_in, mem_out, round_witness))

    def start_new_execution_context(self, mcc: int, previous, new) -> None:
        self.context_events.append((mcc, "start", None))

    def finish_execution_context(self, mcc: int, panicked: bool) -> None:
        self.context_events.append((mcc, "finish", panicked))
