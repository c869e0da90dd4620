"""Golden code decommitter (reference_impls/decommitter.rs semantics).

Known code hashes map to word lists; a repeat decommit returns the previously
used page with ``is_fresh=False`` (the far-call refund path); an unknown hash
is the VM's single hard error.
"""

from __future__ import annotations

from .memory import GoldenMemory
from .queries import DecommittmentQuery, MemoryQuery, MemoryType


class UnknownCodeHashError(RuntimeError):
    pass


class GoldenDecommitter:
    def __init__(self, collect_witness: bool = True) -> None:
        self._known: dict[int, list[int]] = {}
        self._history: dict[int, tuple[int, int]] = {}  # hash -> (page, len)
        self._collect_witness = collect_witness

    def populate(self, elements: list[tuple[int, list[int]]]) -> None:
        for code_hash, words in elements:
            assert code_hash not in self._known
            self._known[code_hash] = list(words)

    def decommit_into_memory(
        self, monotonic_cycle_counter: int, partial_query: DecommittmentQuery,
        memory: GoldenMemory,
    ) -> tuple[DecommittmentQuery, list[int] | None]:
        h = partial_query.hash
        if h in self._history:
            page, length = self._history[h]
            q = DecommittmentQuery(h, partial_query.timestamp, page, length, False)
            return q, ([] if self._collect_witness else None)
        if h not in self._known:
            raise UnknownCodeHashError(f"code hash {h:#x} must be known")
        words = self._known[h]
        page = partial_query.memory_page
        self._history[h] = (page, len(words))
        for i, value in enumerate(words):
            memory.specialized_code_query(monotonic_cycle_counter, MemoryQuery(
                timestamp=partial_query.timestamp, memory_type=MemoryType.CODE,
                page=page, index=i, value=value, value_is_pointer=False, rw_flag=True))
        q = DecommittmentQuery(h, partial_query.timestamp, page, len(words), True)
        return q, (list(words) if self._collect_witness else None)
