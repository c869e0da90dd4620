"""Golden memory model.

Reproduces the *observable* semantics of the reference's `SimpleMemory`
(reference_impls/memory.rs:150-759) with a simpler representation: because the
golden model never recycles page numbers (the page counter is monotonic),
pages can live in sparse dicts and the reference's pool/indirection-index
machinery degenerates to a page-kind registry:

  * stack pages hold tagged words (value, is_pointer),
  * heap/aux-heap/code/extended-lifetime pages hold plain words,
  * unwritten words read as zero (the reference's resize_to_fit / .get()
    implicit-zero behavior),
  * fat-pointer reads resolve through a registered indirection set; reading a
    page that was never made reachable is a program error (assert), mirroring
    the reference's `expect("fat pointer only points to reachable memory")`.
"""

from __future__ import annotations

from ..isa.abi import FatPointer
from .queries import MemoryQuery, MemoryType
from .state import CallStackEntry


class GoldenMemory:
    def __init__(self) -> None:
        # page -> sparse {index: word}; stack words are (value, is_pointer)
        self._stack: dict[int, dict[int, tuple[int, bool]]] = {}
        self._words: dict[int, dict[int, int]] = {}  # heap/aux/code/extended
        self._code_lens: dict[int, int] = {}
        # pages a fat pointer may legally dereference
        self._indirections: set[int] = {0}
        # (heap_page, aux_heap_page) per live global frame
        self._heap_frames: list[tuple[int, int]] = [(0, 0)]

    # ------------------------------------------------------------------ setup
    def populate_code(self, page: int, words: list[int]) -> None:
        assert page not in self._words
        self._words[page] = dict(enumerate(words))
        self._code_lens[page] = len(words)

    def populate_heap(self, values: list[int]) -> None:
        heap_page, _ = self._heap_frames[-1]
        self._words.setdefault(heap_page, {}).update(enumerate(values))

    def populate_bootloader_calldata(self, values: list[int]) -> None:
        from ..isa import params

        self._words[params.BOOTLOADER_CALLDATA_PAGE] = dict(enumerate(values))
        self._indirections.add(params.BOOTLOADER_CALLDATA_PAGE)

    # ------------------------------------------------------------------ debug
    def dump_page(self, page: int, start: int, end: int) -> list[int]:
        if page in self._stack:
            return [self._stack[page].get(i, (0, False))[0] for i in range(start, end)]
        src = self._words.get(page, {})
        return [src.get(i, 0) for i in range(start, end)]

    # ------------------------------------------------------------ Memory impl
    def execute_partial_query(self, monotonic_cycle_counter: int,
                              query: MemoryQuery) -> MemoryQuery:
        page, idx = query.page, query.index
        mt = query.memory_type
        if mt == MemoryType.STACK:
            page_map = self._stack.setdefault(page, {})
            if query.rw_flag:
                page_map[idx] = (query.value, query.value_is_pointer)
                return query
            value, is_ptr = page_map.get(idx, (0, False))
            return MemoryQuery(query.timestamp, mt, page, idx, value, is_ptr, False)
        if mt in (MemoryType.HEAP, MemoryType.AUX_HEAP):
            assert not query.value_is_pointer
            page_map = self._words.setdefault(page, {})
            if query.rw_flag:
                page_map[idx] = query.value
                return query
            return MemoryQuery(query.timestamp, mt, page, idx,
                               page_map.get(idx, 0), False, False)
        if mt == MemoryType.FAT_POINTER:
            assert not query.rw_flag and not query.value_is_pointer
            live = any(page in pair for pair in self._heap_frames)
            assert page in self._indirections or live, \
                f"fat pointer dereferences unreachable page {page}"
            value = self._words.get(page, {}).get(idx, 0)
            return MemoryQuery(query.timestamp, mt, page, idx, value, False, False)
        raise AssertionError("code goes through specialized/read_code queries")

    def specialized_code_query(self, monotonic_cycle_counter: int,
                               query: MemoryQuery) -> MemoryQuery:
        assert query.memory_type == MemoryType.CODE
        page_map = self._words.setdefault(query.page, {})
        if query.rw_flag:
            page_map[query.index] = query.value
            return query
        return MemoryQuery(query.timestamp, MemoryType.CODE, query.page,
                           query.index, page_map.get(query.index, 0), False, False)

    def read_code_query(self, monotonic_cycle_counter: int,
                        query: MemoryQuery) -> MemoryQuery:
        assert query.memory_type == MemoryType.CODE and not query.rw_flag
        value = self._words.get(query.page, {}).get(query.index, 0)
        return MemoryQuery(query.timestamp, MemoryType.CODE, query.page,
                           query.index, value, False, False)

    # -------------------------------------------------------- frame lifecycle
    def start_global_frame(self, current_base_page: int, new_base_page: int,
                           calldata_fat_pointer: FatPointer, timestamp: int) -> None:
        heap_page = CallStackEntry.heap_page_from_base(new_base_page)
        aux_heap_page = CallStackEntry.aux_heap_page_from_base(new_base_page)
        self._heap_frames.append((heap_page, aux_heap_page))
        cd_page = calldata_fat_pointer.memory_page
        if cd_page != 0:
            # caller's own heap/aux-heap, or an already-reachable forwarded page
            self._indirections.add(cd_page)

    def finish_global_frame(self, base_page: int,
                            returndata_fat_pointer: FatPointer,
                            timestamp: int) -> None:
        self._heap_frames.pop()
        rd_page = returndata_fat_pointer.memory_page
        if rd_page != 0:
            # returndata page stays reachable for the caller
            self._indirections.add(rd_page)
