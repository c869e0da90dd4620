"""Witness query records and aux types (surface of `zk_evm_abstractions`).

Re-specifies SURVEY.md §2.10: MemoryQuery / LogQuery / DecommittmentQuery and
the aux enums.  U256 values are Python ints in the golden model.
"""

from __future__ import annotations

import dataclasses
import enum


class MemoryType(enum.IntEnum):
    STACK = 0
    HEAP = 1
    AUX_HEAP = 2
    FAT_POINTER = 3
    CODE = 4


@dataclasses.dataclass(frozen=True)
class MemoryQuery:
    timestamp: int
    memory_type: MemoryType
    page: int
    index: int
    value: int
    value_is_pointer: bool
    rw_flag: bool


@dataclasses.dataclass(frozen=True)
class LogQuery:
    timestamp: int
    tx_number_in_block: int
    aux_byte: int
    shard_id: int
    address: int          # 160-bit address as int
    key: int
    read_value: int
    written_value: int
    rw_flag: bool
    rollback: bool
    is_service: bool

    def with_(self, **kw) -> "LogQuery":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DecommittmentQuery:
    hash: int
    timestamp: int
    memory_page: int
    decommitted_length: int
    is_fresh: bool


class RefundType(enum.Enum):
    NONE = "none"
    REPEATED_WRITE = "repeated_write"

    def pubdata_refund(self) -> int:
        # reference testing impl always returns None => refund 0
        # (testing/storage.rs:80-86, log.rs:99-103)
        return 0


@dataclasses.dataclass(frozen=True)
class EventMessage:
    """Flattened event / L1 message (reference_impls/event_sink.rs:7-14)."""

    shard_id: int
    is_first: bool
    tx_number_in_block: int
    address: int
    key: int
    value: int
