"""Fat pointers, call/ret ABIs and the versioned code-hash format.

Re-specification of the `zkevm_opcode_defs` ABI surface consumed by the
reference (SURVEY.md §2.9): FatPointer (+validation), FarCallABI, RetABI,
NearCallABI, PrecompileCallABI, VmMetaParameters, ContractCodeSha256
versioned hashes.  U256 values are plain Python ints here (the golden model's
representation); the batched interpreter re-implements the same bit layouts
on u32 limbs.

Bit-layout provenance: the far-call ABI packing is pinned [P] from the public
zkSync Era system-contract library (SystemContractsCaller), which constructs
these words on-chain:

    bits   0..32   fat pointer `offset`
    bits  32..64   fat pointer `memory_page`
    bits  64..96   fat pointer `start`
    bits  96..128  fat pointer `length`
    bits 192..224  ergs_passed
    bits 224..232  shard_id
    bits 232..240  forwarding mode (0 = UseHeap, 1 = ForwardFatPointer,
                                    2 = UseAuxHeap)
    bits 240..248  constructor-call flag
    bits 248..256  to-system flag
"""

from __future__ import annotations

import dataclasses
import enum

from . import params

U32_MASK = (1 << 32) - 1
U64_MASK = (1 << 64) - 1
U128_MASK = (1 << 128) - 1
U256_MASK = (1 << 256) - 1


class ForwardingMode(enum.IntEnum):
    """Calldata/returndata page forwarding (FarCallForwardPageType /
    RetForwardPageType; values from SystemContractsCaller's
    CalldataForwardingMode enum)."""

    USE_HEAP = 0
    FORWARD_FAT_POINTER = 1
    USE_AUX_HEAP = 2


class FatPointerValidationException(enum.IntFlag):
    NONE = 0
    DEREF_BEYOND_HEAP_RANGE = 1
    OFFSET_NOT_ZERO_WHEN_FRESH = 2


@dataclasses.dataclass
class FatPointer:
    """(offset, memory_page, start, length), each u32 (SURVEY.md §2.9).

    Packed into the low 128 bits of a U256 in that order; evidenced by the
    reference's in-place offset update at uma.rs:335-343 (offset lives in the
    low 32 bits of limb 0, memory_page in the high 32 bits of limb 0).
    """

    offset: int = 0
    memory_page: int = 0
    start: int = 0
    length: int = 0

    @classmethod
    def empty(cls) -> "FatPointer":
        return cls(0, 0, 0, 0)

    @classmethod
    def from_u256(cls, value: int) -> "FatPointer":
        return cls(
            offset=value & U32_MASK,
            memory_page=(value >> 32) & U32_MASK,
            start=(value >> 64) & U32_MASK,
            length=(value >> 96) & U32_MASK,
        )

    def to_u256(self) -> int:
        return (self.offset & U32_MASK) | ((self.memory_page & U32_MASK) << 32) \
            | ((self.start & U32_MASK) << 64) | ((self.length & U32_MASK) << 96)

    def validate(self, as_fresh: bool) -> FatPointerValidationException:
        """Structural validation (far_call.rs:271-273, ret.rs:80)."""
        exc = FatPointerValidationException.NONE
        if self.start + self.length > U32_MASK:
            exc |= FatPointerValidationException.DEREF_BEYOND_HEAP_RANGE
        if as_fresh and self.offset != 0:
            exc |= FatPointerValidationException.OFFSET_NOT_ZERO_WHEN_FRESH
        return exc

    def validate_as_slice(self) -> bool:
        """Offset may sit one past the end (ret.rs:87-91 allows ret.ok r0)."""
        return self.offset <= self.length

    def validate_in_bounds(self) -> bool:
        """Strict in-bounds check used by UMA fat-pointer reads (uma.rs:111)."""
        return self.offset < self.length


def erase_fat_pointer_metadata(value: int) -> int:
    """Clear page/start/length, keep offset and the high 128 bits.

    Applied when a pointer value flows into an opcode that must not observe
    pointers (cycle.rs:374-396).
    """
    return value & ~(U128_MASK ^ U32_MASK)


@dataclasses.dataclass
class FarCallABI:
    memory_quasi_fat_pointer: FatPointer
    ergs_passed: int
    shard_id: int
    forwarding_mode: ForwardingMode
    constructor_call: bool
    to_system: bool

    @classmethod
    def from_u256(cls, value: int) -> "FarCallABI":
        mode_raw = (value >> 232) & 0xFF
        try:
            mode = ForwardingMode(mode_raw)
        except ValueError:
            # out-of-range forwarding bytes behave as UseHeap (the enum decode
            # in the upstream crate saturates unknown values)
            mode = ForwardingMode.USE_HEAP
        return cls(
            memory_quasi_fat_pointer=FatPointer.from_u256(value),
            ergs_passed=(value >> 192) & U32_MASK,
            shard_id=(value >> 224) & 0xFF,
            forwarding_mode=mode,
            constructor_call=bool((value >> 240) & 0xFF),
            to_system=bool((value >> 248) & 0xFF),
        )

    def to_u256(self) -> int:
        return (self.memory_quasi_fat_pointer.to_u256()
                | ((self.ergs_passed & U32_MASK) << 192)
                | ((self.shard_id & 0xFF) << 224)
                | (int(self.forwarding_mode) << 232)
                | (int(bool(self.constructor_call)) << 240)
                | (int(bool(self.to_system)) << 248))


@dataclasses.dataclass
class RetABI:
    memory_quasi_fat_pointer: FatPointer
    page_forwarding_mode: ForwardingMode

    @classmethod
    def from_u256(cls, value: int) -> "RetABI":
        mode_raw = (value >> 232) & 0xFF
        try:
            mode = ForwardingMode(mode_raw)
        except ValueError:
            mode = ForwardingMode.USE_HEAP
        return cls(FatPointer.from_u256(value), mode)

    def to_u256(self) -> int:
        return self.memory_quasi_fat_pointer.to_u256() \
            | (int(self.page_forwarding_mode) << 232)


@dataclasses.dataclass
class NearCallABI:
    ergs_passed: int

    @classmethod
    def from_u256(cls, value: int) -> "NearCallABI":
        return cls(ergs_passed=value & U32_MASK)

    def to_u256(self) -> int:
        return self.ergs_passed & U32_MASK


@dataclasses.dataclass
class PrecompileCallABI:
    """Exactly fills 256 bits: six u32 fields + one u64
    (log.rs:266-301, testing/tests/precompiles/keccak256.rs:103-111)."""

    input_memory_offset: int = 0
    input_memory_length: int = 0
    output_memory_offset: int = 0
    output_memory_length: int = 0
    memory_page_to_read: int = 0
    memory_page_to_write: int = 0
    precompile_interpreted_data: int = 0

    @classmethod
    def from_u256(cls, value: int) -> "PrecompileCallABI":
        return cls(
            input_memory_offset=value & U32_MASK,
            input_memory_length=(value >> 32) & U32_MASK,
            output_memory_offset=(value >> 64) & U32_MASK,
            output_memory_length=(value >> 96) & U32_MASK,
            memory_page_to_read=(value >> 128) & U32_MASK,
            memory_page_to_write=(value >> 160) & U32_MASK,
            precompile_interpreted_data=(value >> 192) & U64_MASK,
        )

    def to_u256(self) -> int:
        return ((self.input_memory_offset & U32_MASK)
                | ((self.input_memory_length & U32_MASK) << 32)
                | ((self.output_memory_offset & U32_MASK) << 64)
                | ((self.output_memory_length & U32_MASK) << 96)
                | ((self.memory_page_to_read & U32_MASK) << 128)
                | ((self.memory_page_to_write & U32_MASK) << 160)
                | ((self.precompile_interpreted_data & U64_MASK) << 192))


@dataclasses.dataclass
class VmMetaParameters:
    """`context.meta` result (context.rs:65-86)."""

    ergs_per_pubdata_byte: int
    heap_size: int
    aux_heap_size: int
    this_shard_id: int
    caller_shard_id: int
    code_shard_id: int

    def to_u256(self) -> int:
        return ((self.ergs_per_pubdata_byte & U32_MASK)
                | ((self.heap_size & U32_MASK) << 64)
                | ((self.aux_heap_size & U32_MASK) << 96)
                | ((self.this_shard_id & 0xFF) << 224)
                | ((self.caller_shard_id & 0xFF) << 232)
                | ((self.code_shard_id & 0xFF) << 240))


@dataclasses.dataclass
class VersionedCodeHash:
    """ContractCodeSha256 versioned hash (far_call.rs:169-252).

    32-byte BE layout: byte0 version (=1), byte1 marker (0 at rest /
    1 yet-constructed), bytes2..4 code length in words (BE u16),
    bytes 4..32 sha256 tail.
    """

    marker: int
    code_length_in_words: int
    tail: bytes  # 28 bytes

    @classmethod
    def try_from_u256(cls, value: int) -> "VersionedCodeHash | None":
        raw = value.to_bytes(32, "big")
        if raw[0] != params.CODE_HASH_VERSION_BYTE:
            return None
        return cls(
            marker=raw[1],
            code_length_in_words=int.from_bytes(raw[2:4], "big"),
            tail=raw[4:32],
        )

    def to_u256(self) -> int:
        raw = bytes([params.CODE_HASH_VERSION_BYTE, self.marker & 0xFF]) \
            + int(self.code_length_in_words & 0xFFFF).to_bytes(2, "big") \
            + self.tail
        return int.from_bytes(raw, "big")

    def serialize_to_stored(self) -> int:
        """Normalized at-rest form (marker byte forced to 0)."""
        return dataclasses.replace(self, marker=params.CODE_AT_REST_MARKER).to_u256()


def code_hash_for_bytecode(words: list[int], marker: int = params.CODE_AT_REST_MARKER) -> int:
    """Build a valid versioned hash for a word-list bytecode (test helper)."""
    import hashlib

    data = b"".join(w.to_bytes(32, "big") for w in words)
    digest = hashlib.sha256(data).digest()
    return VersionedCodeHash(
        marker=marker,
        code_length_in_words=len(words),
        tail=digest[4:32],
    ).to_u256()
