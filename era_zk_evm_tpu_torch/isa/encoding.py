"""Production instruction encoding (8-byte words, 4 per 32-byte code word).

Bit layout of the 64-bit instruction (EncodingModeProduction surface consumed
at vm_state/cycle.rs:55,94,115,126,136 of the reference; layout pinned [P]
from the public EraVM spec):

    bits  0..11   variant index into the opcode decoding table
    bits 11..14   condition (Condition enum, 3 bits)
    bits 14..16   unused (must decode, ignored)
    bits 16..20   src0 register index (4-bit; 0 = r0 hardwired zero)
    bits 20..24   src1 register index
    bits 24..28   dst0 register index
    bits 28..32   dst1 register index
    bits 32..48   imm0 (u16)
    bits 48..64   imm1 (u16)

A 32-byte code word is big-endian; instruction ``sub_pc`` 0 occupies the most
significant 8 bytes (cycle.rs:86-94: "for our BE machine ... inverse order").
"""

from __future__ import annotations

import dataclasses

from . import params
from .opcodes import (
    Condition,
    NOP_VARIANT_INDEX,
    OperandMode,
    Opcode,
    OpcodeVariant,
    PANIC_VARIANT_INDEX,
    get_variant,
)

VARIANT_BITS = 11
CONDITION_BITS = 3
VARIANT_MASK = (1 << VARIANT_BITS) - 1
CONDITION_SHIFT = VARIANT_BITS
SRC0_REG_SHIFT = 16
SRC1_REG_SHIFT = 20
DST0_REG_SHIFT = 24
DST1_REG_SHIFT = 28
IMM0_SHIFT = 32
IMM1_SHIFT = 48


@dataclasses.dataclass
class DecodedOpcode:
    """Fully decoded (and possibly masked) instruction.

    Mirrors the field surface the reference VM consumes from
    `zkevm_opcode_defs::DecodedOpcode` (SURVEY.md §2.9): variant +
    condition + 4 register indices + 2 immediates, plus mask helpers.
    """

    variant: OpcodeVariant
    condition: Condition
    src0_reg: int
    src1_reg: int
    dst0_reg: int
    dst1_reg: int
    imm0: int
    imm1: int

    def mask_into_panic(self) -> None:
        """cycle.rs:187-190: decode-time exception => ret.panic r0."""
        self.variant = get_variant(PANIC_VARIANT_INDEX)
        self.condition = Condition.ALWAYS
        self.src0_reg = self.src1_reg = self.dst0_reg = self.dst1_reg = 0
        self.imm0 = self.imm1 = 0

    def mask_into_nop(self) -> None:
        """cycle.rs:212-217: unmet condition => nop r0 (reg-only addressing)."""
        self.variant = get_variant(NOP_VARIANT_INDEX)
        self.src0_reg = self.src1_reg = self.dst0_reg = self.dst1_reg = 0
        self.imm0 = self.imm1 = 0


def encode(variant_index: int, condition: Condition = Condition.ALWAYS,
           src0_reg: int = 0, src1_reg: int = 0,
           dst0_reg: int = 0, dst1_reg: int = 0,
           imm0: int = 0, imm1: int = 0) -> int:
    """Pack one instruction into its 64-bit representation."""
    assert 0 <= variant_index <= VARIANT_MASK
    for r in (src0_reg, src1_reg, dst0_reg, dst1_reg):
        assert 0 <= r <= params.REGISTERS_COUNT, r
    assert 0 <= imm0 < (1 << 16) and 0 <= imm1 < (1 << 16)
    word = variant_index
    word |= int(condition) << CONDITION_SHIFT
    word |= src0_reg << SRC0_REG_SHIFT
    word |= src1_reg << SRC1_REG_SHIFT
    word |= dst0_reg << DST0_REG_SHIFT
    word |= dst1_reg << DST1_REG_SHIFT
    word |= imm0 << IMM0_SHIFT
    word |= imm1 << IMM1_SHIFT
    return word


def parse_preliminary(raw: int) -> tuple[DecodedOpcode, int]:
    """Decode a 64-bit instruction word.

    Returns (decoded, raw_variant_index); undefined variant indices resolve to
    the INVALID (explicit-panic) entry, exactly as the reference's preliminary
    parse does (cycle.rs:135-144).
    """
    variant_index = raw & VARIANT_MASK
    condition = Condition((raw >> CONDITION_SHIFT) & ((1 << CONDITION_BITS) - 1))
    dec = DecodedOpcode(
        variant=get_variant(variant_index),
        condition=condition,
        src0_reg=(raw >> SRC0_REG_SHIFT) & 0xF,
        src1_reg=(raw >> SRC1_REG_SHIFT) & 0xF,
        dst0_reg=(raw >> DST0_REG_SHIFT) & 0xF,
        dst1_reg=(raw >> DST1_REG_SHIFT) & 0xF,
        imm0=(raw >> IMM0_SHIFT) & 0xFFFF,
        imm1=(raw >> IMM1_SHIFT) & 0xFFFF,
    )
    return dec, variant_index


def nop_encoding() -> int:
    """The canonical skip-cycle NOP (cycle.rs:126)."""
    return encode(NOP_VARIANT_INDEX)


def exception_revert_encoding() -> int:
    """The pending-exception `ret.panic r0` (cycle.rs:115)."""
    return encode(PANIC_VARIANT_INDEX)


def split_pc(pc: int) -> tuple[int, int]:
    """pc -> (super_pc, sub_pc); 4 opcodes per code word (cycle.rs:250-255)."""
    return pc >> params.OPCODES_PER_WORD_LOG_2, pc & (params.OPCODES_PER_WORD - 1)


def instruction_from_code_word(word_u256: int, sub_pc: int) -> int:
    """Select the 8-byte instruction at `sub_pc` from a BE 32-byte code word.

    sub_pc 0 is the most significant 8 bytes (cycle.rs:86-94).
    """
    assert 0 <= sub_pc < params.OPCODES_PER_WORD
    shift = (params.OPCODES_PER_WORD - 1 - sub_pc) * 64
    return (word_u256 >> shift) & ((1 << 64) - 1)


def code_word_from_instructions(instructions: list[int]) -> int:
    """Pack up to 4 instruction words into one BE 32-byte code word."""
    assert len(instructions) <= params.OPCODES_PER_WORD
    word = 0
    for i, ins in enumerate(instructions):
        assert 0 <= ins < (1 << 64)
        word |= ins << ((params.OPCODES_PER_WORD - 1 - i) * 64)
    return word
