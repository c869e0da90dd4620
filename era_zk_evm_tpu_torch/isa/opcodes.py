"""EraVM opcode families, sub-variants, addressing modes and the variant table.

The production encoding stores an 11-bit *variant index* per instruction; the
index resolves (via a synthesized table, mirroring the role of
`zkevm_opcode_defs`' opcode decoding tables) to:

    (opcode family, sub-variant, src0 addressing mode, dst0 addressing mode,
     flag bits, ergs price, predicate bits)

SURVEY.md §2.9 enumerates the exact surface consumed by the reference VM core
(/root/reference/src/vm_state/cycle.rs:135-217 etc.).  The enumeration *order*
of the table is canonical **for this framework** (documented below); index
parity with the published crate is flagged for later verification in
isa/params.py's provenance scheme.

The table is exposed twice:
  * as Python dataclasses (used by the golden model and the assembler), and
  * as packed NumPy arrays (``TABLE``) that the batched TPU interpreter
    gathers from on-device.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import lru_cache

import numpy as np

from . import params


class Opcode(enum.IntEnum):
    """Opcode families (opcodes/parsing.rs:61-78 of the reference)."""

    NOP = 0
    ADD = 1
    SUB = 2
    MUL = 3
    DIV = 4
    JUMP = 5
    CONTEXT = 6
    SHIFT = 7
    BINOP = 8
    PTR = 9
    NEAR_CALL = 10
    LOG = 11
    FAR_CALL = 12
    RET = 13
    UMA = 14
    INVALID = 15


class ContextOp(enum.IntEnum):
    THIS = 0
    CALLER = 1
    CODE_ADDRESS = 2
    META = 3
    ERGS_LEFT = 4
    SP = 5
    GET_CONTEXT_U128 = 6
    SET_CONTEXT_U128 = 7
    SET_ERGS_PER_PUBDATA_BYTE = 8
    INCREMENT_TX_NUMBER = 9


class ShiftOp(enum.IntEnum):
    SHL = 0
    SHR = 1
    ROL = 2
    ROR = 3


class BinopOp(enum.IntEnum):
    XOR = 0
    AND = 1
    OR = 2


class PtrOp(enum.IntEnum):
    ADD = 0
    SUB = 1
    PACK = 2
    SHRINK = 3


class LogOp(enum.IntEnum):
    STORAGE_READ = 0
    STORAGE_WRITE = 1
    EVENT = 2
    TO_L1_MESSAGE = 3
    PRECOMPILE_CALL = 4


class FarCallOp(enum.IntEnum):
    NORMAL = 0
    DELEGATE = 1
    MIMIC = 2


class RetOp(enum.IntEnum):
    OK = 0
    REVERT = 1
    PANIC = 2


class UMAOp(enum.IntEnum):
    HEAP_READ = 0
    HEAP_WRITE = 1
    AUX_HEAP_READ = 2
    AUX_HEAP_WRITE = 3
    FAT_POINTER_READ = 4


class Condition(enum.IntEnum):
    """Predicated execution conditions (cycle.rs:193-209)."""

    ALWAYS = 0
    GT = 1
    LT = 2
    EQ = 3
    GE = 4
    LE = 5
    NE = 6
    GT_OR_LT = 7


class OperandMode(enum.IntEnum):
    """Resolved src0/dst0 addressing mode (mem_ops.rs:37-122).

    Collapses the reference's ``Operand::{RegOnly, RegOrImm(..), Full(..)}``
    nesting into one flat enum; the *class* groupings used during table
    synthesis are `SRC_MODES_*` / `DST_MODES_*` below.
    """

    REG_ONLY = 0            # Operand::RegOnly
    REG_OR_IMM_REG = 1      # Operand::RegOrImm(UseRegOnly)
    REG_OR_IMM_IMM = 2      # Operand::RegOrImm(UseImm16Only)
    FULL_REG = 3            # Operand::Full(UseRegOnly)
    FULL_STACK_PUSH_POP = 4  # Operand::Full(UseStackWithPushPop)
    FULL_STACK_OFFSET = 5    # Operand::Full(UseStackWithOffset)
    FULL_ABS_STACK = 6       # Operand::Full(UseAbsoluteOnStack)
    FULL_IMM16 = 7           # Operand::Full(UseImm16Only)
    FULL_CODE_PAGE = 8       # Operand::Full(UseCodePage)


#: modes whose source value comes from memory (cycle.rs:304-325)
MEMORY_SRC_MODES = frozenset({
    OperandMode.FULL_STACK_PUSH_POP,
    OperandMode.FULL_STACK_OFFSET,
    OperandMode.FULL_ABS_STACK,
    OperandMode.FULL_CODE_PAGE,
})
#: modes whose destination is a memory location
MEMORY_DST_MODES = frozenset({
    OperandMode.FULL_STACK_PUSH_POP,
    OperandMode.FULL_STACK_OFFSET,
    OperandMode.FULL_ABS_STACK,
})
#: modes where src0 is the imm16 constant itself
IMM_SRC_MODES = frozenset({OperandMode.REG_OR_IMM_IMM, OperandMode.FULL_IMM16})

# Canonical mode enumeration orders for table synthesis (mirrors the
# ImmMemHandlerFlags declaration order of the upstream crate).
SRC_MODES_FULL = (
    OperandMode.FULL_REG,
    OperandMode.FULL_STACK_PUSH_POP,
    OperandMode.FULL_STACK_OFFSET,
    OperandMode.FULL_ABS_STACK,
    OperandMode.FULL_IMM16,
    OperandMode.FULL_CODE_PAGE,
)
SRC_MODES_REG_OR_IMM = (OperandMode.REG_OR_IMM_REG, OperandMode.REG_OR_IMM_IMM)
SRC_MODES_REG_ONLY = (OperandMode.REG_ONLY,)
DST_MODES_FULL = (
    OperandMode.FULL_REG,
    OperandMode.FULL_STACK_PUSH_POP,
    OperandMode.FULL_STACK_OFFSET,
    OperandMode.FULL_ABS_STACK,
)
DST_MODES_REG_ONLY = (OperandMode.REG_ONLY,)


@dataclasses.dataclass(frozen=True)
class OpcodeVariant:
    """One entry of the decoding table."""

    index: int
    opcode: Opcode
    sub: int                    # value of the family's sub-variant enum (0 if none)
    src0_mode: OperandMode
    dst0_mode: OperandMode
    flag0: bool
    flag1: bool
    price: int
    requires_kernel: bool
    allowed_in_static: bool
    src0_can_be_pointer: bool
    src1_can_be_pointer: bool
    is_explicit_panic: bool

    # -- resolved flag semantics ------------------------------------------
    @property
    def set_flags(self) -> bool:
        if self.opcode in _SET_FLAGS_FAMILIES:
            return (self.flag0, self.flag1)[params.SET_FLAGS_FLAG_IDX]
        return False

    @property
    def swap_operands(self) -> bool:
        if self.opcode in (Opcode.SUB, Opcode.DIV, Opcode.SHIFT):
            return (self.flag0, self.flag1)[params.SWAP_OPERANDS_FLAG_IDX]
        if self.opcode is Opcode.PTR:
            # ptr has no set_flags bit, so its swap lives in bit 0
            return self.flag0
        return False


_SET_FLAGS_FAMILIES = frozenset({
    Opcode.ADD, Opcode.SUB, Opcode.MUL, Opcode.DIV, Opcode.SHIFT, Opcode.BINOP,
})

# (family, sub-enum or None, src0 mode group, dst0 mode group, #flag combos)
_FAMILY_SPECS = (
    (Opcode.NOP, None, SRC_MODES_FULL, DST_MODES_FULL, 1),
    (Opcode.ADD, None, SRC_MODES_FULL, DST_MODES_FULL, 2),      # set_flags
    (Opcode.SUB, None, SRC_MODES_FULL, DST_MODES_FULL, 4),      # set_flags, swap
    (Opcode.MUL, None, SRC_MODES_FULL, DST_MODES_FULL, 2),
    (Opcode.DIV, None, SRC_MODES_FULL, DST_MODES_FULL, 4),
    (Opcode.JUMP, None, SRC_MODES_FULL, DST_MODES_REG_ONLY, 1),
    (Opcode.CONTEXT, ContextOp, SRC_MODES_REG_ONLY, DST_MODES_REG_ONLY, 1),
    (Opcode.SHIFT, ShiftOp, SRC_MODES_FULL, DST_MODES_FULL, 4),
    (Opcode.BINOP, BinopOp, SRC_MODES_FULL, DST_MODES_FULL, 2),
    (Opcode.PTR, PtrOp, SRC_MODES_FULL, DST_MODES_FULL, 2),     # swap only
    (Opcode.NEAR_CALL, None, SRC_MODES_REG_ONLY, DST_MODES_REG_ONLY, 1),
    (Opcode.LOG, LogOp, SRC_MODES_REG_ONLY, DST_MODES_REG_ONLY, 2),  # first msg
    (Opcode.FAR_CALL, FarCallOp, SRC_MODES_REG_ONLY, DST_MODES_REG_ONLY, 4),
    (Opcode.RET, RetOp, SRC_MODES_REG_ONLY, DST_MODES_REG_ONLY, 2),  # to_label
    (Opcode.UMA, UMAOp, SRC_MODES_REG_OR_IMM, DST_MODES_REG_ONLY, 2),
    (Opcode.INVALID, None, SRC_MODES_REG_ONLY, DST_MODES_REG_ONLY, 1),
)

_KERNEL_ONLY = {
    (Opcode.CONTEXT, ContextOp.SET_CONTEXT_U128),
    (Opcode.CONTEXT, ContextOp.SET_ERGS_PER_PUBDATA_BYTE),
    (Opcode.CONTEXT, ContextOp.INCREMENT_TX_NUMBER),
    (Opcode.LOG, LogOp.PRECOMPILE_CALL),
    (Opcode.FAR_CALL, FarCallOp.MIMIC),
}
_STATIC_BANNED = {
    (Opcode.LOG, LogOp.STORAGE_WRITE),
    (Opcode.LOG, LogOp.EVENT),
    (Opcode.LOG, LogOp.TO_L1_MESSAGE),
    (Opcode.CONTEXT, ContextOp.SET_CONTEXT_U128),
}
_SRC0_PTR_OK = {
    (Opcode.PTR, PtrOp.ADD), (Opcode.PTR, PtrOp.SUB),
    (Opcode.PTR, PtrOp.PACK), (Opcode.PTR, PtrOp.SHRINK),
    (Opcode.RET, RetOp.OK), (Opcode.RET, RetOp.REVERT), (Opcode.RET, RetOp.PANIC),
    (Opcode.FAR_CALL, FarCallOp.NORMAL), (Opcode.FAR_CALL, FarCallOp.DELEGATE),
    (Opcode.FAR_CALL, FarCallOp.MIMIC),
    (Opcode.UMA, UMAOp.FAT_POINTER_READ),
}


def _price(op: Opcode, sub: int, src0: OperandMode, dst0: OperandMode) -> int:
    p = params
    if op in (Opcode.NOP, Opcode.ADD, Opcode.SUB, Opcode.MUL, Opcode.DIV,
              Opcode.JUMP, Opcode.SHIFT, Opcode.BINOP, Opcode.PTR):
        rich = src0 in MEMORY_SRC_MODES or dst0 in MEMORY_DST_MODES
        return p.RICH_ADDRESSING_OPCODE_ERGS if rich else p.AVERAGE_OPCODE_ERGS
    if op is Opcode.CONTEXT:
        return p.AVERAGE_OPCODE_ERGS
    if op is Opcode.LOG:
        return {
            LogOp.STORAGE_READ: p.STORAGE_READ_IO_PRICE,
            LogOp.STORAGE_WRITE: p.STORAGE_WRITE_IO_PRICE,
            LogOp.EVENT: p.EVENT_IO_PRICE,
            LogOp.TO_L1_MESSAGE: p.L1_MESSAGE_IO_PRICE,
            LogOp.PRECOMPILE_CALL: p.PRECOMPILE_CALL_BASE_PRICE,
        }[LogOp(sub)]
    if op is Opcode.NEAR_CALL:
        return p.NEAR_CALL_ERGS
    if op is Opcode.FAR_CALL:
        return p.FAR_CALL_ERGS
    if op is Opcode.RET:
        return p.RET_ERGS
    if op is Opcode.UMA:
        return p.UMA_ERGS
    if op is Opcode.INVALID:
        return p.INVALID_OPCODE_ERGS
    raise AssertionError(op)


def _synthesize() -> list[OpcodeVariant]:
    variants: list[OpcodeVariant] = []
    for op, sub_enum, src_modes, dst_modes, n_flag_combos in _FAMILY_SPECS:
        subs = list(sub_enum) if sub_enum is not None else [0]
        for sub in subs:
            sub_val = int(sub)
            for src0 in src_modes:
                for dst0 in dst_modes:
                    for combo in range(n_flag_combos):
                        flag0 = bool(combo & 1)
                        flag1 = bool(combo & 2)
                        key = (op, sub)
                        variants.append(OpcodeVariant(
                            index=len(variants),
                            opcode=op,
                            sub=sub_val,
                            src0_mode=src0,
                            dst0_mode=dst0,
                            flag0=flag0,
                            flag1=flag1,
                            price=_price(op, sub_val, src0, dst0),
                            requires_kernel=key in _KERNEL_ONLY,
                            allowed_in_static=key not in _STATIC_BANNED,
                            src0_can_be_pointer=key in _SRC0_PTR_OK,
                            src1_can_be_pointer=op is Opcode.PTR,
                            is_explicit_panic=op is Opcode.INVALID,
                        ))
    assert len(variants) < (1 << 11), len(variants)
    # verified price corrections flow into the EXECUTED table here (and
    # into the pinned expected table via ergs_prices.expected_price_table),
    # so a documented divergence changes every engine — golden, jnp, fused,
    # and the native oracle (gen_tables.py reads these variants) — in one
    # data edit.  tests/test_isa.py asserts the two tables stay equal.
    from .ergs_prices import DOCUMENTED_DIVERGENCES

    for idx, (price, _why) in DOCUMENTED_DIVERGENCES.items():
        variants[idx] = dataclasses.replace(variants[idx], price=price)
    return variants


VARIANTS: tuple[OpcodeVariant, ...] = tuple(_synthesize())
NUM_VARIANTS = len(VARIANTS)

#: reverse lookup: (opcode, sub, src0_mode, dst0_mode, flag0, flag1) -> index
_VARIANT_INDEX: dict[tuple, int] = {
    (v.opcode, v.sub, v.src0_mode, v.dst0_mode, v.flag0, v.flag1): v.index
    for v in VARIANTS
}


def variant_index(opcode: Opcode, sub: int = 0,
                  src0_mode: OperandMode | None = None,
                  dst0_mode: OperandMode | None = None,
                  flag0: bool = False, flag1: bool = False) -> int:
    """Find the table index for a fully specified variant."""
    if src0_mode is None:
        src0_mode = _default_src_mode(opcode)
    if dst0_mode is None:
        dst0_mode = _default_dst_mode(opcode)
    key = (opcode, int(sub), src0_mode, dst0_mode, bool(flag0), bool(flag1))
    if key not in _VARIANT_INDEX:
        raise KeyError(f"no such opcode variant: {key}")
    return _VARIANT_INDEX[key]


def _default_src_mode(opcode: Opcode) -> OperandMode:
    spec = _FAMILY_SPECS[list(Opcode).index(opcode)]
    return spec[2][0]


def _default_dst_mode(opcode: Opcode) -> OperandMode:
    spec = _FAMILY_SPECS[list(Opcode).index(opcode)]
    return spec[3][0]


# canonical masking targets (cycle.rs:187-217)
PANIC_VARIANT_INDEX = variant_index(Opcode.RET, RetOp.PANIC)
NOP_VARIANT_INDEX = variant_index(
    Opcode.NOP, 0, OperandMode.FULL_REG, OperandMode.FULL_REG)
INVALID_VARIANT_INDEX = variant_index(Opcode.INVALID)


@lru_cache(maxsize=1)
def table_arrays() -> dict[str, np.ndarray]:
    """The variant table as packed NumPy arrays for device-side gather.

    Indices beyond NUM_VARIANTS alias the INVALID entry (is_explicit_panic),
    matching the reference's treatment of undefined variant encodings.
    """
    n = 1 << 11
    inv = VARIANTS[INVALID_VARIANT_INDEX]

    def col(getter, dtype):
        out = np.full(n, getter(inv), dtype=dtype)
        for v in VARIANTS:
            out[v.index] = getter(v)
        return out

    def packed(v: OpcodeVariant) -> int:
        """All decode properties in one u32 (device-side single-lookup)."""
        return (int(v.opcode)
                | (v.sub << 4)
                | (int(v.src0_mode) << 8)
                | (int(v.dst0_mode) << 12)
                | (int(v.set_flags) << 15)
                | (int(v.swap_operands) << 16)
                | (int(v.flag0) << 17)
                | (int(v.flag1) << 18)
                | (int(v.requires_kernel) << 19)
                | (int(v.allowed_in_static) << 20)
                | (int(v.src0_can_be_pointer) << 21)
                | (int(v.src1_can_be_pointer) << 22)
                | (int(v.is_explicit_panic) << 23))

    return {
        "packed": col(packed, np.uint32),
        "opcode": col(lambda v: int(v.opcode), np.int32),
        "sub": col(lambda v: v.sub, np.int32),
        "src0_mode": col(lambda v: int(v.src0_mode), np.int32),
        "dst0_mode": col(lambda v: int(v.dst0_mode), np.int32),
        "price": col(lambda v: v.price, np.uint32),
        "set_flags": col(lambda v: v.set_flags, np.bool_),
        "swap_operands": col(lambda v: v.swap_operands, np.bool_),
        "flag0": col(lambda v: v.flag0, np.bool_),
        "flag1": col(lambda v: v.flag1, np.bool_),
        "requires_kernel": col(lambda v: v.requires_kernel, np.bool_),
        "allowed_in_static": col(lambda v: v.allowed_in_static, np.bool_),
        "src0_can_be_pointer": col(lambda v: v.src0_can_be_pointer, np.bool_),
        "src1_can_be_pointer": col(lambda v: v.src1_can_be_pointer, np.bool_),
        "is_explicit_panic": col(lambda v: v.is_explicit_panic, np.bool_),
    }


@lru_cache(maxsize=1)
def decode_consts() -> dict[str, np.ndarray]:
    """Per-family decode constants for arithmetic (table-free) decoding.

    The synthesis loop lays variants out with regular strides:
        index = family_start
              + (((sub * n_src + src_i) * n_dst) + dst_i) * n_flags + combo
    so the device can invert it with div/mod instead of a table gather.
    `src_base`/`dst_base` exploit that every mode group is a contiguous run
    of OperandMode values.
    """
    starts = np.zeros(16, dtype=np.uint32)
    n_src = np.ones(16, dtype=np.uint32)
    n_dst = np.ones(16, dtype=np.uint32)
    n_flags = np.ones(16, dtype=np.uint32)
    src_base = np.zeros(16, dtype=np.uint32)
    dst_base = np.zeros(16, dtype=np.uint32)
    pos = 0
    for op, sub_enum, src_modes, dst_modes, combos in _FAMILY_SPECS:
        subs = len(list(sub_enum)) if sub_enum is not None else 1
        starts[int(op)] = pos
        n_src[int(op)] = len(src_modes)
        n_dst[int(op)] = len(dst_modes)
        n_flags[int(op)] = combos
        src_base[int(op)] = int(src_modes[0])
        dst_base[int(op)] = int(dst_modes[0])
        # sanity: each mode group is contiguous in OperandMode values
        assert [int(m) for m in src_modes] ==             list(range(int(src_modes[0]), int(src_modes[0]) + len(src_modes)))
        assert [int(m) for m in dst_modes] ==             list(range(int(dst_modes[0]), int(dst_modes[0]) + len(dst_modes)))
        pos += subs * len(src_modes) * len(dst_modes) * combos
    assert pos == NUM_VARIANTS
    return {
        "start": starts, "n_src": n_src, "n_dst": n_dst, "n_flags": n_flags,
        "src_base": src_base, "dst_base": dst_base,
    }


def get_variant(index: int) -> OpcodeVariant:
    """Decode-table lookup; out-of-range indices resolve to INVALID."""
    if 0 <= index < NUM_VARIANTS:
        return VARIANTS[index]
    return VARIANTS[INVALID_VARIANT_INDEX]
