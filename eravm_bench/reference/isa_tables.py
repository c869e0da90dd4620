"""The reference's decode and price tables, worked out here from the EraVM
v1.4.1 instruction set as the repo pins it, and written out as the C header
that the oracle includes (`tables_text`).

`zkevm_opcode_defs` v1.4.1, the crate that defines EraVM's opcode table and
its ergs prices, is not published with the reference VM; the repo pins the
surface the VM consumes (SURVEY.md section 2.9) and grades each value. This
file writes that surface down a second time, as data, with no code of the
port behind it:

- the variant index space: the sixteen opcode families in the crate's
  order, each enumerated as (sub-op, src0 mode, dst0 mode, flag bits), the
  flag bits fastest (`FAMILIES`); indices past the last variant decode as
  the invalid opcode, whose panic is explicit;
- the operand modes (`SRC_FULL`, `SRC_REG_OR_IMM`, `DST_FULL`, ...): the
  crate's `Operand::{RegOnly, RegOrImm, Full}` flattened into one number;
- the properties of each (family, sub-op): kernel only, banned in a static
  frame, src0 may carry a pointer (`KERNEL_ONLY`, `STATIC_BANNED`,
  `SRC0_POINTER`);
- the ergs price of each class (`PRICE`): 4 ergs a cycle
  (VM_CYCLE_COST_IN_ERGS), one more a RAM permutation, and the IO prices.

Each packed entry holds, from bit 0: the family (4 bits), the sub-op (4),
the src0 mode (4), the dst0 mode (3), set-flags, swap-operands, flag bit 0,
flag bit 1, kernel only, allowed in a static frame, src0 may be a pointer,
src1 may be a pointer, and explicit panic, as the oracle's `unpack` reads
them.
"""

from __future__ import annotations

# operand modes
REG_ONLY, RI_REG, RI_IMM, F_REG, F_PUSHPOP, F_OFFSET, F_ABS, F_IMM, \
    F_CODE = range(9)
SRC_FULL = (F_REG, F_PUSHPOP, F_OFFSET, F_ABS, F_IMM, F_CODE)
SRC_REG_OR_IMM = (RI_REG, RI_IMM)
DST_FULL = (F_REG, F_PUSHPOP, F_OFFSET, F_ABS)
ONLY_REG = (REG_ONLY,)
#: modes that read a source or write a destination in memory
MEMORY_SRC = frozenset({F_PUSHPOP, F_OFFSET, F_ABS, F_CODE})
MEMORY_DST = frozenset({F_PUSHPOP, F_OFFSET, F_ABS})

# families (the crate's Opcode enum order)
NOP, ADD, SUB, MUL, DIV, JUMP, CONTEXT, SHIFT, BINOP, PTR, NEAR_CALL, LOG, \
    FAR_CALL, RET, UMA, INVALID = range(16)

#: (family, sub-ops, src0 modes, dst0 modes, flag combinations, what the
#: flag bits mean): set-flags is bit 0 where the family has it, swap bit 1
#: (bit 0 for ptr, which sets no flags)
FAMILIES = (
    (NOP, 1, SRC_FULL, DST_FULL, 1, ""),
    (ADD, 1, SRC_FULL, DST_FULL, 2, "set"),
    (SUB, 1, SRC_FULL, DST_FULL, 4, "set,swap"),
    (MUL, 1, SRC_FULL, DST_FULL, 2, "set"),
    (DIV, 1, SRC_FULL, DST_FULL, 4, "set,swap"),
    (JUMP, 1, SRC_FULL, ONLY_REG, 1, ""),
    (CONTEXT, 10, ONLY_REG, ONLY_REG, 1, ""),
    (SHIFT, 4, SRC_FULL, DST_FULL, 4, "set,swap"),
    (BINOP, 3, SRC_FULL, DST_FULL, 2, "set"),
    (PTR, 4, SRC_FULL, DST_FULL, 2, "swap0"),
    (NEAR_CALL, 1, ONLY_REG, ONLY_REG, 1, ""),
    (LOG, 5, ONLY_REG, ONLY_REG, 2, ""),
    (FAR_CALL, 3, ONLY_REG, ONLY_REG, 4, ""),
    (RET, 3, ONLY_REG, ONLY_REG, 2, ""),
    (UMA, 5, SRC_REG_OR_IMM, ONLY_REG, 2, ""),
    (INVALID, 1, ONLY_REG, ONLY_REG, 1, ""),
)

# sub-ops named where a property or a price depends on them
CTX_SET_U128, CTX_SET_ERGS_PER_PUBDATA, CTX_INCREMENT_TX = 7, 8, 9
LOG_SREAD, LOG_SWRITE, LOG_EVENT, LOG_TO_L1, LOG_PRECOMPILE = range(5)
FAR_NORMAL, FAR_DELEGATE, FAR_MIMIC = range(3)
RET_OK, RET_REVERT, RET_PANIC = range(3)
UMA_FAT_POINTER_READ = 4

KERNEL_ONLY = frozenset({
    (CONTEXT, CTX_SET_U128), (CONTEXT, CTX_SET_ERGS_PER_PUBDATA),
    (CONTEXT, CTX_INCREMENT_TX), (LOG, LOG_PRECOMPILE),
    (FAR_CALL, FAR_MIMIC)})
STATIC_BANNED = frozenset({
    (LOG, LOG_SWRITE), (LOG, LOG_EVENT), (LOG, LOG_TO_L1),
    (CONTEXT, CTX_SET_U128)})
SRC0_POINTER = frozenset(
    {(PTR, s) for s in range(4)} | {(RET, s) for s in range(3)}
    | {(FAR_CALL, s) for s in range(3)} | {(UMA, UMA_FAT_POINTER_READ)})

# ergs (isa/params.py's pins)
CYCLE, RAM = 4, 1
PRICE = {
    "average": CYCLE + RAM,                 # 5: registers and immediates
    "rich": CYCLE + 2 * RAM,                # 6: a memory operand
    "sread": 150, "swrite": 250, "event": 25, "to_l1": 100,
    "precompile": 10,
    "near_call": CYCLE + RAM + 20,          # 25: a call-like opcode
    "far_call": 2 * CYCLE + RAM + 150 + 20,   # 179
    "ret": CYCLE + RAM,                     # 5
    "uma": CYCLE + 5 * RAM,                 # 9
    "invalid": 2**32 - 1,
}
TABLE_SIZE = 1 << 11


def price_class(family: int, sub: int, src0: int, dst0: int) -> str:
    if family in (NOP, ADD, SUB, MUL, DIV, JUMP, SHIFT, BINOP, PTR):
        return "rich" if src0 in MEMORY_SRC or dst0 in MEMORY_DST \
            else "average"
    if family == CONTEXT:
        return "average"
    if family == LOG:
        return ("sread", "swrite", "event", "to_l1", "precompile")[sub]
    return {NEAR_CALL: "near_call", FAR_CALL: "far_call", RET: "ret",
            UMA: "uma", INVALID: "invalid"}[family]


def variants() -> list[dict]:
    """Every variant in index order, with its properties and price."""
    out = []
    for family, n_sub, srcs, dsts, n_flags, flag_bits in FAMILIES:
        for sub in range(n_sub):
            for src0 in srcs:
                for dst0 in dsts:
                    for combo in range(n_flags):
                        f0, f1 = combo & 1, (combo >> 1) & 1
                        key = (family, sub)
                        out.append({
                            "family": family, "sub": sub, "src0": src0,
                            "dst0": dst0, "flag0": f0, "flag1": f1,
                            "set_flags": f0 if "set" in flag_bits else 0,
                            "swap": (f1 if "swap" in flag_bits.split(",")
                                     else f0 if flag_bits == "swap0" else 0),
                            "kernel": int(key in KERNEL_ONLY),
                            "static_ok": int(key not in STATIC_BANNED),
                            "src0_ptr": int(key in SRC0_POINTER),
                            "src1_ptr": int(family == PTR),
                            "panic": int(family == INVALID),
                            "price": PRICE[price_class(family, sub, src0,
                                                       dst0)]})
    assert len(out) <= TABLE_SIZE
    return out


def packed(v: dict) -> int:
    return (v["family"] | v["sub"] << 4 | v["src0"] << 8 | v["dst0"] << 12
            | v["set_flags"] << 15 | v["swap"] << 16 | v["flag0"] << 17
            | v["flag1"] << 18 | v["kernel"] << 19 | v["static_ok"] << 20
            | v["src0_ptr"] << 21 | v["src1_ptr"] << 22 | v["panic"] << 23)


def tables() -> dict:
    """The packed table and the prices over the whole 11-bit index space,
    and the panic and nop variants' indices."""
    vs = variants()
    invalid = next(v for v in vs if v["family"] == INVALID)
    full = vs + [invalid] * (TABLE_SIZE - len(vs))
    index = {(v["family"], v["sub"], v["src0"], v["dst0"], v["flag0"],
              v["flag1"]): i for i, v in enumerate(vs)}
    return {"packed": [packed(v) for v in full],
            "price": [v["price"] for v in full],
            "panic": index[(RET, RET_PANIC, REG_ONLY, REG_ONLY, 0, 0)],
            "nop": index[(NOP, 0, F_REG, F_REG, 0, 0)],
            "n_variants": len(vs)}


def tables_text() -> str:
    """The C header the oracle includes."""
    t = tables()
    return "\n".join([
        "// written by eravm_bench/reference/isa_tables.py",
        "#include <stdint.h>",
        f"static const uint32_t VARIANT_PACKED[{TABLE_SIZE}] = {{",
        ",".join(map(str, t["packed"])) + "};",
        f"static const uint32_t VARIANT_PRICE[{TABLE_SIZE}] = {{",
        ",".join(map(str, t["price"])) + "};",
        f"static const uint32_t PANIC_VARIANT = {t['panic']};",
        f"static const uint32_t NOP_VARIANT = {t['nop']};", ""])
