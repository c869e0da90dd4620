"""A minimal EraVM assembler for building test programs.

Not part of the reference crate's surface (the reference has no assembler);
this exists so conformance tests can express programs readably instead of as
hand-packed u64 words.  Syntax (one instruction per line, `;` comments):

    label:
    add      r1, r2, r3          ; r3 = r1 + r2
    add!     r1, r2, r3          ; ... and set flags
    sub.s!   r1, r2, r3          ; swapped operands: r3 = r2 - r1
    add      42, r0, r1          ; imm16 as src0
    add      stack[r1+2], r0, r2 ; absolute-on-stack src0
    add      r1, r0, stack+=[1]  ; push-like dst0
    add      stack-=[1], r0, r5  ; pop-like src0
    add      stack-[1], r0, r5   ; sp-relative read (sp unchanged)
    add      code[7], r0, r5     ; constant from code page
    jump     @loop               ; jump to label (imm16 src0)
    jump.if_eq @done
    mul      r1, r2, r3, r4      ; dst1 gets the high word
    ctx.this r1
    ctx.set_u128 r1
    shl!     r1, r2, r3
    near_call r1, @fn, @handler
    log.sread  r1, r2
    log.swrite r1, r2
    log.event  r1, r2
    log.precompile r1, r2, r3
    far_call r1, r2, @handler
    ld.h     r1, r2              ; uma heap read
    ld.h.inc r1, r2, r3          ; ... dst1 = incremented src0
    st.h     r1, r2              ; uma heap write
    ld.ptr   r1, r2              ; fat pointer read
    ret      r1
    revert   r1
    panic
"""

from __future__ import annotations

import re

from . import params
from .encoding import Condition, code_word_from_instructions, encode
from .opcodes import (
    BinopOp, ContextOp, FarCallOp, LogOp, Opcode, OperandMode, PtrOp, RetOp,
    ShiftOp, UMAOp, variant_index,
)

_CONDITIONS = {
    "if_gt": Condition.GT, "if_lt": Condition.LT, "if_eq": Condition.EQ,
    "if_ge": Condition.GE, "if_le": Condition.LE, "if_ne": Condition.NE,
    "if_gt_or_lt": Condition.GT_OR_LT,
}

# mnemonic -> (opcode family, sub, operand signature)
# signatures: s0/s1 = sources, d0/d1 = dests, eh = exception handler imm,
#             dst_label = imm0 call target
_MNEMONICS: dict[str, tuple[Opcode, int, tuple[str, ...]]] = {
    "nop": (Opcode.NOP, 0, ()),
    "add": (Opcode.ADD, 0, ("s0", "s1", "d0")),
    "sub": (Opcode.SUB, 0, ("s0", "s1", "d0")),
    "mul": (Opcode.MUL, 0, ("s0", "s1", "d0", "d1")),
    "div": (Opcode.DIV, 0, ("s0", "s1", "d0", "d1")),
    "jump": (Opcode.JUMP, 0, ("s0",)),
    "jmp": (Opcode.JUMP, 0, ("s0",)),
    "shl": (Opcode.SHIFT, ShiftOp.SHL, ("s0", "s1", "d0")),
    "shr": (Opcode.SHIFT, ShiftOp.SHR, ("s0", "s1", "d0")),
    "rol": (Opcode.SHIFT, ShiftOp.ROL, ("s0", "s1", "d0")),
    "ror": (Opcode.SHIFT, ShiftOp.ROR, ("s0", "s1", "d0")),
    "xor": (Opcode.BINOP, BinopOp.XOR, ("s0", "s1", "d0")),
    "and": (Opcode.BINOP, BinopOp.AND, ("s0", "s1", "d0")),
    "or": (Opcode.BINOP, BinopOp.OR, ("s0", "s1", "d0")),
    "ptr.add": (Opcode.PTR, PtrOp.ADD, ("s0", "s1", "d0")),
    "ptr.sub": (Opcode.PTR, PtrOp.SUB, ("s0", "s1", "d0")),
    "ptr.pack": (Opcode.PTR, PtrOp.PACK, ("s0", "s1", "d0")),
    "ptr.shrink": (Opcode.PTR, PtrOp.SHRINK, ("s0", "s1", "d0")),
    "ctx.this": (Opcode.CONTEXT, ContextOp.THIS, ("d0",)),
    "ctx.caller": (Opcode.CONTEXT, ContextOp.CALLER, ("d0",)),
    "ctx.code_addr": (Opcode.CONTEXT, ContextOp.CODE_ADDRESS, ("d0",)),
    "ctx.meta": (Opcode.CONTEXT, ContextOp.META, ("d0",)),
    "ctx.ergs": (Opcode.CONTEXT, ContextOp.ERGS_LEFT, ("d0",)),
    "ctx.sp": (Opcode.CONTEXT, ContextOp.SP, ("d0",)),
    "ctx.get_u128": (Opcode.CONTEXT, ContextOp.GET_CONTEXT_U128, ("d0",)),
    "ctx.set_u128": (Opcode.CONTEXT, ContextOp.SET_CONTEXT_U128, ("s0",)),
    "ctx.set_pubdata": (Opcode.CONTEXT, ContextOp.SET_ERGS_PER_PUBDATA_BYTE, ("s0",)),
    "ctx.inc_tx": (Opcode.CONTEXT, ContextOp.INCREMENT_TX_NUMBER, ()),
    "near_call": (Opcode.NEAR_CALL, 0, ("s0", "dst_label", "eh")),
    "log.sread": (Opcode.LOG, LogOp.STORAGE_READ, ("s0", "d0")),
    "log.swrite": (Opcode.LOG, LogOp.STORAGE_WRITE, ("s0", "s1")),
    "log.event": (Opcode.LOG, LogOp.EVENT, ("s0", "s1")),
    "log.to_l1": (Opcode.LOG, LogOp.TO_L1_MESSAGE, ("s0", "s1")),
    "log.precompile": (Opcode.LOG, LogOp.PRECOMPILE_CALL, ("s0", "s1", "d0")),
    "far_call": (Opcode.FAR_CALL, FarCallOp.NORMAL, ("s0", "s1", "eh")),
    "delegate_call": (Opcode.FAR_CALL, FarCallOp.DELEGATE, ("s0", "s1", "eh")),
    "mimic_call": (Opcode.FAR_CALL, FarCallOp.MIMIC, ("s0", "s1", "eh")),
    "ret": (Opcode.RET, RetOp.OK, ("s0",)),
    "revert": (Opcode.RET, RetOp.REVERT, ("s0",)),
    "panic": (Opcode.RET, RetOp.PANIC, ()),
    "ld.h": (Opcode.UMA, UMAOp.HEAP_READ, ("s0", "d0")),
    "st.h": (Opcode.UMA, UMAOp.HEAP_WRITE, ("s0", "s1")),
    "ld.ah": (Opcode.UMA, UMAOp.AUX_HEAP_READ, ("s0", "d0")),
    "st.ah": (Opcode.UMA, UMAOp.AUX_HEAP_WRITE, ("s0", "s1")),
    "ld.ptr": (Opcode.UMA, UMAOp.FAT_POINTER_READ, ("s0", "d0")),
}

_REG_RE = re.compile(r"^r(\d+)$")
_STACK_RE = re.compile(r"^(stack|code)(\+=|-=|-|=|)\[([^\]]+)\]$")


class AsmError(ValueError):
    pass


def _parse_addr_expr(expr: str, labels) -> tuple[int, int]:
    """`rN+imm` / `rN` / `imm` -> (reg, imm)."""
    expr = expr.strip()
    if "+" in expr:
        reg_s, imm_s = expr.split("+", 1)
        m = _REG_RE.match(reg_s.strip())
        if not m:
            raise AsmError(f"bad address expr {expr!r}")
        return int(m.group(1)), _int_or_label(imm_s.strip(), labels)
    m = _REG_RE.match(expr)
    if m:
        return int(m.group(1)), 0
    return 0, _int_or_label(expr, labels)


def _int_or_label(tok: str, labels) -> int:
    if tok.startswith("@"):
        name = tok[1:]
        if labels is None:
            return 0
        if name not in labels:
            raise AsmError(f"undefined label {name!r}")
        return labels[name]
    return int(tok, 0)


def _classify_operand(tok: str, labels) -> tuple[str, OperandMode | None, int, int]:
    """-> (kind, full_mode, reg, imm); kind in {reg, imm, mem}."""
    tok = tok.strip()
    m = _REG_RE.match(tok)
    if m:
        idx = int(m.group(1))
        if not 0 <= idx <= params.REGISTERS_COUNT:
            raise AsmError(f"register out of range: {tok}")
        return "reg", None, idx, 0
    m = _STACK_RE.match(tok)
    if m:
        space, sigil, expr = m.groups()
        reg, imm = _parse_addr_expr(expr, labels)
        if space == "code":
            return "mem", OperandMode.FULL_CODE_PAGE, reg, imm
        mode = {
            "+=": OperandMode.FULL_STACK_PUSH_POP,
            "-=": OperandMode.FULL_STACK_PUSH_POP,
            "-": OperandMode.FULL_STACK_OFFSET,
            "=": OperandMode.FULL_ABS_STACK,
            "": OperandMode.FULL_ABS_STACK,
        }[sigil]
        return "mem", mode, reg, imm
    # immediate (number or @label)
    return "imm", None, 0, _int_or_label(tok, labels)


def _parse_source(source: str):
    """-> (instruction lines, labels, data words).

    `.word <int>` lines define 256-bit constants appended to the code pages
    after the instruction stream; a label on a `.word` resolves to the WORD
    index usable as `code[@name]`.
    """
    idx = 0
    stripped: list[str] = []
    labels: dict[str, int] = {}
    data_entries: list[tuple[str | None, int]] = []
    pending_label: str | None = None
    for raw in source.splitlines():
        line = raw.split(";", 1)[0].strip()
        if not line:
            continue
        while ":" in line and _looks_like_label(line):
            name, _, rest = line.partition(":")
            pending_label = name.strip()
            labels[pending_label] = idx  # provisional: instruction index
            line = rest.strip()
        if not line:
            continue
        if line.startswith(".word"):
            value = int(line.split(None, 1)[1], 0)
            assert 0 <= value < (1 << 256)
            data_entries.append((pending_label, value))
            if pending_label is not None:
                del labels[pending_label]  # re-bound to a data index below
            pending_label = None
            continue
        pending_label = None
        stripped.append(line)
        idx += 1

    n_code_words = -(-len(stripped) // params.OPCODES_PER_WORD) if stripped else 0
    data_words: list[int] = []
    for i, (name, value) in enumerate(data_entries):
        if name is not None:
            labels[name] = n_code_words + i
        data_words.append(value)
    return stripped, labels, data_words


def assemble(source: str) -> list[int]:
    """Assemble to a list of 64-bit instruction words (ignores .word data)."""
    stripped, labels, _ = _parse_source(source)
    return [_assemble_line(line, labels) for line in stripped]


def _looks_like_label(line: str) -> bool:
    head = line.split(":", 1)[0].strip()
    return bool(re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", head))


def _assemble_line(line: str, labels: dict[str, int]) -> int:
    parts = line.split(None, 1)
    mnem = parts[0]
    operand_str = parts[1] if len(parts) > 1 else ""
    operands = [o.strip() for o in operand_str.split(",") if o.strip()]

    # parse modifiers: base[.s][.inc][.if_cond][!]
    set_flags = mnem.endswith("!")
    if set_flags:
        mnem = mnem[:-1]
    tokens = mnem.split(".")
    condition = Condition.ALWAYS
    swap = False
    uma_inc = False
    first_message = False
    to_label = False
    is_static = False
    is_shard = False
    base_tokens = []
    for t in tokens:
        if t in _CONDITIONS:
            condition = _CONDITIONS[t]
        elif t == "s":
            swap = True
        elif t == "inc":
            uma_inc = True
        elif t == "first":
            first_message = True
        elif t == "to_label":
            to_label = True
        elif t == "static":
            is_static = True
        elif t == "shard":
            is_shard = True
        else:
            base_tokens.append(t)
    base = ".".join(base_tokens)
    if base not in _MNEMONICS:
        raise AsmError(f"unknown mnemonic {base!r} in {line!r}")
    op, sub, sig = _MNEMONICS[base]

    src0_reg = src1_reg = dst0_reg = dst1_reg = 0
    imm0 = imm1 = 0
    src0_mode: OperandMode | None = None
    dst0_mode: OperandMode | None = None

    # `.inc` UMA variants take an extra register for the incremented pointer:
    # reads deliver it via dst1, writes via dst0 (uma.rs:335-343, 402-419)
    if op is Opcode.UMA and uma_inc and len(operands) == len(sig) + 1:
        sig = sig + ("d0",) if UMAOp(sub) in (UMAOp.HEAP_WRITE, UMAOp.AUX_HEAP_WRITE) \
            else sig + ("d1",)
    # `ret.to_label r1, @label` carries the label in imm0
    if op is Opcode.RET and to_label and len(operands) == len(sig) + 1:
        sig = sig + ("dst_label",)
    if len(operands) != len(sig):
        # allow trailing-operand elision for eh labels
        if not (len(sig) > len(operands) and all(s in ("eh",) for s in sig[len(operands):])):
            raise AsmError(f"{base} expects {len(sig)} operands, got {len(operands)}: {line!r}")

    for spec, tok in zip(sig, operands):
        kind, mode, reg, imm = _classify_operand(tok, labels)
        if spec == "s0":
            if kind == "reg":
                src0_reg = reg
            elif kind == "imm":
                if not 0 <= imm < (1 << 16):
                    raise AsmError(f"imm16 out of range: {tok}")
                if op is Opcode.UMA:
                    src0_mode = OperandMode.REG_OR_IMM_IMM
                else:
                    src0_mode = OperandMode.FULL_IMM16
                imm0 = imm
            else:
                if mode is OperandMode.FULL_STACK_PUSH_POP and "-=[" not in tok:
                    raise AsmError(f"src0 push mode must be stack-=[..]: {tok}")
                src0_mode, src0_reg, imm0 = mode, reg, imm
        elif spec == "s1":
            if kind != "reg":
                raise AsmError(f"src1 must be a register: {tok}")
            src1_reg = reg
        elif spec == "d0":
            if kind == "reg":
                dst0_reg = reg
            elif kind == "mem":
                if mode is OperandMode.FULL_CODE_PAGE:
                    raise AsmError("cannot write to code page")
                dst0_mode, dst0_reg, imm1 = mode, reg, imm
            else:
                raise AsmError(f"dst0 cannot be an immediate: {tok}")
        elif spec == "d1":
            if kind != "reg":
                raise AsmError(f"dst1 must be a register: {tok}")
            dst1_reg = reg
        elif spec == "dst_label":
            imm0 = _int_or_label(tok, labels)
        elif spec == "eh":
            imm1 = _int_or_label(tok, labels)
            if op is Opcode.FAR_CALL:
                imm0, imm1 = imm1, 0  # far call's handler rides in imm0
        else:
            raise AssertionError(spec)

    # UMA reg-or-imm default
    if op is Opcode.UMA and src0_mode is None:
        src0_mode = OperandMode.REG_OR_IMM_REG
    # ret-to-label: `ret.to_label r1, @label`
    if op is Opcode.RET and to_label and len(operands) == 2:
        imm0 = _int_or_label(operands[1], labels)

    flag_map: dict[int, bool] = {}
    if op in (Opcode.ADD, Opcode.SUB, Opcode.MUL, Opcode.DIV, Opcode.SHIFT, Opcode.BINOP):
        flag_map[params.SET_FLAGS_FLAG_IDX] = set_flags
    if op in (Opcode.SUB, Opcode.DIV, Opcode.SHIFT):
        flag_map[params.SWAP_OPERANDS_FLAG_IDX] = swap
    if op is Opcode.PTR:
        flag_map[0] = swap
    if op is Opcode.UMA:
        flag_map[params.UMA_INCREMENT_FLAG_IDX] = uma_inc
    if op is Opcode.LOG:
        flag_map[params.FIRST_MESSAGE_FLAG_IDX] = first_message
    if op is Opcode.RET:
        flag_map[params.RET_TO_LABEL_BIT_IDX] = to_label
    if op is Opcode.FAR_CALL:
        flag_map[params.FAR_CALL_STATIC_FLAG_IDX] = is_static
        flag_map[params.FAR_CALL_SHARD_FLAG_IDX] = is_shard

    vidx = variant_index(
        op, sub,
        src0_mode=src0_mode, dst0_mode=dst0_mode,
        flag0=flag_map.get(0, False), flag1=flag_map.get(1, False),
    )
    return encode(vidx, condition, src0_reg, src1_reg, dst0_reg, dst1_reg, imm0, imm1)


def assemble_to_code_words(source: str) -> list[int]:
    """Assemble and pack into BE 32-byte code words (4 instructions each).

    Pads the instruction tail with explicit-panic encodings so a runaway pc
    traps, then appends `.word` constant data words.
    """
    from .encoding import encode as _enc
    from .opcodes import INVALID_VARIANT_INDEX

    stripped, labels, data_words = _parse_source(source)
    instructions = [_assemble_line(line, labels) for line in stripped]
    pad = _enc(INVALID_VARIANT_INDEX)
    while len(instructions) % params.OPCODES_PER_WORD:
        instructions.append(pad)
    words = [
        code_word_from_instructions(instructions[i:i + params.OPCODES_PER_WORD])
        for i in range(0, len(instructions), params.OPCODES_PER_WORD)
    ]
    return words + data_words


# ---------------------------------------------------------------------------
# Disassembler
# ---------------------------------------------------------------------------

_REV_MNEMONICS: dict[tuple, str] = {}
for _m, (_op, _sub, _sig) in _MNEMONICS.items():
    _REV_MNEMONICS.setdefault((_op, int(_sub)), _m)
_REV_MNEMONICS[(Opcode.INVALID, 0)] = "<invalid>"

_REV_CONDITIONS = {v: k for k, v in _CONDITIONS.items()}


def _fmt_src(mode: OperandMode, reg: int, imm: int) -> str:
    if mode in (OperandMode.REG_ONLY, OperandMode.REG_OR_IMM_REG,
                OperandMode.FULL_REG):
        return f"r{reg}"
    if mode in (OperandMode.REG_OR_IMM_IMM, OperandMode.FULL_IMM16):
        return str(imm)
    expr = f"r{reg}+{imm}" if reg else str(imm)
    return {
        OperandMode.FULL_STACK_PUSH_POP: f"stack-=[{expr}]",
        OperandMode.FULL_STACK_OFFSET: f"stack-[{expr}]",
        OperandMode.FULL_ABS_STACK: f"stack[{expr}]",
        OperandMode.FULL_CODE_PAGE: f"code[{expr}]",
    }[mode]


def _fmt_dst(mode: OperandMode, reg: int, imm: int) -> str:
    if mode is OperandMode.REG_ONLY or mode is OperandMode.FULL_REG:
        return f"r{reg}"
    expr = f"r{reg}+{imm}" if reg else str(imm)
    return {
        OperandMode.FULL_STACK_PUSH_POP: f"stack+=[{expr}]",
        OperandMode.FULL_STACK_OFFSET: f"stack-[{expr}]",
        OperandMode.FULL_ABS_STACK: f"stack[{expr}]",
    }[mode]


def disassemble_one(word: int) -> str:
    """64-bit instruction -> assembler syntax (best-effort round-trippable)."""
    from .encoding import parse_preliminary
    from .opcodes import get_variant

    dec, raw_idx = parse_preliminary(word)
    v = dec.variant
    base = _REV_MNEMONICS.get((v.opcode, v.sub), f"<op{int(v.opcode)}.{v.sub}>")
    mods = []
    if v.swap_operands:
        mods.append("s")
    if v.opcode is Opcode.UMA and v.flag0:
        mods.append("inc")
    if v.opcode is Opcode.LOG and v.flag0:
        mods.append("first")
    if v.opcode is Opcode.RET and v.flag0:
        mods.append("to_label")
    if v.opcode is Opcode.FAR_CALL:
        if v.flag0:
            mods.append("static")
        if v.flag1:
            mods.append("shard")
    if dec.condition is not Condition.ALWAYS:
        mods.append(_REV_CONDITIONS[dec.condition])
    mnem = ".".join([base] + mods)
    if v.set_flags:
        mnem += "!"

    _, _, sig = _MNEMONICS.get(base, (v.opcode, v.sub, ()))
    if v.opcode is Opcode.UMA and v.flag0:
        sig = sig + (("d0",) if v.sub in (1, 3) else ("d1",))
    if v.opcode is Opcode.RET and v.flag0:
        sig = sig + ("dst_label",)
    ops = []
    for spec in sig:
        if spec == "s0":
            ops.append(_fmt_src(v.src0_mode, dec.src0_reg, dec.imm0))
        elif spec == "s1":
            ops.append(f"r{dec.src1_reg}")
        elif spec == "d0":
            ops.append(_fmt_dst(v.dst0_mode, dec.dst0_reg, dec.imm1))
        elif spec == "d1":
            ops.append(f"r{dec.dst1_reg}")
        elif spec == "dst_label":
            ops.append(str(dec.imm0))
        elif spec == "eh":
            ops.append(str(dec.imm0 if v.opcode is Opcode.FAR_CALL else dec.imm1))
    return mnem + (" " + ", ".join(ops) if ops else "")


def disassemble(instructions: list[int]) -> list[str]:
    return [disassemble_one(w) for w in instructions]
