"""The golden sequential EraVM: exact cycle-level semantics + witness hooks.

This is the conformance oracle of the framework.  It mirrors, hook for hook
and timestamp for timestamp, the reference's cycle pipeline (SURVEY.md
§2.2-2.5; vm_state/cycle.rs, opcodes/execution/*), against which the batched
TPU interpreter is differentially tested.  It is deliberately *not* fast —
clarity and exactness over speed (the TPU path is the fast path; a native C++
oracle for high-volume fuzzing is planned in the runtime layer).
"""

from __future__ import annotations

import enum

from ..isa import params
from ..isa.abi import (
    FarCallABI, FatPointer, FatPointerValidationException, ForwardingMode,
    NearCallABI, PrecompileCallABI, RetABI, VersionedCodeHash,
    VmMetaParameters, erase_fat_pointer_metadata,
)
from ..isa.encoding import (
    DecodedOpcode, exception_revert_encoding, instruction_from_code_word,
    nop_encoding, parse_preliminary, split_pc,
)
from ..isa.opcodes import (
    Condition, ContextOp, FarCallOp, LogOp, Opcode, OperandMode, PtrOp, RetOp,
    ShiftOp, BinopOp, UMAOp,
)
from .decommitter import GoldenDecommitter
from .memory import GoldenMemory
from .precompiles import GoldenPrecompilesProcessor
from .queries import DecommittmentQuery, LogQuery, MemoryQuery, MemoryType
from .state import Callstack, CallStackEntry, Flags, PrimitiveValue, VmLocalState
from .storage import GoldenEventSink, GoldenStorage
from .witness import DummyTracer

U16 = (1 << 16) - 1
U32 = (1 << 32) - 1
U64 = (1 << 64) - 1
U128 = (1 << 128) - 1
U256_MASK = (1 << 256) - 1


class ErrorFlags(enum.IntFlag):
    NONE = 0
    INVALID_OPCODE = 1
    NOT_ENOUGH_ERGS = 2
    PRIVILEGED_ACCESS_NOT_FROM_KERNEL = 4
    WRITE_IN_STATIC_CONTEXT = 8
    CALLSTACK_IS_FULL = 16


class BlockProperties:
    def __init__(self, default_aa_code_hash: int = 0,
                 zkporter_is_available: bool = False) -> None:
        self.default_aa_code_hash = default_aa_code_hash
        self.zkporter_is_available = zkporter_is_available


class GoldenVm:
    """VmState equivalent: local state + the six pluggable backends."""

    def __init__(self, storage: GoldenStorage, memory: GoldenMemory,
                 event_sink: GoldenEventSink,
                 precompiles: GoldenPrecompilesProcessor,
                 decommitter: GoldenDecommitter, witness_tracer,
                 block_properties: BlockProperties) -> None:
        self.local_state = VmLocalState()
        self.storage = storage
        self.memory = memory
        self.event_sink = event_sink
        self.precompiles_processor = precompiles
        self.decommittment_processor = decommitter
        self.witness_tracer = witness_tracer
        self.block_properties = block_properties

    # ------------------------------------------------------------- helpers
    def execution_has_ended(self) -> bool:
        return self.local_state.execution_has_ended()

    def _select_register(self, idx: int) -> PrimitiveValue:
        if idx == 0:
            return PrimitiveValue.empty()
        return self.local_state.registers[idx - 1].copy()

    def _update_register(self, idx: int, value: PrimitiveValue) -> None:
        if idx > 0:
            self.local_state.registers[idx - 1] = value.copy()

    def _set_shorthand_panic(self) -> None:
        self.local_state.pending_exception = True

    def reset_flags(self) -> None:
        self.local_state.flags.reset()

    # ---------------------------------------------------- traced state access
    def read_memory(self, mcc: int, memory_type: MemoryType, page: int,
                    index: int, timestamp: int) -> MemoryQuery:
        q = self.memory.execute_partial_query(mcc, MemoryQuery(
            timestamp, memory_type, page, index, 0, False, False))
        self.witness_tracer.add_memory_query(mcc, q)
        return q

    def read_code(self, mcc: int, page: int, index: int, timestamp: int) -> MemoryQuery:
        q = self.memory.read_code_query(mcc, MemoryQuery(
            timestamp, MemoryType.CODE, page, index, 0, False, False))
        self.witness_tracer.add_memory_query(mcc, q)
        return q

    def write_memory(self, mcc: int, memory_type: MemoryType, page: int,
                     index: int, timestamp: int, value: PrimitiveValue) -> MemoryQuery:
        q = self.memory.execute_partial_query(mcc, MemoryQuery(
            timestamp, memory_type, page, index, value.value, value.is_pointer, True))
        self.witness_tracer.add_memory_query(mcc, q)
        return q

    def access_storage(self, mcc: int, query: LogQuery) -> LogQuery:
        query = self.storage.execute_partial_query(mcc, query)
        if not query.rw_flag:
            query = query.with_(written_value=query.read_value)
        self.witness_tracer.add_log_query(mcc, query)
        return query

    def emit_event(self, mcc: int, query: LogQuery) -> None:
        self.event_sink.add_partial_query(mcc, query)
        self.witness_tracer.add_log_query(mcc, query)

    def refund_for_partial_query(self, mcc: int, partial_query: LogQuery):
        assert partial_query.rw_flag
        refund = self.storage.estimate_refunds_for_write(mcc, partial_query)
        self.witness_tracer.record_refund_for_query(mcc, partial_query, refund)
        return refund

    def decommit(self, mcc: int, code_hash: int, candidate_page: int,
                 timestamp: int) -> DecommittmentQuery:
        partial = DecommittmentQuery(code_hash, timestamp, candidate_page, 0, False)
        query, words = self.decommittment_processor.decommit_into_memory(
            mcc, partial, self.memory)
        if words is not None:
            self.witness_tracer.add_decommittment(mcc, query, words)
        return query

    def call_precompile(self, mcc: int, query: LogQuery) -> None:
        self.witness_tracer.add_log_query(mcc, query)
        result = self.precompiles_processor.execute_precompile(mcc, query, self.memory)
        if result is not None:
            mem_in, mem_out, round_witness = result
            self.witness_tracer.add_precompile_call_result(
                mcc, query, mem_in, mem_out, round_witness)

    def start_frame(self, mcc: int, entry: CallStackEntry) -> None:
        ts = self.local_state.timestamp
        self.storage.start_frame(ts)
        self.event_sink.start_frame(ts)
        self.precompiles_processor.start_frame()
        self.witness_tracer.start_new_execution_context(
            mcc, self.local_state.callstack.current, entry)
        self.local_state.callstack.push_entry(entry)

    def finish_frame(self, mcc: int, panicked: bool) -> CallStackEntry:
        ts = self.local_state.timestamp
        self.storage.finish_frame(ts, panicked)
        self.event_sink.finish_frame(panicked, ts)
        self.precompiles_processor.finish_frame(panicked)
        self.witness_tracer.finish_execution_context(mcc, panicked)
        return self.local_state.callstack.pop_entry()

    def _perform_dst0_update(self, mcc: int, value: PrimitiveValue,
                             location, dst0_reg: int) -> None:
        if location is not None:
            mem_type, page, index = location
            self.write_memory(mcc, mem_type, page, index,
                              self.local_state.timestamp_for_dst_write(), value)
        else:
            self._update_register(dst0_reg, value)

    def push_bootloader_context(self, mcc: int, entry: CallStackEntry) -> None:
        """Carve ergs from the root frame and open the first global frame
        (vm_state/helpers.rs:289-316)."""
        root = self.local_state.callstack.current
        assert root.ergs_remaining >= entry.ergs_remaining
        root.ergs_remaining -= entry.ergs_remaining
        self.start_frame(mcc, entry)
        self.memory.start_global_frame(
            params.UNMAPPED_PAGE, entry.base_memory_page, FatPointer.empty(),
            self.local_state.timestamp)

    # =====================================================================
    # decode stage (cycle.rs:19-236)
    # =====================================================================
    def _read_and_decode(self, tracer=None):
        ls = self.local_state
        self.witness_tracer.start_new_execution_cycle(ls)
        if tracer is not None and tracer.CALL_BEFORE_DECODING:
            tracer.before_decoding(ls, self.memory)

        delayed: dict = {"previous_code_memory_page": ls.callstack.current.code_page}

        execution_has_ended = ls.execution_has_ended()
        pending_exception = ls.pending_exception
        pc = ls.callstack.current.pc
        code_page = ls.callstack.current.code_page
        code_pages_are_different = code_page != ls.previous_code_memory_page
        super_pc, sub_pc = split_pc(pc)

        if not execution_has_ended and not pending_exception:
            if code_pages_are_different or ls.previous_super_pc != super_pc:
                q = self.read_code(ls.monotonic_cycle_counter, code_page, super_pc,
                                   ls.timestamp_for_code_or_src_read())
                delayed["previous_code_word"] = q.value
                delayed["previous_super_pc"] = super_pc
                raw = instruction_from_code_word(q.value, sub_pc)
            else:
                raw = instruction_from_code_word(ls.previous_code_word, sub_pc)
        elif pending_exception:
            assert not execution_has_ended
            delayed["pending_exception"] = False
            delayed["previous_super_pc"] = super_pc
            raw = exception_revert_encoding()
        else:
            raw = nop_encoding()

        skip_cycle = execution_has_ended

        error_flags = ErrorFlags.NONE
        decoded, raw_variant_idx = parse_preliminary(raw)

        if decoded.variant.is_explicit_panic:
            error_flags |= ErrorFlags.INVALID_OPCODE

        ergs_cost = 0 if skip_cycle else decoded.variant.price
        ergs_remaining = ls.callstack.current.ergs_remaining - ergs_cost
        if ergs_remaining < 0:
            ergs_remaining = 0
            error_flags |= ErrorFlags.NOT_ENOUGH_ERGS
        delayed["ergs_remaining"] = ergs_remaining

        cur = ls.callstack.current
        if decoded.variant.requires_kernel and not cur.is_kernel_mode():
            error_flags |= ErrorFlags.PRIVILEGED_ACCESS_NOT_FROM_KERNEL
        if not decoded.variant.allowed_in_static and cur.is_static:
            error_flags |= ErrorFlags.WRITE_IN_STATIC_CONTEXT
        if ls.callstack_is_full():
            error_flags |= ErrorFlags.CALLSTACK_IS_FULL

        masked_into_panic = error_flags != ErrorFlags.NONE
        if masked_into_panic:
            decoded.mask_into_panic()

        f = ls.flags
        condition_met = {
            Condition.ALWAYS: True,
            Condition.GT: f.greater_than,
            Condition.LT: f.overflow_or_less_than,
            Condition.EQ: f.equality,
            Condition.GE: f.greater_than or f.equality,
            Condition.LE: f.overflow_or_less_than or f.equality,
            Condition.NE: not f.equality,
            Condition.GT_OR_LT: f.greater_than or f.overflow_or_less_than,
        }[decoded.condition]
        if not condition_met and not masked_into_panic:
            decoded.mask_into_nop()

        if tracer is not None and tracer.CALL_AFTER_DECODING:
            from .tracing import AfterDecodingData
            tracer.after_decoding(ls, AfterDecodingData(
                raw_opcode_unmasked=raw,
                opcode_masked=decoded,
                error_flags_accumulated=error_flags,
                resolved_condition=condition_met,
                did_skip_cycle=skip_cycle), self.memory)

        return decoded, delayed, skip_cycle

    def _apply_delayed(self, delayed: dict) -> None:
        ls = self.local_state
        if "ergs_remaining" in delayed:
            ls.callstack.current.ergs_remaining = delayed["ergs_remaining"]
        if "previous_code_word" in delayed:
            ls.previous_code_word = delayed["previous_code_word"]
        if "previous_super_pc" in delayed:
            ls.previous_super_pc = delayed["previous_super_pc"]
        if "pending_exception" in delayed:
            ls.pending_exception = delayed["pending_exception"]
        if "previous_code_memory_page" in delayed:
            ls.previous_code_memory_page = delayed["previous_code_memory_page"]

    # =====================================================================
    # operand addressing (mem_ops.rs:14-125); returns (reg value, location)
    # =====================================================================
    def _compute_address(self, sp: int, reg_idx: int, imm: int,
                         mode: OperandMode, is_write: bool):
        reg_value = self._select_register(reg_idx)
        reg_low = reg_value.value & U16
        vaddr = (reg_low + imm) & U16
        cur = self.local_state.callstack.current
        stack_page = CallStackEntry.stack_page_from_base(cur.base_memory_page)
        location = None
        if mode in (OperandMode.REG_ONLY, OperandMode.REG_OR_IMM_REG,
                    OperandMode.REG_OR_IMM_IMM, OperandMode.FULL_REG,
                    OperandMode.FULL_IMM16):
            pass
        elif mode == OperandMode.FULL_STACK_PUSH_POP:
            if is_write:  # push
                old_sp = sp
                sp = (sp + vaddr) & U16
                location = (MemoryType.STACK, stack_page, old_sp)
            else:  # pop
                sp = (sp - vaddr) & U16
                location = (MemoryType.STACK, stack_page, sp)
        elif mode == OperandMode.FULL_STACK_OFFSET:
            location = (MemoryType.STACK, stack_page, (sp - vaddr) & U16)
        elif mode == OperandMode.FULL_CODE_PAGE:
            assert not is_write
            location = (MemoryType.CODE, cur.code_page, vaddr)
        elif mode == OperandMode.FULL_ABS_STACK:
            location = (MemoryType.STACK, stack_page, vaddr)
        else:
            raise AssertionError(mode)
        return reg_value, location, sp

    # =====================================================================
    # execute stage (cycle.rs:257-429)
    # =====================================================================
    def cycle(self, tracer=None) -> None:
        ls = self.local_state
        decoded, delayed, skip_cycle = self._read_and_decode(tracer)
        self._apply_delayed(delayed)

        sp = ls.callstack.current.sp
        src0_reg_value, src0_mem_location, sp = self._compute_address(
            sp, decoded.src0_reg, decoded.imm0, decoded.variant.src0_mode, False)
        _, dst0_mem_location, sp = self._compute_address(
            sp, decoded.dst0_reg, decoded.imm1, decoded.variant.dst0_mode, True)
        ls.callstack.current.sp = sp

        if decoded.variant.opcode is Opcode.NOP:
            src0_mem_location = None  # NOP never reads (cycle.rs:298-301)

        if src0_mem_location is not None:
            mem_type, page, index = src0_mem_location
            ts = ls.timestamp_for_code_or_src_read()
            if mem_type == MemoryType.CODE:
                q = self.read_code(ls.monotonic_cycle_counter, page, index, ts)
            else:
                q = self.read_memory(ls.monotonic_cycle_counter, mem_type, page, index, ts)
            src0_mem_value = PrimitiveValue(q.value, q.value_is_pointer)
        else:
            src0_mem_value = PrimitiveValue.empty()

        mode = decoded.variant.src0_mode
        if mode in (OperandMode.REG_ONLY, OperandMode.FULL_REG,
                    OperandMode.REG_OR_IMM_REG):
            src0 = src0_reg_value
        elif mode in (OperandMode.FULL_IMM16, OperandMode.REG_OR_IMM_IMM):
            src0 = PrimitiveValue(decoded.imm0, False)
        else:
            src0 = src0_mem_value

        src1 = self._select_register(decoded.src1_reg)
        if decoded.variant.swap_operands:
            src0, src1 = src1, src0

        new_pc = ls.callstack.current.pc
        if not skip_cycle:
            new_pc = (new_pc + 1) & U16

        is_kernel_mode = ls.callstack.current.is_kernel_mode()

        # pointer-taint erasure (cycle.rs:374-396)
        if not decoded.variant.src0_can_be_pointer and src0.is_pointer \
                and not is_kernel_mode:
            src0 = PrimitiveValue(erase_fat_pointer_metadata(src0.value), False)
        if not decoded.variant.src1_can_be_pointer and src1.is_pointer \
                and not is_kernel_mode:
            src1 = PrimitiveValue(erase_fat_pointer_metadata(src1.value), False)

        if tracer is not None and tracer.CALL_BEFORE_EXECUTION:
            from .tracing import BeforeExecutionData
            tracer.before_execution(ls, BeforeExecutionData(
                opcode=decoded, src0_value=src0, src1_value=src1,
                src0_mem_location=src0_mem_location, new_pc=new_pc),
                self.memory)

        self._dispatch(decoded, src0, src1, dst0_mem_location, new_pc,
                       is_kernel_mode)

        if not skip_cycle:
            ls.timestamp += params.TIME_DELTA_PER_CYCLE
        ls.monotonic_cycle_counter += 1
        self.witness_tracer.end_execution_cycle(ls)
        if tracer is not None and tracer.CALL_AFTER_EXECUTION:
            from .tracing import AfterExecutionData
            tracer.after_execution(ls, AfterExecutionData(
                opcode=decoded, dst0_mem_location=dst0_mem_location),
                self.memory)

    # =====================================================================
    # opcode semantics (opcodes/execution/*)
    # =====================================================================
    def _dispatch(self, decoded: DecodedOpcode, src0: PrimitiveValue,
                  src1: PrimitiveValue, dst0_loc, new_pc: int,
                  is_kernel_mode: bool) -> None:
        op = decoded.variant.opcode
        handler = {
            Opcode.NOP: self._apply_nop,
            Opcode.ADD: self._apply_add,
            Opcode.SUB: self._apply_sub,
            Opcode.MUL: self._apply_mul,
            Opcode.DIV: self._apply_div,
            Opcode.JUMP: self._apply_jump,
            Opcode.CONTEXT: self._apply_context,
            Opcode.SHIFT: self._apply_shift,
            Opcode.BINOP: self._apply_binop,
            Opcode.PTR: self._apply_ptr,
            Opcode.NEAR_CALL: self._apply_near_call,
            Opcode.LOG: self._apply_log,
            Opcode.FAR_CALL: self._apply_far_call,
            Opcode.RET: self._apply_ret,
            Opcode.UMA: self._apply_uma,
        }[op]
        handler(decoded, src0, src1, dst0_loc, new_pc, is_kernel_mode)

    # ----------------------------------------------------------- simple ops
    def _apply_nop(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = new_pc

    def _set_arith_flags(self, of: bool, eq: bool, gt: bool) -> None:
        f = self.local_state.flags
        f.reset()
        f.overflow_or_less_than = of
        f.equality = eq
        f.greater_than = gt

    def _apply_add(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = new_pc
        result = src0.value + src1.value
        of = result > U256_MASK
        result &= U256_MASK
        if d.variant.set_flags:
            eq = result == 0
            self._set_arith_flags(of, eq, not eq and not of)
        self._perform_dst0_update(self.local_state.monotonic_cycle_counter,
                                  PrimitiveValue(result, False), dst0_loc, d.dst0_reg)

    def _apply_sub(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = new_pc
        result = src0.value - src1.value
        of = result < 0
        result &= U256_MASK
        if d.variant.set_flags:
            eq = result == 0
            self._set_arith_flags(of, eq, not eq and not of)
        self._perform_dst0_update(self.local_state.monotonic_cycle_counter,
                                  PrimitiveValue(result, False), dst0_loc, d.dst0_reg)

    def _apply_mul(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = new_pc
        full = src0.value * src1.value
        low, high = full & U256_MASK, full >> 256
        if d.variant.set_flags:
            of = high != 0
            eq = low == 0
            self._set_arith_flags(of, eq, not of and not eq)
        self._perform_dst0_update(self.local_state.monotonic_cycle_counter,
                                  PrimitiveValue(low, False), dst0_loc, d.dst0_reg)
        self._update_register(d.dst1_reg, PrimitiveValue(high, False))

    def _apply_div(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = new_pc
        mcc = self.local_state.monotonic_cycle_counter
        if src1.value == 0:
            if d.variant.set_flags:
                self._set_arith_flags(True, False, False)
            self._perform_dst0_update(mcc, PrimitiveValue.empty(), dst0_loc, d.dst0_reg)
            self._update_register(d.dst1_reg, PrimitiveValue.empty())
        else:
            q, r = divmod(src0.value, src1.value)
            if d.variant.set_flags:
                self._set_arith_flags(False, q == 0, r == 0)
            self._perform_dst0_update(mcc, PrimitiveValue(q, False), dst0_loc, d.dst0_reg)
            self._update_register(d.dst1_reg, PrimitiveValue(r, False))

    def _apply_jump(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = src0.value & U16

    def _apply_shift(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = new_pc
        shift = src1.value & 0xFF
        v = src0.value
        sub = ShiftOp(d.variant.sub)
        cyclic = sub in (ShiftOp.ROL, ShiftOp.ROR)
        right = sub in (ShiftOp.SHR, ShiftOp.ROR)
        if right:
            result = v >> shift
            if cyclic:
                result |= (v << (256 - shift)) & U256_MASK if shift else 0
        else:
            result = (v << shift) & U256_MASK
            if cyclic:
                result |= v >> (256 - shift) if shift else 0
        if d.variant.set_flags:
            f = self.local_state.flags
            f.reset()
            f.equality = result == 0
        self._perform_dst0_update(self.local_state.monotonic_cycle_counter,
                                  PrimitiveValue(result, False), dst0_loc, d.dst0_reg)

    def _apply_binop(self, d, src0, src1, dst0_loc, new_pc, kernel):
        self.local_state.callstack.current.pc = new_pc
        sub = BinopOp(d.variant.sub)
        if sub == BinopOp.XOR:
            result = src0.value ^ src1.value
        elif sub == BinopOp.AND:
            result = src0.value & src1.value
        else:
            result = src0.value | src1.value
        if d.variant.set_flags:
            f = self.local_state.flags
            f.reset()
            f.equality = result == 0
        self._perform_dst0_update(self.local_state.monotonic_cycle_counter,
                                  PrimitiveValue(result, False), dst0_loc, d.dst0_reg)

    def _apply_context(self, d, src0, src1, dst0_loc, new_pc, kernel):
        ls = self.local_state
        ls.callstack.current.pc = new_pc
        cur = ls.callstack.current
        sub = ContextOp(d.variant.sub)
        if sub == ContextOp.SET_CONTEXT_U128:
            ls.context_u128_register = src0.value & U128
            return
        if sub == ContextOp.SET_ERGS_PER_PUBDATA_BYTE:
            ls.current_ergs_per_pubdata_byte = src0.value & U32
            return
        if sub == ContextOp.INCREMENT_TX_NUMBER:
            ls.tx_number_in_block = (ls.tx_number_in_block + 1) & U16
            return
        if sub == ContextOp.THIS:
            value = cur.this_address
        elif sub == ContextOp.CALLER:
            value = cur.msg_sender
        elif sub == ContextOp.CODE_ADDRESS:
            value = cur.code_address
        elif sub == ContextOp.META:
            value = VmMetaParameters(
                ergs_per_pubdata_byte=ls.current_ergs_per_pubdata_byte,
                heap_size=cur.heap_bound, aux_heap_size=cur.aux_heap_bound,
                this_shard_id=cur.this_shard_id,
                caller_shard_id=cur.caller_shard_id,
                code_shard_id=cur.code_shard_id).to_u256()
        elif sub == ContextOp.ERGS_LEFT:
            value = cur.ergs_remaining
        elif sub == ContextOp.SP:
            value = cur.sp
        elif sub == ContextOp.GET_CONTEXT_U128:
            value = cur.context_u128_value
        else:
            raise AssertionError(sub)
        self._perform_dst0_update(ls.monotonic_cycle_counter,
                                  PrimitiveValue(value, False), dst0_loc, d.dst0_reg)

    def _apply_ptr(self, d, src0, src1, dst0_loc, new_pc, kernel):
        ls = self.local_state
        ls.callstack.current.pc = new_pc
        sub = PtrOp(d.variant.sub)
        if not src0.is_pointer or src1.is_pointer:
            self._set_shorthand_panic()
            return
        if sub in (PtrOp.ADD, PtrOp.SUB):
            if src1.value >= params.MAX_OFFSET_FOR_ADD_SUB:
                self._set_shorthand_panic()
                return
            fat_ptr = FatPointer.from_u256(src0.value)
            offset = src1.value & U32
            new_offset = fat_ptr.offset + offset if sub == PtrOp.ADD \
                else fat_ptr.offset - offset
            if not 0 <= new_offset <= U32:
                self._set_shorthand_panic()
                return
            fat_ptr.offset = new_offset
            result = (src0.value & ~U128) | fat_ptr.to_u256()
        elif sub == PtrOp.PACK:
            if src1.value & U128 != 0:
                self._set_shorthand_panic()
                return
            result = (src1.value & ~U128) | (src0.value & U128)
        else:  # SHRINK
            fat_ptr = FatPointer.from_u256(src0.value)
            new_length = fat_ptr.length - (src1.value & U32)
            if new_length < 0:
                self._set_shorthand_panic()
                return
            fat_ptr.length = new_length
            result = (src0.value & ~U128) | fat_ptr.to_u256()
        self._perform_dst0_update(ls.monotonic_cycle_counter,
                                  PrimitiveValue(result, True), dst0_loc, d.dst0_reg)

    def _apply_near_call(self, d, src0, src1, dst0_loc, new_pc, kernel):
        ls = self.local_state
        self.reset_flags()
        abi = NearCallABI.from_u256(src0.value)
        cur = ls.callstack.current
        remaining = cur.ergs_remaining
        if abi.ergs_passed == 0 or abi.ergs_passed > remaining:
            passed, left = remaining, 0
        else:
            passed, left = abi.ergs_passed, remaining - abi.ergs_passed
        cur.ergs_remaining = left
        cur.pc = new_pc
        new_stack = cur.copy()
        new_stack.pc = d.imm0
        new_stack.exception_handler_location = d.imm1
        new_stack.ergs_remaining = passed
        new_stack.is_local_frame = True
        self.start_frame(ls.monotonic_cycle_counter, new_stack)

    # --------------------------------------------------------------- log ops
    def _apply_log(self, d, src0, src1, dst0_loc, new_pc, kernel):
        ls = self.local_state
        ls.callstack.current.pc = new_pc
        sub = LogOp(d.variant.sub)
        is_first = d.variant.flag0 if params.FIRST_MESSAGE_FLAG_IDX == 0 else d.variant.flag1
        cur = ls.callstack.current
        shard_id = cur.this_shard_id
        address = cur.this_address
        ergs_available = cur.ergs_remaining
        is_rollup = shard_id == 0
        ts_log = ls.timestamp_for_first_decommit_or_precompile_read()
        tx_number = ls.tx_number_in_block
        mcc = ls.monotonic_cycle_counter

        ergs_on_pubdata = 0
        if sub == LogOp.STORAGE_WRITE:
            partial = LogQuery(ts_log, tx_number, params.STORAGE_AUX_BYTE,
                               shard_id, address, src0.value, 0, src1.value,
                               True, False, False)
            refund = self.refund_for_partial_query(mcc, partial)
            pubdata_refund = refund.pubdata_refund()
            if is_rollup:
                net = params.INITIAL_STORAGE_WRITE_PUBDATA_BYTES - pubdata_refund
                assert net >= 0
            else:
                assert pubdata_refund == 0
                net = 0
            ergs_on_pubdata = ls.current_ergs_per_pubdata_byte * net
        elif sub == LogOp.TO_L1_MESSAGE:
            ergs_on_pubdata = ls.current_ergs_per_pubdata_byte * \
                params.L1_MESSAGE_PUBDATA_BYTES

        extra_cost = src1.value & U32 if sub == LogOp.PRECOMPILE_CALL else 0
        total_cost = extra_cost + ergs_on_pubdata
        not_enough = total_cost > ergs_available
        if not_enough:
            cur.ergs_remaining = 0
            ls.spent_pubdata_counter += min(ergs_available, ergs_on_pubdata)
        else:
            ergs_remaining = ergs_available - total_cost
            cur.ergs_remaining = ergs_remaining
            ls.spent_pubdata_counter += ergs_on_pubdata

        if sub == LogOp.STORAGE_READ:
            assert not not_enough
            q = self.access_storage(mcc, LogQuery(
                ts_log, tx_number, params.STORAGE_AUX_BYTE, shard_id, address,
                src0.value, 0, 0, False, False, is_first))
            self._perform_dst0_update(mcc, PrimitiveValue(q.read_value, False),
                                      dst0_loc, d.dst0_reg)
        elif sub == LogOp.STORAGE_WRITE:
            if not_enough:
                return
            self.access_storage(mcc, LogQuery(
                ts_log, tx_number, params.STORAGE_AUX_BYTE, shard_id, address,
                src0.value, 0, src1.value, True, False, is_first))
        elif sub in (LogOp.EVENT, LogOp.TO_L1_MESSAGE):
            if not_enough:
                assert sub == LogOp.TO_L1_MESSAGE
                return
            aux = params.EVENT_AUX_BYTE if sub == LogOp.EVENT \
                else params.L1_MESSAGE_AUX_BYTE
            self.emit_event(mcc, LogQuery(
                ts_log, tx_number, aux, shard_id, address, src0.value, 0,
                src1.value, True, False, is_first))
        else:  # PRECOMPILE_CALL
            if not_enough:
                self._perform_dst0_update(mcc, PrimitiveValue.empty(),
                                          dst0_loc, d.dst0_reg)
                return
            abi = PrecompileCallABI.from_u256(src0.value)
            if abi.memory_page_to_read == 0:
                abi.memory_page_to_read = CallStackEntry.heap_page_from_base(
                    cur.base_memory_page)
            if abi.memory_page_to_write == 0:
                abi.memory_page_to_write = CallStackEntry.heap_page_from_base(
                    cur.base_memory_page)
            q = LogQuery(ts_log, tx_number, params.PRECOMPILE_AUX_BYTE, shard_id,
                         address, abi.to_u256(), 0, 0, False, False, is_first)
            self.call_precompile(mcc, q)
            self._perform_dst0_update(mcc, PrimitiveValue(1, False),
                                      dst0_loc, d.dst0_reg)

    # --------------------------------------------------------------- far call
    def _apply_far_call(self, d, src0, src1, dst0_loc, new_pc, kernel):
        ls = self.local_state
        sub = FarCallOp(d.variant.sub)
        self.reset_flags()
        is_static_call = d.variant.flag0 if params.FAR_CALL_STATIC_FLAG_IDX == 0 \
            else d.variant.flag1
        is_call_shard = d.variant.flag1 if params.FAR_CALL_SHARD_FLAG_IDX == 1 \
            else d.variant.flag0
        exception_handler_location = d.imm0

        called_address = src1.value & ((1 << 160) - 1)
        dst_is_kernel = called_address < params.KERNEL_SPACE_BOUND

        far_call_abi = FarCallABI.from_u256(src0.value)
        far_call_abi.constructor_call = far_call_abi.constructor_call and kernel
        far_call_abi.to_system = far_call_abi.to_system and dst_is_kernel

        cur = ls.callstack.current
        current_address = cur.this_address
        current_msg_sender = cur.msg_sender
        current_base_page = cur.base_memory_page
        caller_shard_id = cur.this_shard_id
        remaining_ergs = cur.ergs_remaining
        current_context_u128 = cur.context_u128_value

        ts_storage_read = ls.timestamp_for_first_decommit_or_precompile_read()
        tx_number = ls.tx_number_in_block
        mcc = ls.monotonic_cycle_counter

        new_code_shard_id = far_call_abi.shard_id if is_call_shard else caller_shard_id
        new_this_shard_id = caller_shard_id if sub == FarCallOp.DELEGATE \
            else new_code_shard_id
        new_base_memory_page = ls.memory_page_counter

        exceptions = 0
        EX_NOT_PTR, EX_BAD_HASH, EX_NO_ERGS_DECOMMIT, EX_NO_ERGS_GROW, \
            EX_MALFORMED_PTR, EX_CONSTRUCTED_SYSTEM, EX_NO_ERGS_EXTRA = \
            (1 << i for i in range(7))

        # -- code hash read + masking (far_call.rs:122-252)
        if new_code_shard_id != 0 and not self.block_properties.zkporter_is_available:
            code_hash_raw, map_to_trivial = 0, True
        else:
            q = self.access_storage(mcc, LogQuery(
                ts_storage_read, tx_number, params.STORAGE_AUX_BYTE,
                new_code_shard_id, params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS,
                called_address, 0, 0, False, False, False))
            code_hash_from_storage = q.read_value
            mask_into_default_aa = code_hash_from_storage == 0 and not dst_is_kernel
            code_hash_raw = self.block_properties.default_aa_code_hash \
                if mask_into_default_aa else code_hash_from_storage
            map_to_trivial = False

        code_page_candidate = params.UNMAPPED_PAGE if map_to_trivial else \
            CallStackEntry.code_page_candidate_from_base(new_base_memory_page)

        vh = VersionedCodeHash.try_from_u256(code_hash_raw)
        if vh is not None:
            marker_at_rest = vh.marker == params.CODE_AT_REST_MARKER
            marker_constructed_now = vh.marker == params.YET_CONSTRUCTED_MARKER
            if not (marker_at_rest or marker_constructed_now):
                exceptions |= EX_BAD_HASH
                code_hash, code_length_in_words = 0, 0
            else:
                can_at_rest = not far_call_abi.constructor_call and marker_at_rest
                can_by_ctor = far_call_abi.constructor_call and marker_constructed_now
                if can_at_rest or can_by_ctor:
                    code_hash = vh.serialize_to_stored()
                    code_length_in_words = vh.code_length_in_words
                elif not dst_is_kernel:
                    aa_vh = VersionedCodeHash.try_from_u256(
                        self.block_properties.default_aa_code_hash)
                    assert aa_vh is not None and \
                        aa_vh.marker == params.CODE_AT_REST_MARKER
                    code_hash = self.block_properties.default_aa_code_hash
                    code_length_in_words = aa_vh.code_length_in_words
                else:
                    exceptions |= EX_CONSTRUCTED_SYSTEM
                    code_hash, code_length_in_words = 0, 0
        else:
            exceptions |= EX_BAD_HASH
            code_hash, code_length_in_words = 0, 0

        # -- pointer validation + forwarding (far_call.rs:254-325)
        if far_call_abi.forwarding_mode == ForwardingMode.FORWARD_FAT_POINTER \
                and not src0.is_pointer:
            exceptions |= EX_NOT_PTR
        validate_as_fresh = \
            far_call_abi.forwarding_mode != ForwardingMode.FORWARD_FAT_POINTER
        ptr_validation = far_call_abi.memory_quasi_fat_pointer.validate(
            validate_as_fresh)
        if ptr_validation != FatPointerValidationException.NONE:
            exceptions |= EX_MALFORMED_PTR
        if not far_call_abi.memory_quasi_fat_pointer.validate_as_slice():
            exceptions |= EX_MALFORMED_PTR

        fp = far_call_abi.memory_quasi_fat_pointer
        if far_call_abi.forwarding_mode == ForwardingMode.FORWARD_FAT_POINTER:
            fp.start = (fp.start + fp.offset) & U32
            fp.length = (fp.length - fp.offset) & U32
            fp.offset = 0
        elif far_call_abi.forwarding_mode == ForwardingMode.USE_HEAP:
            fp.memory_page = CallStackEntry.heap_page_from_base(current_base_page)
        else:
            fp.memory_page = CallStackEntry.aux_heap_page_from_base(current_base_page)

        if exceptions:
            far_call_abi.memory_quasi_fat_pointer = FatPointer.empty()
            fp = far_call_abi.memory_quasi_fat_pointer

        # -- memory growth payment (far_call.rs:329-385)
        growth_bytes = 0
        if far_call_abi.forwarding_mode != ForwardingMode.FORWARD_FAT_POINTER:
            upper_bound = fp.start + fp.length
            if ptr_validation & FatPointerValidationException.DEREF_BEYOND_HEAP_RANGE:
                upper_bound = U32
            use_heap = far_call_abi.forwarding_mode == ForwardingMode.USE_HEAP
            bound = cur.heap_bound if use_heap else cur.aux_heap_bound
            diff = upper_bound - bound
            if diff < 0:
                diff = 0
            else:
                if use_heap:
                    cur.heap_bound = upper_bound
                else:
                    cur.aux_heap_bound = upper_bound
            growth_bytes = diff
        cost_of_growth = (growth_bytes * params.MEMORY_GROWTH_ERGS_PER_BYTE) & U32
        if remaining_ergs >= cost_of_growth:
            remaining_after_growth = remaining_ergs - cost_of_growth
        else:
            exceptions |= EX_NO_ERGS_GROW
            remaining_after_growth = 0

        # msg-value stipend is feature-gated off (far_call.rs:13)
        msg_value_stipend = 0
        remaining_of_caller = remaining_after_growth

        cost_of_decommit = params.ERGS_PER_CODE_WORD_DECOMMITTMENT * code_length_in_words
        if remaining_of_caller >= cost_of_decommit:
            remaining_after_decommit = remaining_of_caller - cost_of_decommit
        else:
            exceptions |= EX_NO_ERGS_DECOMMIT
            remaining_after_decommit = remaining_of_caller

        if exceptions:
            self._set_shorthand_panic()
            code_memory_page = params.UNMAPPED_PAGE
        else:
            dq = self.decommit(mcc, code_hash, code_page_candidate,
                               ls.timestamp_for_first_decommit_or_precompile_read())
            if not dq.is_fresh:
                remaining_after_decommit += cost_of_decommit
            code_memory_page = dq.memory_page

        # -- 63/64 rule + frame creation (far_call.rs:465-555)
        remaining_to_pass = remaining_after_decommit
        max_passable = (remaining_to_pass // 64) * 63
        leftover = remaining_to_pass - max_passable
        if far_call_abi.ergs_passed > max_passable:
            passed_ergs, remaining_for_this = max_passable, leftover
        else:
            passed_ergs = far_call_abi.ergs_passed
            remaining_for_this = leftover + (max_passable - far_call_abi.ergs_passed)
        passed_ergs = (passed_ergs + msg_value_stipend) & U32

        cur.ergs_remaining = remaining_for_this
        cur.pc = new_pc
        new_context_is_static = cur.is_static or is_static_call
        ls.memory_page_counter += params.NEW_MEMORY_PAGES_PER_FAR_CALL

        implicit_value = self._select_register(
            params.CALL_IMPLICIT_PARAMETER_REG_IDX + 1).value
        address_from_implicit = implicit_value & ((1 << 160) - 1)

        if sub == FarCallOp.NORMAL:
            address_for_next, sender_for_next = called_address, current_address
        elif sub == FarCallOp.DELEGATE:
            address_for_next, sender_for_next = current_address, current_msg_sender
        else:
            address_for_next, sender_for_next = called_address, address_from_implicit
        context_u128_for_next = current_context_u128 if sub == FarCallOp.DELEGATE \
            else ls.context_u128_register

        new_stack = CallStackEntry(
            this_address=address_for_next,
            msg_sender=sender_for_next,
            code_address=called_address,
            base_memory_page=new_base_memory_page,
            code_page=code_memory_page,
            sp=params.INITIAL_SP_ON_FAR_CALL,
            pc=0,
            exception_handler_location=exception_handler_location,
            ergs_remaining=passed_ergs,
            this_shard_id=new_this_shard_id,
            caller_shard_id=caller_shard_id,
            code_shard_id=new_code_shard_id,
            is_static=new_context_is_static,
            is_local_frame=False,
            context_u128_value=context_u128_for_next,
            heap_bound=params.NEW_FRAME_MEMORY_STIPEND,
            aux_heap_bound=params.NEW_FRAME_MEMORY_STIPEND,
        )
        ls.context_u128_register = 0
        self.start_frame(mcc, new_stack)
        self.memory.start_global_frame(
            current_base_page, new_base_memory_page,
            far_call_abi.memory_quasi_fat_pointer, ls.timestamp)

        # register-file protocol (far_call.rs:571-610)
        self._update_register(
            params.CALL_IMPLICIT_CALLDATA_FAT_PTR_REGISTER + 1,
            PrimitiveValue(far_call_abi.memory_quasi_fat_pointer.to_u256(), True))
        r2 = (1 if far_call_abi.constructor_call else 0) | \
             (2 if far_call_abi.to_system else 0)
        self._update_register(
            params.CALL_IMPLICIT_CONSTRUCTOR_MARKER_REGISTER + 1,
            PrimitiveValue(r2, False))
        for reg_idx in params.CALL_SYSTEM_ABI_REGISTERS:
            if not far_call_abi.to_system:
                self._update_register(reg_idx + 1, PrimitiveValue.empty())
            else:
                reg = self.local_state.registers[reg_idx]
                reg.is_pointer = False
        for reg_idx in params.CALL_RESERVED_RANGE:
            self._update_register(reg_idx + 1, PrimitiveValue.empty())
        self._update_register(params.CALL_IMPLICIT_PARAMETER_REG_IDX + 1,
                              PrimitiveValue.empty())

    # -------------------------------------------------------------------- ret
    def _apply_ret(self, d, src0, src1, dst0_loc, new_pc, kernel):
        ls = self.local_state
        variant = RetOp(d.variant.sub)
        self.reset_flags()
        src0_value, src0_is_ptr = src0.value, src0.is_pointer
        if variant == RetOp.PANIC:
            src0_value, src0_is_ptr = 0, False
        ret_abi = RetABI.from_u256(src0_value)
        fp = ret_abi.memory_quasi_fat_pointer
        mode = ret_abi.page_forwarding_mode
        is_to_label = d.variant.flag0 if params.RET_TO_LABEL_BIT_IDX == 0 \
            else d.variant.flag1
        label_pc = d.imm0

        cur = ls.callstack.current
        ptr_validation = FatPointerValidationException.NONE
        if not cur.is_local_frame:
            if mode == ForwardingMode.FORWARD_FAT_POINTER:
                if not src0_is_ptr:
                    variant = RetOp.PANIC
                if fp.memory_page < cur.base_memory_page:
                    # ban back-forwarding own calldata (ret.rs:65-74)
                    variant = RetOp.PANIC
            validate_as_fresh = mode != ForwardingMode.FORWARD_FAT_POINTER
            ptr_validation = fp.validate(validate_as_fresh)
            if ptr_validation != FatPointerValidationException.NONE:
                variant = RetOp.PANIC
            if not fp.validate_as_slice():
                variant = RetOp.PANIC
            if variant == RetOp.PANIC:
                fp = FatPointer.empty()

        ergs_remaining = cur.ergs_remaining
        fat_ptr_for_returndata = None
        if not cur.is_local_frame:
            if variant in (RetOp.OK, RetOp.REVERT):
                if mode == ForwardingMode.FORWARD_FAT_POINTER:
                    fp.start = (fp.start + fp.offset) & U32
                    fp.length = (fp.length - fp.offset) & U32
                    fp.offset = 0
                elif mode == ForwardingMode.USE_HEAP:
                    fp.memory_page = CallStackEntry.heap_page_from_base(
                        cur.base_memory_page)
                else:
                    fp.memory_page = CallStackEntry.aux_heap_page_from_base(
                        cur.base_memory_page)
            growth_bytes = 0
            if mode != ForwardingMode.FORWARD_FAT_POINTER:
                upper_bound = fp.start + fp.length
                if ptr_validation & FatPointerValidationException.DEREF_BEYOND_HEAP_RANGE:
                    upper_bound = U32
                bound = cur.heap_bound if mode == ForwardingMode.USE_HEAP \
                    else cur.aux_heap_bound
                diff = upper_bound - bound
                growth_bytes = max(diff, 0)
            cost = (growth_bytes * params.MEMORY_GROWTH_ERGS_PER_BYTE) & U32
            if ergs_remaining >= cost:
                ergs_remaining -= cost
            else:
                ergs_remaining = 0
                variant = RetOp.PANIC
                fp = FatPointer.empty()
            fat_ptr_for_returndata = fp

        panicked = variant in (RetOp.REVERT, RetOp.PANIC)
        finished = self.finish_frame(ls.monotonic_cycle_counter, panicked)
        is_to_label = is_to_label and finished.is_local_frame

        if not finished.is_local_frame:
            rd = fat_ptr_for_returndata
            self.memory.finish_global_frame(
                finished.base_memory_page, rd, ls.timestamp)
            self._update_register(
                params.RET_IMPLICIT_RETURNDATA_PARAMS_REGISTER + 1,
                PrimitiveValue(rd.to_u256(), True))
            for idx in (params.RET_RESERVED_REGISTER_0,
                        params.RET_RESERVED_REGISTER_1,
                        params.RET_RESERVED_REGISTER_2):
                self._update_register(idx + 1, PrimitiveValue.empty())
            for idx in range(params.RET_RESERVED_REGISTER_2 + 1,
                             params.REGISTERS_COUNT):
                self._update_register(idx + 1, PrimitiveValue.empty())
            ls.context_u128_register = 0

        next_context = ls.callstack.current
        next_context.ergs_remaining = (next_context.ergs_remaining
                                       + ergs_remaining) & U32
        if is_to_label:
            next_context.pc = label_pc
        elif panicked:
            next_context.pc = finished.exception_handler_location

        if finished.is_local_frame:
            assert finished.heap_bound >= next_context.heap_bound
            assert finished.aux_heap_bound >= next_context.aux_heap_bound
            next_context.heap_bound = finished.heap_bound
            next_context.aux_heap_bound = finished.aux_heap_bound

        if variant == RetOp.PANIC:
            ls.flags.overflow_or_less_than = True

    # -------------------------------------------------------------------- uma
    def _apply_uma(self, d, src0, src1, dst0_loc, new_pc, kernel):
        ls = self.local_state
        assert dst0_loc is None, "UMA dst0 is always a register"
        sub = UMAOp(d.variant.sub)
        ls.callstack.current.pc = new_pc
        increment_offset = d.variant.flag0 if params.UMA_INCREMENT_FLAG_IDX == 0 \
            else d.variant.flag1

        src0_value, src0_is_ptr = src0.value, src0.is_pointer
        fat_ptr = FatPointer.from_u256(src0_value)
        exceptions = 0
        EX_NOT_PTR, EX_DEREF_BEYOND, EX_OF_INCR, EX_NO_ERGS = 1, 2, 4, 8
        skip_mem = False

        is_ptr_read = sub == UMAOp.FAT_POINTER_READ
        if is_ptr_read and not src0_is_ptr:
            exceptions |= EX_NOT_PTR

        cur = ls.callstack.current
        if sub in (UMAOp.HEAP_READ, UMAOp.HEAP_WRITE):
            fat_ptr.memory_page = CallStackEntry.heap_page_from_base(
                cur.base_memory_page)
            memory_type = MemoryType.HEAP
        elif sub in (UMAOp.AUX_HEAP_READ, UMAOp.AUX_HEAP_WRITE):
            fat_ptr.memory_page = CallStackEntry.aux_heap_page_from_base(
                cur.base_memory_page)
            memory_type = MemoryType.AUX_HEAP
        else:
            memory_type = MemoryType.FAT_POINTER

        if is_ptr_read:
            if not fat_ptr.validate_in_bounds():
                skip_mem = True
            src_offset = (fat_ptr.start + fat_ptr.offset) & U32
        else:
            if src0_value > params.MAX_OFFSET_TO_DEREF:
                exceptions |= EX_DEREF_BEYOND
                skip_mem = True
            src_offset = fat_ptr.offset

        incremented_offset = fat_ptr.offset + 32
        increment_of = incremented_offset > U32
        incremented_offset &= U32
        if increment_of:
            exceptions |= EX_OF_INCR
            if not is_ptr_read:
                assert exceptions & EX_DEREF_BEYOND

        # memory growth payment (uma.rs:152-217)
        growth = 0
        if not is_ptr_read:
            bound = cur.heap_bound if memory_type == MemoryType.HEAP \
                else cur.aux_heap_bound
            diff = incremented_offset - bound
            if diff < 0:
                diff = 0
            else:
                if memory_type == MemoryType.HEAP:
                    cur.heap_bound = incremented_offset
                else:
                    cur.aux_heap_bound = incremented_offset
            growth = diff
        cost = (growth * params.MEMORY_GROWTH_ERGS_PER_BYTE) & U32
        if exceptions & EX_DEREF_BEYOND:
            cost = U32
        if cur.ergs_remaining >= cost:
            cur.ergs_remaining -= cost
        else:
            cur.ergs_remaining = 0
            exceptions |= EX_NO_ERGS

        set_panic = exceptions != 0
        skip_memory_access = skip_mem or set_panic

        word_0 = src_offset // 32
        word_1 = word_0 + 1
        unalignment = src_offset % 32
        word_0_lowest_bytes = 32 - unalignment
        is_unaligned = unalignment != 0
        ts_read = ls.timestamp_for_code_or_src_read()
        ts_write = ls.timestamp_for_dst_write()
        mcc = ls.monotonic_cycle_counter
        page = fat_ptr.memory_page

        w0 = 0
        if not skip_memory_access:
            w0 = self.read_memory(mcc, memory_type, page, word_0, ts_read).value
        w1 = 0
        if is_unaligned and not skip_memory_access:
            w1 = self.read_memory(mcc, memory_type, page, word_1, ts_read).value

        if sub in (UMAOp.HEAP_READ, UMAOp.AUX_HEAP_READ, UMAOp.FAT_POINTER_READ):
            result = (w0 << (unalignment * 8)) & U256_MASK
            if unalignment:
                result |= w1 >> ((32 - unalignment) * 8)
            if is_ptr_read:
                beyond = incremented_offset - fat_ptr.length
                if beyond < 0 or skip_memory_access:
                    beyond = 0
                beyond %= 32
                result = (result >> (beyond * 8)) << (beyond * 8)
            if not set_panic:
                self._perform_dst0_update(mcc, PrimitiveValue(result, False),
                                          dst0_loc, d.dst0_reg)
                if increment_offset:
                    updated = (src0_value & ~U32) | incremented_offset
                    self._update_register(d.dst1_reg,
                                          PrimitiveValue(updated, src0_is_ptr))
            else:
                self._set_shorthand_panic()
        else:  # writes
            sv = src1.value
            new_w0 = ((w0 >> (word_0_lowest_bytes * 8)) << (word_0_lowest_bytes * 8)) \
                if word_0_lowest_bytes < 32 else 0
            new_w0 = (new_w0 | (sv >> (unalignment * 8))) & U256_MASK
            if unalignment:
                keep_mask_bits = (32 - unalignment) * 8
                new_w1 = ((w1 << (unalignment * 8)) & U256_MASK) >> (unalignment * 8)
                new_w1 |= (sv << keep_mask_bits) & U256_MASK
            else:
                new_w1 = 0
            if not skip_memory_access:
                self.write_memory(mcc, memory_type, page, word_0, ts_write,
                                  PrimitiveValue(new_w0, False))
                if is_unaligned:
                    self.write_memory(mcc, memory_type, page, word_1, ts_write,
                                      PrimitiveValue(new_w1, False))
            if not set_panic:
                if increment_offset:
                    updated = (src0_value & ~U32) | incremented_offset
                    self._perform_dst0_update(mcc, PrimitiveValue(updated, False),
                                              dst0_loc, d.dst0_reg)
            else:
                self._set_shorthand_panic()
