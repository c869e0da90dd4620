// K1: the K-cycle EraVM interpreter, one thread per lane (CUDA C++, sm_90a).
//
// Replaces the TPU kernel era_zk_evm_tpu/models/fused_cycle.py::_build_kernel
// (wrapped by _build_call, driven by _run_chunk) for the memory-witness slice:
// NOP ADD SUB MUL DIV JUMP CONTEXT SHIFT BINOP PTR NEAR_CALL RET UMA, with
// register, stack and code addressing, heap and aux heap, the memory witness
// queue (mode a) or a chunk slot block for the rolling fold K2 (mode b).  LOG
// and FAR_CALL set lane_error, as the JAX engine does with storage_slots == 0.
// Its plain version is era_zk_evm_tpu_torch/models/batched_vm.py::cycle_step;
// both follow era_zk_evm_tpu/models/batched_vm.py::cycle_step section by
// section, and the smoke run holds them equal bit for bit.
//
// Design.  The TPU kernel keeps a tile of lanes in VMEM and reaches every
// per-lane index through one-hot sweeps over whole arenas (_onehot_l,
// _gather_l, _scatter_l), packs state batch-last (_pack/_unpack) and gates
// work with pl.when.  None of that is carried over: a thread owns one lane,
// loads by index and branches.  The register file, flags and lane scalars
// live in registers / local memory for the whole launch; the callstack frame
// is read from and written to global memory each cycle.  k_stop is always
// honoured.  Each cycle writes its 8 memory-query slots straight into the
// persistent queue at min(step * 8, cap - 8) (mode a) or into row c * 8 of
// the chunk block (mode b); both are batch-last, so those stores coalesce.
//
// What bounds it on an H100: the arenas are lane-major ([B, SW * 8] stack,
// [B, W, 8] heap/code), so a warp's 32 word loads hit 32 different 32-byte
// sectors in different rows — uncoalesced traffic, one sector per lane per
// access — and the per-lane register file and slot arrays sit in local
// memory (ptxas: 254 registers, a 936-byte stack frame, no spills), which
// caps occupancy at 8 warps per SM.  Making the arenas coalesced (or
// staging them in shared memory) is later work.

#include "common.cuh"
#include "u256.cuh"

struct K1Args {
    int32_t *regs;          // [B, 15, 8]
    uint8_t *reg_ptr;       // [B, 15]
    uint8_t *flags;         // [B, 3]
    int32_t *timestamp, *mcc, *ergs_per_pubdata, *tx_number;
    uint8_t *pending;
    int32_t *prev_code_word;  // [B, 8]
    int32_t *prev_super_pc, *prev_code_page;
    int32_t *context_u128;    // [B, 4]
    int32_t *depth;
    int32_t *cs_this, *cs_sender, *cs_code_addr;  // [B, D, 5]
    int32_t *cs_u128;                              // [B, D, 4]
    int32_t *cs_scalars;                           // [B, D, NF]
    int32_t *code;          // [B, P * CW, 8]
    int32_t *stack;         // [B, SW * 8]
    uint8_t *stack_tag;     // [B, SW]
    int32_t *heap;          // [B, F * HW, 8]
    int32_t *aux_heap;      // [B, F * AW, 8]
    int32_t *hp_page, *ap_page;   // [B, F]
    int32_t *cb_page;       // [B, P]
    uint8_t *cb_valid;      // [B, P]
    int32_t *j_count, *ev_count;
    uint8_t *done, *lane_error;
    int32_t *global_step, *wq_count;
    int32_t *q_meta;        // [rows, 4, B]
    int32_t *q_value;       // [rows, 8, B]
    int32_t *q_flags;       // [rows, B]
    const int32_t *step0;   // device scalar: min(global_step) of the batch
    int batch, max_depth, code_words, code_pages, stack_words;
    int stack_abs_words;    // -1: one window
    int stack_sp_base, heap_words, aux_heap_words, heap_frames;
    int queue_capacity;
    int emit_mode;          // 0 no slots, 1 persistent queue, 2 chunk block
    int k_cycles, k_stop;
};

struct Slot {
    bool valid;
    uint32_t type, page, index, ptr, rw, ts;
    U256 val;
};

HD U256 load_word(const int32_t *lane_arena, uint64_t n_words, uint64_t idx) {
    U256 r = u256_zero();
    if (idx < n_words)
        for (int l = 0; l < 8; l++) r.w[l] = (uint32_t)lane_arena[idx * 8 + l];
    return r;
}

HD void store_word(int32_t *lane_arena, uint64_t n_words, uint64_t idx,
                   const U256 &v) {
    if (idx < n_words)
        for (int l = 0; l < 8; l++) lane_arena[idx * 8 + l] = (int32_t)v.w[l];
}

// logical stack index -> physical arena slot; false when out of window
HD bool map_stack(const K1Args &a, uint32_t idx, uint32_t *phys) {
    if (a.stack_abs_words < 0) {
        *phys = idx;
        return idx < (uint32_t)a.stack_words;
    }
    uint32_t A = a.stack_abs_words, s0 = a.stack_sp_base;
    uint32_t w = a.stack_words - A;
    bool in_abs = idx < A;
    bool in_sp = idx >= s0 && idx < s0 + w;
    *phys = in_abs ? idx : (in_sp ? A + (idx - s0) : (uint32_t)a.stack_words);
    return in_abs || in_sp;
}

struct Lane {
    uint32_t regs[15][8];
    bool rtag[15];
    bool lt, eq, gt;
    uint32_t timestamp, mcc, ergs_per_pubdata, tx_number;
    bool pending;
    U256 prev_code_word;
    uint32_t prev_super_pc, prev_code_page;
    uint32_t ctx[4];
    int32_t depth;
    bool done, lane_error;
    int32_t wq_count;
};

HD void read_reg(const Lane &L, uint32_t idx, U256 *v, bool *tag) {
    // r0 reads as zero
    if (idx == 0 || idx > 15) {
        *v = u256_zero();
        *tag = false;
        return;
    }
    for (int l = 0; l < 8; l++) v->w[l] = L.regs[idx - 1][l];
    *tag = L.rtag[idx - 1];
}

HD void write_reg(Lane &L, uint32_t idx, const U256 &v, bool tag) {
    for (int l = 0; l < 8; l++) L.regs[idx - 1][l] = v.w[l];
    L.rtag[idx - 1] = tag;
}

// one cycle of one live lane (done lanes never get here); fills the
// cycle's 8 witness slots
HD void lane_cycle(const K1Args &a, int b, Lane &L, Slot *slots) {
    const int D = a.max_depth;
    for (int s = 0; s < SLOTS_PER_CYCLE; s++) slots[s].valid = false;

    // ---------------------------------------------------------- frame
    const int32_t depth = L.depth;
    const bool frame_ok = depth >= 0 && depth < D;
    uint32_t scal[NF];
    uint32_t this_addr[5], msg_sender[5], code_addr[5], frame_u128[4];
    {
        const uint64_t fi = (uint64_t)b * D + (frame_ok ? depth : 0);
        for (int f = 0; f < (int)NF; f++)
            scal[f] = frame_ok ? (uint32_t)a.cs_scalars[fi * NF + f] : 0u;
        for (int i = 0; i < 5; i++) {
            this_addr[i] = frame_ok ? (uint32_t)a.cs_this[fi * 5 + i] : 0u;
            msg_sender[i] = frame_ok ? (uint32_t)a.cs_sender[fi * 5 + i] : 0u;
            code_addr[i] = frame_ok ? (uint32_t)a.cs_code_addr[fi * 5 + i] : 0u;
        }
        for (int i = 0; i < 4; i++)
            frame_u128[i] = frame_ok ? (uint32_t)a.cs_u128[fi * 4 + i] : 0u;
    }
    const uint32_t pc = scal[CS_PC];
    const uint32_t code_page = scal[CS_CODE_PAGE];
    const uint32_t ergs0 = scal[CS_ERGS_REMAINING];
    const uint32_t flags_word = scal[CS_FLAGS_WORD];
    const bool is_static = flags_word & 1;
    const bool is_local_frame = (flags_word >> 1) & 1;
    const uint32_t base_page = scal[CS_BASE_MEMORY_PAGE];
    const uint32_t heap_bound0 = scal[CS_HEAP_BOUND];
    const uint32_t aux_bound0 = scal[CS_AUX_HEAP_BOUND];

    // ---------------------------------------------------------- fetch
    const bool pending = L.pending;
    const uint32_t super_pc = pc >> 2, sub_pc = pc & 3;
    const bool code_read_needed = !pending &&
        (code_page != L.prev_code_page || super_pc != L.prev_super_pc);
    const int P = a.code_pages;
    uint64_t code_slot = 0;
    bool code_page_found = false;
    for (int p = 0; p < P; p++) {
        bool m = (uint32_t)a.cb_page[(uint64_t)b * P + p] == code_page &&
                 a.cb_valid[(uint64_t)b * P + p];
        if (m) { code_slot += p; code_page_found = true; }
    }
    const uint64_t code_n = (uint64_t)P * a.code_words;
    const int32_t *lane_code = a.code + (uint64_t)b * code_n * 8;
    if (code_read_needed &&
        (!code_page_found || super_pc >= (uint32_t)a.code_words))
        L.lane_error = true;
    U256 code_word = code_read_needed
        ? load_word(lane_code, code_n, code_slot * a.code_words + super_pc)
        : L.prev_code_word;
    const uint32_t new_prev_super_pc =
        (code_read_needed || pending) ? super_pc : L.prev_super_pc;

    const int lo_idx = 6 - 2 * (int)sub_pc;
    uint32_t insn_lo = pending ? PANIC_LO : code_word.w[lo_idx];
    uint32_t insn_hi = pending ? PANIC_HI : code_word.w[lo_idx + 1];
    bool new_pending = false;

    // ------------------------------------------------ decode + masking
    const uint32_t raw_variant = insn_lo & VARIANT_MASK;
    const uint32_t condition = (insn_lo >> 11) & 7;
    uint32_t src0_reg = (insn_lo >> 16) & 0xF, src1_reg = (insn_lo >> 20) & 0xF;
    uint32_t dst0_reg = (insn_lo >> 24) & 0xF, dst1_reg = (insn_lo >> 28) & 0xF;
    uint32_t imm0 = insn_hi & 0xFFFF, imm1 = (insn_hi >> 16) & 0xFFFF;

    uint32_t fam = 0;
    for (int f = 0; f < 16; f++) fam += raw_variant >= DC_START[f];
    fam -= 1;
    uint32_t rr = raw_variant - DC_START[fam];
    const uint32_t combo = rr % DC_N_FLAGS[fam];
    rr /= DC_N_FLAGS[fam];
    const uint32_t dst_i = rr % DC_N_DST[fam];
    rr /= DC_N_DST[fam];
    const uint32_t src_i = rr % DC_N_SRC[fam];
    const uint32_t sub_raw = rr / DC_N_SRC[fam];
    const uint32_t src0_mode_raw = DC_SRC_BASE[fam] + src_i;
    const uint32_t dst0_mode_raw = DC_DST_BASE[fam] + dst_i;
    const bool flag0_raw = combo & 1, flag1_raw = (combo >> 1) & 1;

    const bool invalid = fam == OP_INVALID;
    const bool requires_kernel =
        (fam == OP_CONTEXT && sub_raw >= CTX_SET_CONTEXT_U128) ||
        (fam == OP_LOG && sub_raw == LOG_PRECOMPILE_CALL) ||
        (fam == OP_FAR_CALL && sub_raw == FAR_MIMIC);
    const bool allowed_in_static = !(
        (fam == OP_LOG && sub_raw >= LOG_STORAGE_WRITE &&
         sub_raw <= LOG_TO_L1_MESSAGE) ||
        (fam == OP_CONTEXT && sub_raw == CTX_SET_CONTEXT_U128));

    const bool rich =
        (src0_mode_raw >= MODE_FULL_STACK_PUSH_POP &&
         src0_mode_raw != MODE_FULL_IMM16) ||
        (dst0_mode_raw >= MODE_FULL_STACK_PUSH_POP &&
         dst0_mode_raw <= MODE_FULL_ABS_STACK);
    const bool alu_like = fam <= OP_JUMP || fam == OP_SHIFT ||
                          fam == OP_BINOP || fam == OP_PTR;
    uint32_t price;
    if (alu_like || fam == OP_CONTEXT)
        price = rich ? RICH_ADDRESSING_OPCODE_ERGS : AVERAGE_OPCODE_ERGS;
    else if (fam == OP_LOG) {
        const uint32_t lp[5] = {STORAGE_READ_IO_PRICE, STORAGE_WRITE_IO_PRICE,
                                EVENT_IO_PRICE, L1_MESSAGE_IO_PRICE,
                                PRECOMPILE_CALL_BASE_PRICE};
        price = sub_raw < 5 ? lp[sub_raw] : 0;
    } else if (fam == OP_NEAR_CALL) price = NEAR_CALL_ERGS;
    else if (fam == OP_FAR_CALL) price = FAR_CALL_ERGS;
    else if (fam == OP_RET) price = RET_ERGS;
    else if (fam == OP_UMA) price = UMA_ERGS;
    else price = INVALID_OPCODE_ERGS;

    const bool not_enough = ergs0 < price;
    const uint32_t ergs1 = not_enough ? 0 : ergs0 - price;

    bool is_kernel = this_addr[0] < KERNEL_SPACE_BOUND;
    for (int i = 1; i < 5; i++) is_kernel = is_kernel && this_addr[i] == 0;
    const bool callstack_full = depth >= (int32_t)VM_MAX_STACK_DEPTH;
    const bool mask_panic = invalid || not_enough ||
        (requires_kernel && !is_kernel) || (!allowed_in_static && is_static) ||
        callstack_full;

    const bool lt_f = L.lt, eq_f = L.eq, gt_f = L.gt;
    const bool cond_table[8] = {true, gt_f, lt_f, eq_f, gt_f || eq_f,
                                lt_f || eq_f, !eq_f, gt_f || lt_f};
    const bool cond_met = cond_table[condition];
    const bool mask_nop = !cond_met && !mask_panic;
    const bool zeroed = mask_panic || mask_nop;
    if (zeroed) src0_reg = src1_reg = dst0_reg = dst1_reg = imm0 = imm1 = 0;

    const uint32_t opcode = mask_panic ? OP_RET : (mask_nop ? OP_NOP : fam);
    const uint32_t sub_variant = mask_panic ? RET_PANIC : (mask_nop ? 0 : sub_raw);
    const uint32_t src0_mode = mask_panic ? MODE_REG_ONLY
                             : (mask_nop ? MODE_FULL_REG : src0_mode_raw);
    const uint32_t dst0_mode = mask_panic ? MODE_REG_ONLY
                             : (mask_nop ? MODE_FULL_REG : dst0_mode_raw);
    const bool vflag0 = flag0_raw && !zeroed, vflag1 = flag1_raw && !zeroed;
    const bool set_flags = vflag0 &&
        ((opcode >= OP_ADD && opcode <= OP_DIV) || opcode == OP_SHIFT ||
         opcode == OP_BINOP);
    const bool swap_operands =
        (vflag1 && (opcode == OP_SUB || opcode == OP_DIV || opcode == OP_SHIFT)) ||
        (vflag0 && opcode == OP_PTR);
    const bool src0_can_ptr = opcode == OP_PTR || opcode == OP_RET ||
        opcode == OP_FAR_CALL ||
        (opcode == OP_UMA && sub_variant == UMA_FAT_POINTER_READ);
    const bool src1_can_ptr = opcode == OP_PTR;

    // ------------------------------------------- operand addressing
    const uint32_t sp0 = scal[CS_SP];
    U256 src0_reg_val;
    bool src0_reg_tag;
    read_reg(L, src0_reg, &src0_reg_val, &src0_reg_tag);
    const uint32_t vaddr0 = ((src0_reg_val.w[0] & 0xFFFF) + imm0) & 0xFFFF;
    const bool src0_pushpop = src0_mode == MODE_FULL_STACK_PUSH_POP;
    const bool src0_stack_off = src0_mode == MODE_FULL_STACK_OFFSET;
    const bool src0_abs = src0_mode == MODE_FULL_ABS_STACK;
    const bool src0_code = src0_mode == MODE_FULL_CODE_PAGE;
    const uint32_t sp1 = src0_pushpop ? ((sp0 - vaddr0) & 0xFFFF) : sp0;
    const uint32_t src0_loc = src0_pushpop ? sp1
        : (src0_stack_off ? ((sp1 - vaddr0) & 0xFFFF) : vaddr0);
    const bool src0_is_stack_mem = src0_pushpop || src0_stack_off || src0_abs;

    U256 dst0_reg_val;
    bool dst0_reg_tag_unused;
    read_reg(L, dst0_reg, &dst0_reg_val, &dst0_reg_tag_unused);
    const uint32_t vaddr1 = ((dst0_reg_val.w[0] & 0xFFFF) + imm1) & 0xFFFF;
    const bool dst0_pushpop = dst0_mode == MODE_FULL_STACK_PUSH_POP;
    const bool dst0_stack_off = dst0_mode == MODE_FULL_STACK_OFFSET;
    const bool dst0_abs = dst0_mode == MODE_FULL_ABS_STACK;
    const uint32_t sp2 = dst0_pushpop ? ((sp1 + vaddr1) & 0xFFFF) : sp1;
    const uint32_t dst0_loc = dst0_pushpop ? sp1
        : (dst0_stack_off ? ((sp2 - vaddr1) & 0xFFFF) : vaddr1);
    const bool dst0_is_stack_mem = dst0_pushpop || dst0_stack_off || dst0_abs;

    const bool is_nop_op = opcode == OP_NOP;
    const bool do_src0_mem_read = (src0_is_stack_mem || src0_code) && !is_nop_op;

    const uint64_t SW = a.stack_words;
    int32_t *lane_stack = a.stack + (uint64_t)b * SW * 8;
    uint8_t *lane_stag = a.stack_tag + (uint64_t)b * SW;
    uint32_t src0_phys;
    const bool src0_in_window = map_stack(a, src0_loc, &src0_phys);
    const U256 stack_val = load_word(lane_stack, SW, src0_phys);
    const bool stack_tag = src0_phys < SW ? lane_stag[src0_phys] != 0 : false;
    const U256 code_val = load_word(lane_code, code_n,
                                    code_slot * a.code_words + src0_loc);
    if (do_src0_mem_read && src0_is_stack_mem && !src0_in_window)
        L.lane_error = true;
    if (do_src0_mem_read && src0_code && src0_loc >= (uint32_t)a.code_words)
        L.lane_error = true;

    const U256 src0_mem_val = src0_code ? code_val : stack_val;
    const bool src0_mem_tag = !src0_code && stack_tag && do_src0_mem_read;
    const bool use_reg = src0_mode == MODE_REG_ONLY || src0_mode == MODE_FULL_REG ||
                         src0_mode == MODE_REG_OR_IMM_REG;
    const bool use_imm = src0_mode == MODE_FULL_IMM16 ||
                         src0_mode == MODE_REG_OR_IMM_IMM;
    U256 src0 = use_reg ? src0_reg_val : (use_imm ? u256_from32(imm0) : src0_mem_val);
    bool src0_tag = use_reg ? src0_reg_tag : (!use_imm && src0_mem_tag);
    U256 src1;
    bool src1_tag;
    read_reg(L, src1_reg, &src1, &src1_tag);
    if (swap_operands) {
        U256 t = src0; src0 = src1; src1 = t;
        bool tt = src0_tag; src0_tag = src1_tag; src1_tag = tt;
    }
    const uint32_t new_pc_lin = (pc + 1) & 0xFFFF;

    // pointer-taint erasure: clear page/start/length limbs
    if (src0_tag && !src0_can_ptr && !is_kernel) {
        src0.w[1] = src0.w[2] = src0.w[3] = 0;
        src0_tag = false;
    }
    if (src1_tag && !src1_can_ptr && !is_kernel) {
        src1.w[1] = src1.w[2] = src1.w[3] = 0;
        src1_tag = false;
    }

    // ============================================ opcode semantics
    const bool is_add = opcode == OP_ADD, is_sub = opcode == OP_SUB;
    const bool is_mul = opcode == OP_MUL, is_div = opcode == OP_DIV;
    const bool is_jump = opcode == OP_JUMP, is_ctx = opcode == OP_CONTEXT;
    const bool is_shift = opcode == OP_SHIFT, is_binop = opcode == OP_BINOP;
    const bool is_ptr = opcode == OP_PTR, is_near_call = opcode == OP_NEAR_CALL;
    const bool is_ret = opcode == OP_RET, is_uma = opcode == OP_UMA;
    // no LOG unit in the slice: LOG and FAR_CALL are unsupported
    if (opcode == OP_FAR_CALL || opcode == OP_LOG) L.lane_error = true;

    bool carry = false, borrow = false;
    const U256 sum_val = u256_add(src0, src1, &carry);
    const U256 diff_val = u256_sub(src0, src1, &borrow);
    U256 mul_lo = u256_zero(), mul_hi = u256_zero();
    if (is_mul) u256_mul_full(src0, src1, &mul_lo, &mul_hi);
    U256 div_q = u256_zero(), div_r = u256_zero();
    if (is_div) u256_divmod(src0, src1, &div_q, &div_r);
    const bool div_by_zero = u256_is_zero(src1);

    U256 shift_val = u256_zero();
    if (is_shift) {
        const uint32_t n = src1.w[0] & 0xFF;
        if (sub_variant == SHIFT_SHL) shift_val = u256_shl(src0, n);
        else if (sub_variant == SHIFT_SHR) shift_val = u256_shr(src0, n);
        else if (sub_variant == SHIFT_ROL)
            shift_val = u256_or(u256_shl(src0, n), u256_shr(src0, 256 - n));
        else
            shift_val = u256_or(u256_shr(src0, n), u256_shl(src0, 256 - n));
    }
    const U256 binop_val = sub_variant == 0 ? u256_xor(src0, src1)
        : (sub_variant == 1 ? u256_and(src0, src1) : u256_or(src0, src1));

    // ---------------------------------------------------- context
    U256 ctx_val = u256_zero();
    if (is_ctx) {
        const uint32_t cs = sub_variant;
        if (cs == CTX_THIS) for (int i = 0; i < 5; i++) ctx_val.w[i] = this_addr[i];
        else if (cs == CTX_CALLER) for (int i = 0; i < 5; i++) ctx_val.w[i] = msg_sender[i];
        else if (cs == CTX_CODE_ADDRESS) for (int i = 0; i < 5; i++) ctx_val.w[i] = code_addr[i];
        else if (cs == CTX_META) {
            const uint32_t sid = scal[CS_SHARD_IDS];
            ctx_val.w[0] = L.ergs_per_pubdata;
            ctx_val.w[2] = heap_bound0;
            ctx_val.w[3] = aux_bound0;
            ctx_val.w[7] = (sid & 0xFF) | (((sid >> 8) & 0xFF) << 8) |
                           (((sid >> 16) & 0xFF) << 16);
        } else if (cs == CTX_ERGS_LEFT) ctx_val.w[0] = ergs1;
        else if (cs == CTX_SP) ctx_val.w[0] = sp2;
        else for (int i = 0; i < 4; i++) ctx_val.w[i] = frame_u128[i];
    }
    const bool ctx_writes_dst = is_ctx && sub_variant <= CTX_GET_CONTEXT_U128;
    uint32_t new_ctx[4];
    for (int i = 0; i < 4; i++)
        new_ctx[i] = (is_ctx && sub_variant == CTX_SET_CONTEXT_U128)
            ? src0.w[i] : L.ctx[i];
    const uint32_t new_ergs_per_pubdata =
        (is_ctx && sub_variant == CTX_SET_ERGS_PER_PUBDATA_BYTE)
            ? src0.w[0] : L.ergs_per_pubdata;
    const uint32_t new_tx_number =
        (is_ctx && sub_variant == CTX_INCREMENT_TX_NUMBER)
            ? ((L.tx_number + 1) & 0xFFFF) : L.tx_number;

    // ---------------------------------------------------- ptr ops
    bool ptr_panic = false;
    U256 ptr_result = src0;
    if (is_ptr) {
        const uint32_t fp_offset = src0.w[0], fp_length = src0.w[3];
        const uint32_t s1 = src1.w[0];
        bool src1_ge_2_32 = false;
        for (int i = 1; i < 8; i++) src1_ge_2_32 |= src1.w[i] != 0;
        const uint32_t new_off_add = fp_offset + s1;
        const uint32_t new_off_sub = fp_offset - s1;
        const uint32_t new_len = fp_length - s1;
        ptr_panic = !src0_tag || src1_tag;
        ptr_panic |= sub_variant <= PTR_SUB && src1_ge_2_32;
        ptr_panic |= sub_variant == PTR_ADD && new_off_add < fp_offset;
        ptr_panic |= sub_variant == PTR_SUB && fp_offset < s1;
        ptr_panic |= sub_variant == PTR_PACK &&
            (src1.w[0] | src1.w[1] | src1.w[2] | src1.w[3]) != 0;
        ptr_panic |= sub_variant == PTR_SHRINK && fp_length < s1;
        if (sub_variant == PTR_ADD) ptr_result.w[0] = new_off_add;
        else if (sub_variant == PTR_SUB) ptr_result.w[0] = new_off_sub;
        else if (sub_variant == PTR_SHRINK) ptr_result.w[3] = new_len;
        else if (sub_variant == PTR_PACK)
            for (int i = 4; i < 8; i++) ptr_result.w[i] = src1.w[i];
    }
    const bool ptr_writes = is_ptr && !ptr_panic;

    // ---------------------------------------------------------- UMA
    const uint32_t us = sub_variant;
    const bool uma_is_heap = is_uma && (us == UMA_HEAP_READ || us == UMA_HEAP_WRITE);
    const bool uma_is_aux = is_uma && (us == UMA_AUX_HEAP_READ || us == UMA_AUX_HEAP_WRITE);
    const bool uma_is_ptr_read = is_uma && us == UMA_FAT_POINTER_READ;
    const bool uma_is_read = (is_uma && (us == UMA_HEAP_READ || us == UMA_AUX_HEAP_READ)) ||
                             uma_is_ptr_read;
    const bool uma_is_write = is_uma && !uma_is_read;
    const bool uma_increment = is_uma && vflag0;
    const uint32_t u_offset = src0.w[0], u_page_field = src0.w[1];
    const uint32_t u_start = src0.w[2], u_length = src0.w[3];
    const uint32_t heap_page = base_page + 2, aux_page = base_page + 3;

    const bool uma_exc_not_ptr = uma_is_ptr_read && !src0_tag;
    const bool uma_skip_oob_ptr = uma_is_ptr_read && !(u_offset < u_length);
    bool src0_gt_max = u_offset > MAX_OFFSET_TO_DEREF;
    for (int i = 1; i < 8; i++) src0_gt_max |= src0.w[i] != 0;
    const bool uma_exc_deref = (uma_is_heap || uma_is_aux) && src0_gt_max;
    const uint32_t src_byte_off = uma_is_ptr_read ? u_start + u_offset : u_offset;
    const uint32_t incremented = u_offset + 32;
    const bool uma_exc_incr = is_uma && incremented < u_offset;

    const uint32_t cur_bound = uma_is_heap ? heap_bound0 : aux_bound0;
    const bool growth_uf = incremented < cur_bound;
    const uint32_t growth = (growth_uf || !(uma_is_heap || uma_is_aux))
        ? 0 : incremented - cur_bound;
    const uint32_t new_heap_bound_u = (uma_is_heap && !growth_uf) ? incremented : heap_bound0;
    const uint32_t new_aux_bound_u = (uma_is_aux && !growth_uf) ? incremented : aux_bound0;
    uint32_t uma_cost = growth * MEMORY_GROWTH_ERGS_PER_BYTE;
    if (uma_exc_deref) uma_cost = 0xFFFFFFFFu;
    if (!is_uma) uma_cost = 0;
    const bool uma_no_ergs = ergs1 < uma_cost;
    const uint32_t ergs2 = uma_no_ergs ? 0 : ergs1 - uma_cost;
    const bool uma_set_panic = is_uma &&
        (uma_exc_not_ptr || uma_exc_deref || uma_exc_incr || uma_no_ergs);
    const bool uma_skip_mem = uma_skip_oob_ptr || uma_set_panic;

    const uint32_t word0 = src_byte_off >> 5, word1 = word0 + 1;
    const uint32_t unalign = src_byte_off & 31;
    const bool is_unaligned = unalign != 0;

    const int F = a.heap_frames;
    uint32_t ptr_heap_slot = 0, ptr_aux_slot = 0;
    bool hp_any = false, ap_any = false;
    for (int f = 0; f < F; f++) {
        if ((uint32_t)a.hp_page[(uint64_t)b * F + f] == u_page_field) {
            ptr_heap_slot += f; hp_any = true;
        }
        if ((uint32_t)a.ap_page[(uint64_t)b * F + f] == u_page_field) {
            ptr_aux_slot += f; ap_any = true;
        }
    }
    const bool ptr_page_is_heap = uma_is_ptr_read && hp_any;
    const bool ptr_page_is_aux = uma_is_ptr_read && !ptr_page_is_heap && ap_any;
    if (uma_is_ptr_read && !uma_skip_mem && !(ptr_page_is_heap || ptr_page_is_aux))
        L.lane_error = true;
    const bool use_heap_arena = uma_is_heap || ptr_page_is_heap;
    const bool use_aux_arena = uma_is_aux || ptr_page_is_aux;
    const uint32_t uma_slot = uma_is_ptr_read
        ? (ptr_page_is_heap ? ptr_heap_slot : ptr_aux_slot) : scal[CS_HEAP_SLOT];

    const bool do_mem = is_uma && !uma_skip_mem;
    if (do_mem && use_heap_arena && word1 >= (uint32_t)a.heap_words) L.lane_error = true;
    if (do_mem && use_aux_arena && word1 >= (uint32_t)a.aux_heap_words)
        L.lane_error = true;

    // the selected arena: heap if use_heap_arena, else the aux heap
    const uint32_t arena_words = use_heap_arena ? a.heap_words : a.aux_heap_words;
    const uint32_t m_base = uma_slot * arena_words;
    const uint64_t m_n = (uint64_t)F * arena_words;
    int32_t *lane_mem = (use_heap_arena ? a.heap : a.aux_heap) + (uint64_t)b * m_n * 8;
    const U256 w0 = do_mem ? load_word(lane_mem, m_n, (uint32_t)(m_base + word0))
                           : u256_zero();
    const U256 w1 = (do_mem && is_unaligned)
        ? load_word(lane_mem, m_n, (uint32_t)(m_base + word1)) : u256_zero();

    const uint32_t una_bits = unalign * 8;
    U256 read_val = u256_or(u256_shl(w0, una_bits), u256_shr(w1, 256 - una_bits));
    if (uma_is_ptr_read) {
        const uint32_t beyond = ((incremented < u_length || uma_skip_mem)
                                 ? 0 : incremented - u_length) & 31;
        read_val = u256_shl(u256_shr(read_val, beyond * 8), beyond * 8);
    }
    const uint32_t keep_hi_bits = (32 - unalign) * 8;
    const U256 new_w0 = u256_or(u256_shl(u256_shr(w0, keep_hi_bits), keep_hi_bits),
                                u256_shr(src1, una_bits));
    const U256 new_w1 = u256_or(u256_shr(u256_shl(w1, una_bits), una_bits),
                                u256_shl(src1, keep_hi_bits));
    const bool uma_do_write = uma_is_write && !uma_skip_mem;
    const bool uma_do_read_mem = is_uma && !uma_skip_mem;
    U256 incremented_src0 = src0;
    incremented_src0.w[0] = incremented;

    // ---------------------------------------------------- near call
    const uint32_t ergs_after = ergs2;   // no LOG unit in the slice
    const uint32_t nc_abi = src0.w[0];
    const bool nc_pass_all = nc_abi == 0 || nc_abi > ergs_after;
    const uint32_t nc_passed = nc_pass_all ? ergs_after : nc_abi;
    const uint32_t nc_left = nc_pass_all ? 0 : ergs_after - nc_abi;

    // ---------------------------------------------------------- ret
    const bool ret_is_panic0 = is_ret && sub_variant == RET_PANIC;
    const U256 ret_src0 = ret_is_panic0 ? u256_zero() : src0;
    const bool ret_src0_tag = src0_tag && !ret_is_panic0;
    uint32_t r_off = ret_src0.w[0], r_page = ret_src0.w[1];
    uint32_t r_start = ret_src0.w[2], r_len = ret_src0.w[3];
    uint32_t r_mode = (ret_src0.w[7] >> 8) & 0xFF;
    if (r_mode > 2) r_mode = 0;
    const bool r_fwd = r_mode == 1, r_use_aux = r_mode == 2;
    const bool nonlocal_ret = is_ret && !is_local_frame;
    const bool r_deref_exc = (uint32_t)(r_start + r_len) < r_start;
    const bool ret_panic1 = nonlocal_ret &&
        ((r_fwd && !ret_src0_tag) || (r_fwd && r_page < base_page) ||
         r_deref_exc || (!r_fwd && r_off != 0) || r_off > r_len);
    const bool ret_escalated = ret_is_panic0 || ret_panic1;
    if (ret_escalated) r_off = r_page = r_start = r_len = 0;
    if (nonlocal_ret && !ret_escalated) {
        if (r_fwd) {
            r_start = r_start + r_off;
            r_len = r_len - r_off;
            r_off = 0;
        } else {
            r_page = r_use_aux ? aux_page : heap_page;
        }
    }
    uint32_t r_upper = r_start + r_len;
    if (nonlocal_ret && r_deref_exc) r_upper = 0xFFFFFFFFu;
    const uint32_t r_bound = r_use_aux ? aux_bound0 : heap_bound0;
    const uint32_t r_growth = (r_upper < r_bound || !(nonlocal_ret && !r_fwd))
        ? 0 : r_upper - r_bound;
    const uint32_t r_cost = r_growth * MEMORY_GROWTH_ERGS_PER_BYTE;
    const bool r_no_ergs = ergs_after < r_cost;
    const uint32_t ergs3 = is_ret ? (r_no_ergs ? 0 : ergs_after - r_cost) : ergs_after;
    const bool ret_panic2 = nonlocal_ret && r_no_ergs;
    const bool ret_final_panic = ret_escalated || ret_panic2;
    if (ret_panic2) r_off = r_page = r_start = r_len = 0;
    const bool ret_panicked = is_ret && (sub_variant == RET_REVERT || ret_final_panic);
    const bool is_to_label = is_ret && vflag0;

    // ============================================ flags writeback
    const bool writes_flags = set_flags &&
        (is_add || is_sub || is_mul || is_div || is_shift || is_binop);
    const bool resets_flags = is_near_call || is_ret;
    bool n_lt = false, n_eq = false, n_gt = false;
    if (is_add) {
        n_eq = u256_is_zero(sum_val); n_lt = carry; n_gt = !n_eq && !carry;
    } else if (is_sub) {
        n_eq = u256_is_zero(diff_val); n_lt = borrow; n_gt = !n_eq && !borrow;
    } else if (is_mul) {
        n_lt = !u256_is_zero(mul_hi); n_eq = u256_is_zero(mul_lo);
        n_gt = !n_lt && !n_eq;
    } else if (is_div) {
        n_lt = div_by_zero;
        n_eq = u256_is_zero(div_q) && !div_by_zero;
        n_gt = u256_is_zero(div_r) && !div_by_zero;
    } else if (is_shift) {
        n_eq = u256_is_zero(shift_val);
    } else if (is_binop) {
        n_eq = u256_is_zero(binop_val);
    }
    bool f_lt = lt_f, f_eq = eq_f, f_gt = gt_f;
    if (writes_flags) { f_lt = n_lt; f_eq = n_eq; f_gt = n_gt; }
    else if (resets_flags) { f_lt = is_ret && ret_final_panic; f_eq = f_gt = false; }

    // ===================================== dst0 / dst1 selection
    U256 dst0_val = u256_zero();
    if (is_add) dst0_val = sum_val;
    else if (is_sub) dst0_val = diff_val;
    else if (is_mul) dst0_val = mul_lo;
    else if (is_div) dst0_val = div_by_zero ? u256_zero() : div_q;
    else if (is_shift) dst0_val = shift_val;
    else if (is_binop) dst0_val = binop_val;
    else if (is_ctx) dst0_val = ctx_val;
    else if (ptr_writes) dst0_val = ptr_result;
    else if (uma_is_read) dst0_val = read_val;
    else if (uma_is_write && uma_increment) dst0_val = incremented_src0;
    const bool dst0_is_ptr = ptr_writes;
    const bool dst0_write = is_add || is_sub || is_mul || is_div || is_shift ||
        is_binop || ctx_writes_dst || ptr_writes ||
        (uma_is_read && !uma_set_panic) ||
        (uma_is_write && uma_increment && !uma_set_panic);

    U256 dst1_val = u256_zero();
    if (is_mul) dst1_val = mul_hi;
    else if (is_div) dst1_val = div_by_zero ? u256_zero() : div_r;
    else if (uma_is_read && uma_increment) dst1_val = incremented_src0;
    const bool dst1_is_ptr = uma_is_read && uma_increment && src0_tag;
    const bool dst1_write = is_mul || is_div ||
        (uma_is_read && uma_increment && !uma_set_panic);

    new_pending = (is_ptr && ptr_panic) || uma_set_panic;

    // ====================================== pc + frame machinery
    uint32_t cur[NF];
    for (int f = 0; f < (int)NF; f++) cur[f] = scal[f];
    cur[CS_PC] = is_jump ? (src0.w[0] & 0xFFFF) : new_pc_lin;
    cur[CS_SP] = sp2;
    cur[CS_ERGS_REMAINING] = is_near_call ? nc_left : (is_ret ? 0 : ergs3);
    cur[CS_HEAP_BOUND] = is_uma ? new_heap_bound_u : heap_bound0;
    cur[CS_AUX_HEAP_BOUND] = is_uma ? new_aux_bound_u : aux_bound0;
    if (frame_ok) {
        const uint64_t fi = (uint64_t)b * D + depth;
        for (int f = 0; f < (int)NF; f++) a.cs_scalars[fi * NF + f] = (int32_t)cur[f];
    }
    if (is_near_call) {
        const int32_t push_idx = depth + 1 < D - 1 ? depth + 1 : D - 1;
        if (depth + 1 >= D) L.lane_error = true;
        if (push_idx >= 0) {
            uint32_t pushed[NF];
            for (int f = 0; f < (int)NF; f++) pushed[f] = cur[f];
            pushed[CS_PC] = imm0;
            pushed[CS_EXCEPTION_HANDLER] = imm1;
            pushed[CS_ERGS_REMAINING] = nc_passed;
            pushed[CS_FLAGS_WORD] = flags_word | 2;
            pushed[CS_JOURNAL_SNAPSHOT] = (uint32_t)a.j_count[b];
            pushed[CS_EVENT_SNAPSHOT] = (uint32_t)a.ev_count[b];
            const uint64_t pi = (uint64_t)b * D + push_idx;
            for (int f = 0; f < (int)NF; f++) a.cs_scalars[pi * NF + f] = (int32_t)pushed[f];
            for (int i = 0; i < 5; i++) {
                a.cs_this[pi * 5 + i] = (int32_t)this_addr[i];
                a.cs_sender[pi * 5 + i] = (int32_t)msg_sender[i];
                a.cs_code_addr[pi * 5 + i] = (int32_t)code_addr[i];
            }
            for (int i = 0; i < 4; i++) a.cs_u128[pi * 4 + i] = (int32_t)frame_u128[i];
        }
    }
    if (is_ret) {
        const int32_t parent_idx = depth - 1 > 0 ? depth - 1 : 0;
        if (parent_idx < D) {
            const uint64_t pi = (uint64_t)b * D + parent_idx;
            int32_t *par = a.cs_scalars + pi * NF;
            par[CS_ERGS_REMAINING] = (int32_t)((uint32_t)par[CS_ERGS_REMAINING] + ergs3);
            if (is_to_label && is_local_frame) par[CS_PC] = (int32_t)imm0;
            else if (ret_panicked) par[CS_PC] = (int32_t)scal[CS_EXCEPTION_HANDLER];
            if (is_local_frame) {
                par[CS_HEAP_BOUND] = (int32_t)heap_bound0;
                par[CS_AUX_HEAP_BOUND] = (int32_t)aux_bound0;
            }
        }
    }
    int32_t new_depth = depth + (is_near_call ? 1 : 0) - (is_ret ? 1 : 0);
    if (new_depth < 0) new_depth = 0;

    // ====================================== register writebacks
    if (dst0_write && !dst0_is_stack_mem && dst0_reg > 0)
        write_reg(L, dst0_reg, dst0_val, dst0_is_ptr);
    if (dst1_write && dst1_reg > 0) write_reg(L, dst1_reg, dst1_val, dst1_is_ptr);
    if (nonlocal_ret) {
        // r1 = returndata pointer, the rest of the file wiped
        for (int r = 0; r < 15; r++) {
            for (int l = 0; l < 8; l++) L.regs[r][l] = 0;
            L.rtag[r] = r == 0;
        }
        L.regs[0][0] = r_off; L.regs[0][1] = r_page;
        L.regs[0][2] = r_start; L.regs[0][3] = r_len;
        for (int i = 0; i < 4; i++) new_ctx[i] = 0;
    }

    // ======================================== memory writebacks
    const bool dst0_to_stack = dst0_write && dst0_is_stack_mem;
    uint32_t dst0_phys;
    const bool dst0_in_window = map_stack(a, dst0_loc, &dst0_phys);
    if (dst0_to_stack) {
        if (!dst0_in_window) L.lane_error = true;
        if (dst0_phys < SW) {
            store_word(lane_stack, SW, dst0_phys, dst0_val);
            lane_stag[dst0_phys] = dst0_is_ptr;
        }
    }
    if (uma_do_write) {
        store_word(lane_mem, m_n, (uint32_t)(m_base + word0), new_w0);
        if (is_unaligned) store_word(lane_mem, m_n, (uint32_t)(m_base + word1), new_w1);
    }

    // ====================================== memory witness slots
    const uint32_t ts0 = L.timestamp, ts3 = L.timestamp + 3;
    const uint32_t stack_page = base_page + 1;
    const uint32_t uma_page = uma_is_ptr_read ? u_page_field
                            : (uma_is_heap ? heap_page : aux_page);
    const uint32_t uma_type = uma_is_ptr_read ? 3 : (uma_is_aux ? 2 : 1);
    slots[0] = Slot{code_read_needed, 4, code_page, super_pc, 0, 0, ts0, code_word};
    slots[1] = Slot{do_src0_mem_read && src0_is_stack_mem, 0, stack_page, src0_loc,
                    stack_tag, 0, ts0, stack_val};
    slots[2] = Slot{do_src0_mem_read && src0_code, 4, code_page, src0_loc, 0, 0, ts0,
                    code_val};
    slots[3] = Slot{uma_do_read_mem, uma_type, uma_page, word0, 0, 0, ts0, w0};
    slots[4] = Slot{uma_do_read_mem && is_unaligned, uma_type, uma_page, word1, 0, 0,
                    ts0, w1};
    slots[5] = Slot{dst0_to_stack, 0, stack_page, dst0_loc, dst0_is_ptr, 1, ts3,
                    dst0_val};
    slots[6] = Slot{uma_do_write, uma_type, uma_page, word0, 0, 1, ts3, new_w0};
    slots[7] = Slot{uma_do_write && is_unaligned, uma_type, uma_page, word1, 0, 1, ts3,
                    new_w1};

    // ======================================== lane scalar updates
    L.lt = f_lt; L.eq = f_eq; L.gt = f_gt;
    L.timestamp += TIME_DELTA_PER_CYCLE;
    L.mcc += 1;
    L.ergs_per_pubdata = new_ergs_per_pubdata;
    L.tx_number = new_tx_number;
    L.pending = new_pending;
    L.prev_code_word = code_word;
    L.prev_super_pc = new_prev_super_pc;
    L.prev_code_page = code_page;
    for (int i = 0; i < 4; i++) L.ctx[i] = new_ctx[i];
    L.depth = new_depth;
    L.done = new_depth == 0;
}

// write one cycle's 8 slots at row `base` of a batch-last slot array
HD void emit_slots(const K1Args &a, int b, uint64_t base, const Slot *slots,
                   bool overflow, Lane &L) {
    const uint64_t B = a.batch;
    for (int s = 0; s < SLOTS_PER_CYCLE; s++) {
        const Slot &q = slots[s];
        bool v = q.valid;
        if (v && overflow) {
            L.lane_error = true;
            v = false;
        }
        const uint64_t row = base + s;
        a.q_meta[(row * 4 + 0) * B + b] = v ? (int32_t)q.ts : 0;
        a.q_meta[(row * 4 + 1) * B + b] = v ? (int32_t)q.type : 0;
        a.q_meta[(row * 4 + 2) * B + b] = v ? (int32_t)q.page : 0;
        a.q_meta[(row * 4 + 3) * B + b] = v ? (int32_t)q.index : 0;
        for (int l = 0; l < 8; l++)
            a.q_value[(row * 8 + l) * B + b] = v ? (int32_t)q.val.w[l] : 0;
        a.q_flags[row * B + b] = v ? (int32_t)(q.rw | (q.ptr << 1) | 4u) : 0;
        L.wq_count += v;
    }
}

HD void k1_run_lane(const K1Args &a, int b) {
    Lane L;
    for (int r = 0; r < 15; r++) {
        for (int l = 0; l < 8; l++) L.regs[r][l] = (uint32_t)a.regs[((uint64_t)b * 15 + r) * 8 + l];
        L.rtag[r] = a.reg_ptr[(uint64_t)b * 15 + r] != 0;
    }
    L.lt = a.flags[b * 3 + 0] != 0;
    L.eq = a.flags[b * 3 + 1] != 0;
    L.gt = a.flags[b * 3 + 2] != 0;
    L.timestamp = a.timestamp[b];
    L.mcc = a.mcc[b];
    L.ergs_per_pubdata = a.ergs_per_pubdata[b];
    L.tx_number = a.tx_number[b];
    L.pending = a.pending[b] != 0;
    for (int l = 0; l < 8; l++) L.prev_code_word.w[l] = (uint32_t)a.prev_code_word[(uint64_t)b * 8 + l];
    L.prev_super_pc = a.prev_super_pc[b];
    L.prev_code_page = a.prev_code_page[b];
    for (int i = 0; i < 4; i++) L.ctx[i] = (uint32_t)a.context_u128[(uint64_t)b * 4 + i];
    L.depth = a.depth[b];
    L.done = a.done[b] != 0;
    L.lane_error = a.lane_error[b] != 0;
    L.wq_count = a.wq_count[b];

    const int n = a.k_stop < a.k_cycles ? a.k_stop : a.k_cycles;
    const int64_t step0 = *a.step0;
    Slot slots[SLOTS_PER_CYCLE];
    for (int c = 0; c < n; c++) {
        if (L.done) {
            // a frozen lane writes nothing but its all-zero slot rows
            for (int s = 0; s < SLOTS_PER_CYCLE; s++) slots[s].valid = false;
        } else {
            lane_cycle(a, b, L, slots);
        }
        if (a.emit_mode == 1) {
            const int64_t pos = (step0 + c) * SLOTS_PER_CYCLE;
            const int64_t last = (int64_t)a.queue_capacity - SLOTS_PER_CYCLE;
            emit_slots(a, b, pos < last ? pos : last, slots, pos > last, L);
        } else if (a.emit_mode == 2) {
            emit_slots(a, b, (uint64_t)c * SLOTS_PER_CYCLE, slots, false, L);
        }
    }

    for (int r = 0; r < 15; r++) {
        for (int l = 0; l < 8; l++) a.regs[((uint64_t)b * 15 + r) * 8 + l] = (int32_t)L.regs[r][l];
        a.reg_ptr[(uint64_t)b * 15 + r] = L.rtag[r];
    }
    a.flags[b * 3 + 0] = L.lt;
    a.flags[b * 3 + 1] = L.eq;
    a.flags[b * 3 + 2] = L.gt;
    a.timestamp[b] = (int32_t)L.timestamp;
    a.mcc[b] = (int32_t)L.mcc;
    a.ergs_per_pubdata[b] = (int32_t)L.ergs_per_pubdata;
    a.tx_number[b] = (int32_t)L.tx_number;
    a.pending[b] = L.pending;
    for (int l = 0; l < 8; l++) a.prev_code_word[(uint64_t)b * 8 + l] = (int32_t)L.prev_code_word.w[l];
    a.prev_super_pc[b] = (int32_t)L.prev_super_pc;
    a.prev_code_page[b] = (int32_t)L.prev_code_page;
    for (int i = 0; i < 4; i++) a.context_u128[(uint64_t)b * 4 + i] = (int32_t)L.ctx[i];
    a.depth[b] = L.depth;
    a.done[b] = L.done;
    a.lane_error[b] = L.lane_error;
    a.global_step[b] += n;
    if (a.emit_mode == 1) a.wq_count[b] = L.wq_count;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) k1_kernel(const K1Args a) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < a.batch) k1_run_lane(a, b);
}

extern "C" int eravm_k1_launch(const K1Args *args, void *stream) {
    const int threads = 128;
    const int blocks = (args->batch + threads - 1) / threads;
    k1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
#endif
