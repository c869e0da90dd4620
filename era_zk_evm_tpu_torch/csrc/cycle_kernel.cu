// K1: the K-cycle EraVM interpreter, one thread per lane (CUDA C++, sm_90a).
//
// Replaces the TPU kernel era_zk_evm_tpu/models/fused_cycle.py::_build_kernel
// (:2794, wrapped by _build_call, driven by _run_chunk) in all five of its
// slices.  (a) the memory-witness slice: NOP ADD SUB MUL DIV JUMP CONTEXT
// SHIFT BINOP PTR NEAR_CALL RET UMA, with register, stack and code
// addressing, heap and aux heap, the memory witness queue (mode a) and / or a
// chunk slot block for the rolling fold K2 (mode b).  (b) LOG and (c) FAR_CALL,
// compiled in only for storage_slots > 0 (template <bool kLog>, as the JAX
// engine's static log_enabled): storage reads and writes with pubdata ergs,
// events, the journal and its rollback on a panicked pop, far calls with the
// code-hash read, decommit from the code bank and fresh heap frames, and the
// log and decommit witness queues.  (d) the keccak256 and sha256 precompile
// units (the TPU kernel's precompile unit, fused_cycle.py:1395-1600), compiled
// in only for storage_slots > 0 and precompile_keccak_blocks > 0 (template
// <kLog, kPrecomp>, as the JAX engines' pp_enabled), with the rows of the
// round-witness queue.  (e) ecrecover (secp256k1.cuh), compiled in only with
// the units and precompile_ecrecover (template <kLog, kPrecomp, kEc>): the
// TPU kernel only detects ecrecover cycles (ec_first_blk) and its wrapper
// runs each on the jnp engine (_run_cycles_fused_ec, :3752); here the lane
// recovers the signature in the cycle, writes the ok word and the address and
// two round-witness out rows.  Without kLog, LOG and FAR_CALL set lane_error,
// as the JAX engine does with storage_slots == 0; without kPrecomp,
// log.precompile does.
// Its plain version is era_zk_evm_tpu_torch/models/batched_vm.py::cycle_step;
// both follow era_zk_evm_tpu/models/batched_vm.py::cycle_step section by
// section, and the smoke run holds them equal bit for bit.
//
// Design.  The TPU kernel keeps a tile of lanes in VMEM and reaches every
// per-lane index through one-hot sweeps over whole arenas (_onehot_l,
// _gather_l, _scatter_l), packs state batch-last (_pack/_unpack) and gates
// work with pl.when.  None of that is carried over: a thread owns one lane,
// loads by index and branches.  The register file lives in shared memory for
// the whole launch (its dynamic register index would otherwise be a
// local-memory round trip), flags and lane scalars in registers; the
// callstack frame is read from and written to global memory each cycle.
// k_stop is always honoured.  Each cycle writes its 8 memory-query slots
// straight into the persistent queue at min(step * 8, cap - 8) (mode a),
// valid or not (the queue is the reference's layout), and, with the
// rolling commitment, appends its valid slots alone to the lane's rows of
// the chunk block (mode b), whose count a lane writes at the end of the
// launch: K2 then reads only records (PERF.md: about 11% of the slots on
// WORKLOAD).  Both are batch-last, so a warp's stores coalesce wherever
// its lanes write one row.
// With kLog, the storage lookup is a per-lane loop over the S slots of
// st_key; journal and event entries are per-lane appends; a panicked pop
// replays the lane's journal newest-first down to the frame's snapshot (the
// batch-wide while_loop of the JAX engine becomes a per-lane loop); a far
// call binds its code by a per-lane search of cb_hash and takes pages from
// page_counter; each cycle writes one log row and one decommit row, all-zero
// when the lane emitted nothing, into lq_* and dq_* at min(step, cap - 1).
//
// Memory layout.  Every per-lane array indexed by something other than the
// lane (code, stack and its tags, heap, aux heap, their frame pages, the
// callstack, storage slots, journal, events, code bank, log and decommit
// queues) is lane-last in the port's state: [n, 8, B] for a word arena,
// element k of lane b at k * B + b (ll()).  A warp whose lanes read one
// index — the bench workloads run one program in every lane in lockstep,
// the storage and code-bank searches walk every slot, and the queue rows go
// at one position a cycle — then reads 8 runs of 128 contiguous bytes for a
// word, where a lane-major [B, n, 8] arena costs a 32-byte sector a lane
// per limb (P6's word reads: 0.35 against 2.40 us a gather at 32768 lanes;
// PERF.md).  The register file, flags, lane scalars and the previous code
// word are read once a launch, lane-first, with 128-bit accesses; in
// shared memory the register file is lane-last too (RF_WORDS words a
// lane, stride blockDim.x), so every access is bank-conflict free.
//
// What bounds it on an H100: latency, not bytes (K1 runs far above its
// byte floor): each warp's chain of dependent reads, the frame scalars and
// spills in local memory (ptxas: 255 registers, 352-2896 byte frames,
// spills in the kLog, kPrecomp and kEc instances), at most 8 warps an SM,
// and a warp whose lanes diverge (other programs, other indexes) pays a
// sector a lane again.  The launch picks its block size from the SM count
// so that a small batch still spans every SM (k1_block_threads).
//
// The precompile units (kPrecomp) run inline in the cycle, entered only by a
// lane whose cycle is a precompile call.  A call reads its input words from
// its heap or aux-heap frame once (at most PS_IN words, after one walk over
// the frames for both pages) into a window in shared memory beside the
// register file, lane-last like it; the mem_in rows and the hash both read
// them there.  keccak256 builds each 64-bit rate lane from two or three
// 32-bit chunks of the window (a funnel shift by in_off & 3 bytes, a byte
// swap) with the bytes past in_len masked and the padding XORed in by byte
// index, so no per-lane byte array exists; the permutation is the unit's
// own (keccak.cuh: keccak_f1600_unit, rotations as immediates), and sha256
// runs its rounds in trips of 16 (sha256.cuh), so the code a call fetches
// stays small.  A lane writes its round-witness rows into a per-chunk
// scratch block pq_*_blk[K, PS, ., B] (batch-last, so a warp's stores
// coalesce) with an emit word and a slot count per cycle: only the rows
// that carry data (the call's mem_in rows, at most PS_IN, and its one or
// two mem_out rows), which the emit word names (PQ_EMIT, common.cuh); the
// block's other rows stay unwritten.  The queue's block clock is
// batch-global (it advances on every cycle in which any lane ran a unit), a
// dependency across lanes that one launch of independent threads cannot
// resolve: the splice kernel (pq_splice.cu, launched by
// models/fused_cycle.py::splice_rows after K1) moves the data rows into the
// queue and writes zeros for the rest, as the TPU kernel's wrapper does
// (:3529-3588); it writes only the blocks that survive, so it is bound by
// those bytes.
// What bounds the units (PERF.md §6, measured on an H100): not their
// operations (the units alone, units_kernel, run a call a thread at 2.7x
// their keccak-f and compression count) but what a call costs inside
// K1's 255-register cycle: out of line, the call (and the frame it read
// through generic addresses, before K1Args became a __grid_constant__)
// cost more than the hashing, so the unit is inlined; the window's
// shared memory leaves L1 ~28 of ~92 KB; and the divergence between unit
// lanes and the rest of a warp.  The ecrecover unit (secp256k1.cuh, some
// 3,400 field multiplications and squares) stays out of line.  The kEc
// instance is a fourth one so that the other three keep their code and
// register allocation; cycle_kernel_ec.cu compiles it, in an nvcc process
// of its own beside this file's, and the launch chooses it by an argument.

#include "common.cuh"
#include "keccak.cuh"
#include "secp256k1.cuh"
#include "sha256.cuh"
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
    // LOG / FAR_CALL state, read only by the kLog instance
    int32_t *spent_pubdata;
    int32_t *st_key;        // [B, S, 14]
    int32_t *st_val;        // [B, S, 8]
    uint8_t *st_used;       // [B, S]
    int32_t *st_count;
    int32_t *j_slot;        // [B, J]
    int32_t *j_prev;        // [B, J, 8]
    int32_t *ev_key, *ev_val;  // [B, E, 8]
    int32_t *ev_meta;       // [B, E, 2]
    uint8_t *ev_cancelled;  // [B, E]
    int32_t *lq_meta;       // [B, LQ, 4]
    int32_t *lq_addr;       // [B, LQ, 5]
    int32_t *lq_key, *lq_read, *lq_written;  // [B, LQ, 8]
    int32_t *lq_count;
    int32_t *dq_hash;       // [B, DQ, 8]
    int32_t *dq_meta;       // [B, DQ, 4]
    int32_t *dq_count;
    int32_t *cb_hash;       // [B, P, 8]
    int32_t *default_aa_hash;  // [B, 8]
    int32_t *frame_count, *page_counter;
    uint8_t *done, *lane_error;
    int32_t *global_step, *wq_count;
    int32_t *q_meta;        // [rows, 4, B]: the persistent memory queue
    int32_t *q_value;       // [rows, 8, B]
    int32_t *q_flags;       // [rows, B]
    int32_t *blk_meta;      // [K * 8, 4, B]: the chunk's records K2 folds,
    int32_t *blk_value;     // [K * 8, 8, B]  each lane's valid slots
    int32_t *blk_flags;     // [K * 8, B]     compacted into rows 0, 1, ...
    int32_t *blk_count;     // [B]: each lane's rows, written at the end
    const int32_t *step0;   // device scalar: min(global_step) of the batch
    // per-chunk round-witness scratch, read only by the kPrecomp instance
    // with a precompile queue: the data rows of the emitting lanes, and per
    // cycle each lane's emit word (PQ_EMIT) and slot count
    int32_t *pq_meta_blk;   // [K, PS, 4, B]
    int32_t *pq_value_blk;  // [K, PS, 8, B]
    int32_t *pq_flags_blk;  // [K, PS, B]
    int32_t *pq_emit_blk;   // [K, B]
    int32_t *pq_nslots_blk; // [K, B]
    int batch, max_depth, code_words, code_pages, stack_words;
    int stack_abs_words;    // -1: one window
    int stack_sp_base, heap_words, aux_heap_words, heap_frames;
    int queue_capacity;
    int storage_slots, journal_slots, event_slots;
    int log_queue_capacity, decommit_queue_capacity;
    int emit_queue;         // 1: each cycle's slots into the queue q_*
    int emit_block;         // 1: each cycle's slots into the block blk_*
    int k_cycles, k_stop;
    int keccak_blocks, sha_rounds;  // the units' limits (MK, MS)
    int pq_slots_in;        // PS_IN; a call's row block is PS_IN + PS_OUT
                            // rows, PS_OUT 2 in the kEc instance, else 1
    int pq_capacity;        // 0: no round-witness queue
};

struct Slot {
    bool valid;
    uint32_t type, page, index, ptr, rw, ts;
    U256 val;
};

// one cycle's log-queue row and decommit-queue row
struct LogRow {
    bool valid;
    uint32_t meta[4], addr[5];
    U256 key, read, written;
};

struct DecRow {
    bool valid;
    uint32_t meta[4];
    U256 hash;
};

// Every per-lane array K1 indexes by something other than the lane is
// lane-last (models/state.py, LANE_LAST_FIELDS): element k of lane b's row
// lies at k * B + b, so the lanes of a warp at one index read one
// contiguous run.
HD uint64_t ll(const K1Args &a, int b, uint64_t k) {
    return k * (uint64_t)a.batch + b;
}

// 256-bit row `row` of lane b in a lane-last array [rows, 8, B]
HD U256 load_row(const K1Args &a, const int32_t *arr, int b, uint64_t row) {
    U256 r;
    for (int l = 0; l < 8; l++) r.w[l] = (uint32_t)arr[ll(a, b, row * 8 + l)];
    return r;
}

HD void store_row(const K1Args &a, int32_t *arr, int b, uint64_t row,
                  const U256 &v) {
    for (int l = 0; l < 8; l++) arr[ll(a, b, row * 8 + l)] = (int32_t)v.w[l];
}

// word idx of lane b's word arena [n_words, 8, B]; outside it reads zeros
// and takes no store
HD U256 load_word(const K1Args &a, const int32_t *arena, int b,
                  uint64_t n_words, uint64_t idx) {
    return idx < n_words ? load_row(a, arena, b, idx) : u256_zero();
}

HD void store_word(const K1Args &a, int32_t *arena, int b, uint64_t n_words,
                   uint64_t idx, const U256 &v) {
    if (idx < n_words) store_row(a, arena, b, idx, v);
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

// The register file: limb l of register r + 1 at rf[(r * 8 + l) * rs], its
// pointer tag at rf[(RF_TAGS + r) * rs].  On the card it lies in shared
// memory, lane-last (rs = blockDim.x), so a dynamic register index is a
// conflict-free shared-memory access and not a local-memory round trip.
// One word more, rf[RF_CURSOR * rs], holds the lane's next free row of the
// chunk's record block (mode b), so that no register carries it through
// the launch.  In the kPrecomp and kEc instances the precompile units'
// window of PS_IN input words follows, rf[(RF_WORDS + m) * rs]
// (precompile_unit).
#define RF_TAGS (15 * 8)
#define RF_CURSOR (RF_TAGS + 15)
#define RF_WORDS (RF_CURSOR + 1)

// the words a lane keeps in shared memory (host and device code): the
// register file and, in an instance with the units, their window (8
// chunks a word of PS_IN)
#define K1_LANE_WORDS(units, pq_slots_in) \
    (RF_WORDS + ((units) ? 8 * (pq_slots_in) : 0))

struct Lane {
    uint32_t *rf;
    uint32_t rs;
    bool lt, eq, gt;
    uint32_t timestamp, mcc, ergs_per_pubdata, tx_number;
    bool pending;
    U256 prev_code_word;
    uint32_t prev_super_pc, prev_code_page;
    uint32_t ctx[4];
    int32_t depth;
    bool done, lane_error;
    int32_t wq_count;
    uint32_t spent_pubdata, page_counter;
    int32_t st_count, j_count, ev_count, lq_count, dq_count, frame_count;
    uint32_t pq_emit, pq_nslots;   // this cycle's round-witness block
};

// 32 contiguous bytes (a lane-first [B, 8] row): two 128-bit accesses on
// the card
HD U256 load_u256(const int32_t *p) {
    U256 r;
#ifdef __CUDA_ARCH__
    const int4 x = ((const int4 *)p)[0], y = ((const int4 *)p)[1];
    r.w[0] = x.x; r.w[1] = x.y; r.w[2] = x.z; r.w[3] = x.w;
    r.w[4] = y.x; r.w[5] = y.y; r.w[6] = y.z; r.w[7] = y.w;
#else
    for (int l = 0; l < 8; l++) r.w[l] = (uint32_t)p[l];
#endif
    return r;
}

HD void store_u256(int32_t *p, const U256 &v) {
#ifdef __CUDA_ARCH__
    ((int4 *)p)[0] = make_int4(v.w[0], v.w[1], v.w[2], v.w[3]);
    ((int4 *)p)[1] = make_int4(v.w[4], v.w[5], v.w[6], v.w[7]);
#else
    for (int l = 0; l < 8; l++) p[l] = (int32_t)v.w[l];
#endif
}

HD bool addr_is_kernel(const uint32_t *addr5) {
    bool k = addr5[0] < KERNEL_SPACE_BOUND;
    for (int i = 1; i < 5; i++) k = k && addr5[i] == 0;
    return k;
}

HD uint32_t &reg_limb(const Lane &L, uint32_t r, int l) {
    return L.rf[(r * 8 + l) * L.rs];
}

HD uint32_t &reg_tag(const Lane &L, uint32_t r) {
    return L.rf[(RF_TAGS + r) * L.rs];
}

HD uint32_t &blk_cursor(const Lane &L) { return L.rf[RF_CURSOR * L.rs]; }

HD void read_reg(const Lane &L, uint32_t idx, U256 *v, bool *tag) {
    // r0 reads as zero
    if (idx == 0 || idx > 15) {
        *v = u256_zero();
        *tag = false;
        return;
    }
    for (int l = 0; l < 8; l++) v->w[l] = reg_limb(L, idx - 1, l);
    *tag = reg_tag(L, idx - 1) != 0;
}

HD void write_reg(Lane &L, uint32_t idx, const U256 &v, bool tag) {
    for (int l = 0; l < 8; l++) reg_limb(L, idx - 1, l) = v.w[l];
    reg_tag(L, idx - 1) = tag;
}

// (on the heap, on the aux heap, frame slot) of the read page and of the
// write page, heap frames first: one walk over the lane's frames
HD void page_slots(const K1Args &a, int b, uint32_t page_r, uint32_t page_w,
                   bool *r_on_h, bool *r_on_a, uint32_t *r_slot,
                   bool *w_on_h, bool *w_on_a, uint32_t *w_slot) {
    uint32_t rh = 0, ra = 0, wh = 0, wa = 0;
    bool rh_ok = false, ra_ok = false, wh_ok = false, wa_ok = false;
    for (int f = 0; f < a.heap_frames; f++) {
        const uint32_t hp = (uint32_t)a.hp_page[ll(a, b, f)];
        const uint32_t ap = (uint32_t)a.ap_page[ll(a, b, f)];
        if (hp == page_r) { rh += f; rh_ok = true; }
        if (ap == page_r) { ra += f; ra_ok = true; }
        if (hp == page_w) { wh += f; wh_ok = true; }
        if (ap == page_w) { wa += f; wa_ok = true; }
    }
    *r_on_h = rh_ok;
    *r_on_a = !rh_ok && ra_ok;
    *r_slot = rh_ok ? rh : ra;
    *w_on_h = wh_ok;
    *w_on_a = !wh_ok && wa_ok;
    *w_slot = wh_ok ? wh : wa;
}

// The frame a unit reads: word idx of it is word base + idx (u32
// arithmetic) of lane b's lane-last word arena [n_words, 8, batch]; outside
// the arena it reads zeros.  K1 points it at a heap or aux-heap frame; the
// units-alone kernel at its staged inputs.
struct UnitFrame {
    const int32_t *arena;
    uint64_t n_words, batch;
    uint32_t base;
    int b;
};

HD U256 unit_word(const UnitFrame &f, uint32_t idx) {
    const uint32_t i = f.base + idx;
    U256 r = u256_zero();
    if (i < f.n_words)
        for (int l = 0; l < 8; l++)
            r.w[l] = (uint32_t)f.arena[((uint64_t)i * 8 + l) * f.batch + f.b];
    return r;
}

// The unit's window: a call's input words, each read from the frame once,
// as big-endian 32-bit chunks in stream order (chunk 8 i + j is limb 7 - j
// of word i) at win[m * rs].  K1 keeps it in shared memory after the
// register file, lane-last like it (PS_IN words a lane, 320 B at the bench
// configs' PS_IN = 10), so that its run-time indexes are conflict-free
// shared-memory accesses and not local memory.
HD uint32_t &win_chunk(uint32_t *win, uint32_t rs, uint32_t m) {
    return win[m * rs];
}

// words first, first + 1, ... (u32) of the frame into chunks 0, 8, ...:
// every load issued before any store to global memory, so they overlap
HD void stage_words(const UnitFrame &f, uint32_t first, uint32_t count,
                    uint32_t *win, uint32_t rs) {
#ifdef __CUDACC__
#pragma unroll 2
#endif
    for (uint32_t i = 0; i < count; i++) {
        const U256 v = unit_word(f, first + i);
        for (int j = 0; j < 8; j++) win_chunk(win, rs, 8 * i + j) = v.w[7 - j];
    }
}

HD U256 window_word(uint32_t *win, uint32_t rs, uint32_t i) {
    U256 r;
    for (int l = 0; l < 8; l++) r.w[l] = win_chunk(win, rs, 8 * i + 7 - l);
    return r;
}

HD uint32_t unit_bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __byte_perm(x, 0, 0x0123);
#else
    return __builtin_bswap32(x);
#endif
}

// the high word of (hi:lo) << s, s in 0..31
HD uint32_t funnel_hi(uint32_t lo, uint32_t hi, uint32_t s) {
#ifdef __CUDA_ARCH__
    return __funnelshift_l(lo, hi, s);
#else
    return s ? (hi << s) | (lo >> (32 - s)) : hi;
#endif
}

// The keccak unit's input geometry: nb = min(kc_blocks, MK) blocks absorb
// the first g_end = min(in_len, nb * 136) bytes at byte in_off; blocks from
// kw on start past byte 2**32, where the reference's u32 byte offset wraps
// to the arena's start (kw = nb when none does).
struct KeccakCall {
    uint32_t in_off, in_len, kc_blocks, nb, g_end, kw;
};

HD KeccakCall keccak_call(uint32_t in_off, uint32_t in_len, uint32_t mk) {
    KeccakCall k;
    k.in_off = in_off;
    k.in_len = in_len;
    k.kc_blocks = in_len / 136u + 1u;
    k.nb = k.kc_blocks < mk ? k.kc_blocks : mk;
    k.g_end = in_len < k.nb * 136u ? in_len : k.nb * 136u;
    const uint64_t to_wrap = (1ull << 32) - in_off;   // bytes before 2**32
    const uint64_t kw = (to_wrap + 135) / 136;
    k.kw = kw < k.nb ? (uint32_t)kw : k.nb;
    return k;
}

// the words that bytes [g0, g1) of the stream span from a start at byte
// `sh` of the window's first word
HD uint32_t span_words(uint32_t sh, uint32_t g0, uint32_t g1) {
    return g1 > g0 ? ((sh + g1 - g0 - 1) >> 5) + 1 : 0u;
}

// the words the sponge reads from the call's first word, in_off >> 5
HD uint32_t keccak_words(const KeccakCall &k) {
    const uint32_t g1 = k.g_end < k.kw * 136u ? k.g_end : k.kw * 136u;
    return span_words(k.in_off & 31, 0, g1);
}

// keccak256 of the call's bytes from the window (its first word in_off >>
// 5): per block, its 17 rate lanes from 32-bit chunks (two or three a lane,
// a funnel shift by in_off & 3 bytes, a byte swap), the bytes from in_len on
// masked to zero, the 0x01 and 0x80 padding XORed in by the lane's byte
// index; at block kw the window is reloaded from the wrapped offset.
HD U256 keccak_window(const UnitFrame &f, const KeccakCall &k, uint32_t *win,
                      uint32_t rs) {
    const uint32_t kc_last = k.kc_blocks * 136u - 1u;
    const uint32_t s = 8 * (k.in_off & 3);
    uint64_t st[25];
    for (int i = 0; i < 25; i++) st[i] = 0;
    uint32_t boff = k.in_off & 31;     // the block's first byte in the window
    for (uint32_t blk = 0; blk < k.nb; blk++) {
        if (blk == k.kw) {
            const uint32_t wrapped = k.in_off + blk * 136u;   // mod 2**32
            boff = wrapped & 31;
            stage_words(f, wrapped >> 5,
                        span_words(boff, blk * 136u, k.g_end), win, rs);
        }
        const uint32_t m = boff >> 2;
        uint32_t c0 = win_chunk(win, rs, m);
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int l = 0; l < 17; l++) {
            const uint32_t c1 = win_chunk(win, rs, m + 2 * l + 1);
            const uint32_t c2 = win_chunk(win, rs, m + 2 * l + 2);
            uint64_t x = (uint64_t)unit_bswap32(funnel_hi(c1, c0, s))
                | (uint64_t)unit_bswap32(funnel_hi(c2, c1, s)) << 32;
            c0 = c2;
            const uint32_t g0 = blk * 136u + 8u * l;
            const uint32_t rem = k.in_len - g0;       // g0 <= in_len: bytes left
            const uint32_t pad = kc_last - g0;
            x &= k.in_len <= g0 ? 0ull
                : (rem >= 8 ? ~0ull : (1ull << (8 * rem)) - 1);
            if (rem < 8) x ^= 1ull << (8 * rem);
            if (pad < 8) x ^= 0x80ull << (8 * pad);
            st[l] ^= x;
        }
        keccak_f1600_unit(st);
        boff += 136;
    }
    // the digest's 32 little-endian lane bytes, as one big-endian word
    U256 out;
    for (int w = 0; w < 4; w++) {
        const uint64_t v = st[3 - w];
        out.w[2 * w] = unit_bswap32((uint32_t)(v >> 32));
        out.w[2 * w + 1] = unit_bswap32((uint32_t)v);
    }
    return out;
}

// the sha256 state after `rounds` compressions of window words 2 k, 2 k + 1
// (chunks 16 k ...), as one big-endian word
HD U256 sha_window(uint32_t *win, uint32_t rs, uint32_t rounds) {
    uint32_t st[8];
    for (int i = 0; i < 8; i++) st[i] = SHA256_IV[i];
    for (uint32_t k = 0; k < rounds; k++) {
        uint32_t blk[16];
        for (int i = 0; i < 16; i++) blk[i] = win_chunk(win, rs, 16 * k + i);
        sha256_compress(st, blk);
    }
    U256 out;
    for (int i = 0; i < 8; i++) out.w[i] = st[7 - i];
    return out;
}

// The keccak256 / sha256 units alone (units_kernel, cycle_kernel_ec.cu; on
// the host eravm_units_host), a call a lane: lane i's frame is word base
// of its arena [n_words, 8, n], call[i] = (kind: 0 keccak256, 1 sha256;
// base; in_off; in_len; rounds), as K1's unit reads them; the output word
// and whether the call exceeds the unit's limits (MK blocks, MS rounds).
struct UnitsArgs {
    const int32_t *arena, *call;
    int32_t *out, *err;     // [n, 8], [n]
    int n, n_words, keccak_blocks, sha_rounds, ps_in;
};

HD void units_lane(const UnitsArgs &a, int i, uint32_t *win, uint32_t rs) {
    const int32_t *c = a.call + 5 * (uint64_t)i;
    const uint32_t in_off = c[2], in_len = c[3], rounds = c[4];
    const UnitFrame f = {a.arena, (uint64_t)a.n_words, (uint64_t)a.n,
                         (uint32_t)c[1], i};
    const uint32_t ms = a.sha_rounds > 1 ? a.sha_rounds : 1;
    const uint32_t ps_in = a.ps_in;
    U256 out;
    bool err;
    if (c[0] != 0) {
        const uint32_t n = rounds < ms ? rounds : ms;
        stage_words(f, in_off, 2 * n, win, rs);
        out = sha_window(win, rs, n);
        err = rounds > ms;
    } else {
        const KeccakCall kc = keccak_call(in_off, in_len,
                                          (uint32_t)a.keccak_blocks);
        const uint32_t words = keccak_words(kc);
        stage_words(f, in_off >> 5, words < ps_in ? words : ps_in, win, rs);
        out = keccak_window(f, kc, win, rs);
        err = kc.kc_blocks > (uint32_t)a.keccak_blocks;
    }
    store_u256(a.out + 8 * (uint64_t)i, out);
    a.err[i] = err;
}

// The precompile unit of one lane's precompile call in cycle c: the
// keccak256 or sha256 of its input or, with kEc, the ecrecover of its four
// input words, its round-witness data rows in the chunk's scratch block
// (with emit word and slot count), then its output word (ecrecover: the ok
// word and the address).  The call's input words go from the read frame into the window
// `win` (stride rs) once; the mem_in rows and the hash both read them there.
// Inlined into the cycle: out of line, kPrecomp's launch took 6.2 ms
// against 4.8 on an H100 (PERF.md).  Returns whether the call sets
// lane_error.
template <bool kEc>
HD bool precompile_unit(const K1Args &a, int b, int c, const uint32_t abi[8],
                        uint32_t addr16, uint32_t heap_page, uint32_t ts_log,
                        uint32_t *win, uint32_t rs, uint32_t *emit,
                        uint32_t *nslots) {
    *emit = *nslots = 0;
    const bool is_keccak = addr16 == KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS;
    const bool is_sha = addr16 == SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS;
    const bool is_ec = kEc && addr16 == ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS;
    if (!is_keccak && !is_sha && !is_ec) return false;
    const uint32_t in_off = abi[PP_ABI_IN_OFF], in_len = abi[PP_ABI_IN_LEN];
    const uint32_t out_off = abi[PP_ABI_OUT_OFF], rounds = abi[PP_ABI_ROUNDS];
    const uint32_t page_r = abi[PP_ABI_PAGE_R] ? abi[PP_ABI_PAGE_R] : heap_page;
    const uint32_t page_w = abi[PP_ABI_PAGE_W] ? abi[PP_ABI_PAGE_W] : heap_page;
    bool r_on_h, r_on_a, w_on_h, w_on_a;
    uint32_t r_slot, w_slot;
    page_slots(a, b, page_r, page_w, &r_on_h, &r_on_a, &r_slot, &w_on_h,
               &w_on_a, &w_slot);
    bool err = !(r_on_h || r_on_a) || !(w_on_h || w_on_a);
    const uint32_t RW = r_on_h ? a.heap_words : a.aux_heap_words;
    const UnitFrame fr = {r_on_h ? a.heap : a.aux_heap,
                          (uint64_t)a.heap_frames * RW, (uint64_t)a.batch,
                          r_slot * RW, b};
    const uint32_t ms = a.sha_rounds > 1 ? a.sha_rounds : 1;
    const KeccakCall kc = keccak_call(in_off, in_len, (uint32_t)a.keccak_blocks);
    const uint32_t sha_n = rounds < ms ? rounds : ms;

    // the call's words: from in_off >> 5 (keccak) or in_off (sha256,
    // ecrecover), as many as the hash or the mem_in rows read, at most PS_IN
    const uint32_t ps_in = a.pq_slots_in;
    const uint32_t first = is_keccak ? in_off >> 5 : in_off;
    const uint32_t kq_words = in_len == 0 ? 0u
        : ((in_off + in_len - 1) >> 5) - (in_off >> 5) + 1;
    const uint32_t n_words = is_keccak ? kq_words : (is_ec ? 4u : 2 * rounds);
    const uint32_t hash_words = is_keccak ? keccak_words(kc)
        : (is_ec ? 4u : 2 * sha_n);
    uint32_t n_load = a.pq_capacity > 0 && n_words > hash_words
        ? n_words : hash_words;
    n_load = n_load < ps_in ? n_load : ps_in;
    stage_words(fr, first, n_load, win, rs);

    const uint64_t B = a.batch;
    const uint32_t ps_out = kEc ? 2u : 1u;
    const uint32_t rounds_q = is_keccak ? kc.kc_blocks : (is_ec ? 1u : rounds);
    // the block's data rows (PQ_EMIT): only these are stored, the splice
    // writes the others as zeros
    const uint32_t n_in = n_words < ps_in ? n_words : ps_in;
    const uint32_t n_out = is_ec ? 2u : 1u;
    if (a.pq_capacity > 0) {
        // rows: the mem_in rows, consecutive words from the call's first
        err |= n_words > ps_in;
        for (uint32_t i = 0; i < n_in; i++) {
            const uint64_t row = (uint64_t)c * (ps_in + ps_out) + i;
            const uint32_t meta[4] = {ts_log, 3u, page_r, first + i};
            const U256 val = window_word(win, rs, i);
            for (int q = 0; q < 4; q++)
                a.pq_meta_blk[(row * 4 + q) * B + b] = (int32_t)meta[q];
            for (int l = 0; l < 8; l++)
                a.pq_value_blk[(row * 8 + l) * B + b] = (int32_t)val.w[l];
            a.pq_flags_blk[row * B + b] = 4;
        }
    }

    U256 out, out2 = u256_zero();
    if (is_keccak) {
        err |= kc.kc_blocks > (uint32_t)a.keccak_blocks;
        out = keccak_window(fr, kc, win, rs);
    } else if (is_ec) {
        // digest, v (the low bit of word 1), r, s at input words 0..3
        out = u256_from32(ecrecover_unit(
            window_word(win, rs, 0), win_chunk(win, rs, 15) & 1,
            window_word(win, rs, 2), window_word(win, rs, 3), &out2));
    } else {
        err |= rounds > ms;
        out = sha_window(win, rs, sha_n);
    }

    if (a.pq_capacity > 0) {
        // the mem_out row, which carries the round count, and with kEc a
        // second mem_out row (the address; an ecrecover call's only)
        for (uint32_t j = 0; j < n_out; j++) {
            const uint64_t row = (uint64_t)c * (ps_in + ps_out) + ps_in + j;
            const uint32_t meta[4] = {ts_log + 1, 1u, page_w, out_off + j};
            const U256 val = j ? out2 : out;
            for (int q = 0; q < 4; q++)
                a.pq_meta_blk[(row * 4 + q) * B + b] = (int32_t)meta[q];
            for (int l = 0; l < 8; l++)
                a.pq_value_blk[(row * 8 + l) * B + b] = (int32_t)val.w[l];
            a.pq_flags_blk[row * B + b] =
                (int32_t)(j ? 5u : 5u | (rounds_q << 3));
        }
        *emit = PQ_EMIT(n_in, n_out);
        *nslots = n_words + 1 + is_ec;
    }

    // the output word(s), after the mem_in reads; u32 index arithmetic, so
    // an ecrecover window whose second word wraps past 2**32 is in bounds
    const uint32_t W = w_on_h ? a.heap_words : a.aux_heap_words;
    const bool hw_ok = out_off + (uint32_t)is_ec < W;
    err |= !hw_ok;
    if (hw_ok && (w_on_h || w_on_a)) {
        const uint64_t n = (uint64_t)a.heap_frames * W;
        int32_t *arena = w_on_h ? a.heap : a.aux_heap;
        if (is_ec) {
            store_word(a, arena, b, n, (uint32_t)(w_slot * W + out_off), out);
            store_word(a, arena, b, n, (uint32_t)(w_slot * W + out_off + 1),
                       out2);
        } else {
            store_word(a, arena, b, n, (uint64_t)w_slot * W + out_off, out);
        }
    }
    return err;
}

// one cycle of one live lane (done lanes never get here); fills the
// cycle's 8 witness slots and, with kLog, its log and decommit rows
template <bool kLog, bool kPrecomp, bool kEc>
HD void lane_cycle(const K1Args &a, int b, int c, Lane &L, Slot *slots,
                   LogRow &lr, DecRow &dr) {
    const int D = a.max_depth;
    for (int s = 0; s < SLOTS_PER_CYCLE; s++) slots[s].valid = false;
    lr.valid = dr.valid = false;
    L.pq_emit = L.pq_nslots = 0;

    // ---------------------------------------------------------- frame
    const int32_t depth = L.depth;
    const bool frame_ok = depth >= 0 && depth < D;
    uint32_t scal[NF];
    uint32_t this_addr[5], msg_sender[5], code_addr[5], frame_u128[4];
    {
        const uint64_t fd = frame_ok ? depth : 0;
        for (int f = 0; f < (int)NF; f++)
            scal[f] = frame_ok ? (uint32_t)a.cs_scalars[ll(a, b, fd * NF + f)] : 0u;
        for (int i = 0; i < 5; i++) {
            this_addr[i] = frame_ok ? (uint32_t)a.cs_this[ll(a, b, fd * 5 + i)] : 0u;
            msg_sender[i] = frame_ok ? (uint32_t)a.cs_sender[ll(a, b, fd * 5 + i)] : 0u;
            code_addr[i] = frame_ok ? (uint32_t)a.cs_code_addr[ll(a, b, fd * 5 + i)] : 0u;
        }
        for (int i = 0; i < 4; i++)
            frame_u128[i] = frame_ok ? (uint32_t)a.cs_u128[ll(a, b, fd * 4 + i)] : 0u;
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
        bool m = (uint32_t)a.cb_page[ll(a, b, p)] == code_page &&
                 a.cb_valid[ll(a, b, p)];
        if (m) { code_slot += p; code_page_found = true; }
    }
    const uint64_t code_n = (uint64_t)P * a.code_words;
    if (code_read_needed &&
        (!code_page_found || super_pc >= (uint32_t)a.code_words))
        L.lane_error = true;
    U256 code_word = code_read_needed
        ? load_word(a, a.code, b, code_n, code_slot * a.code_words + super_pc)
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

    const bool is_kernel = addr_is_kernel(this_addr);
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
    uint32_t src0_phys;
    const bool src0_in_window = map_stack(a, src0_loc, &src0_phys);
    const U256 stack_val = load_word(a, a.stack, b, SW, src0_phys);
    const bool stack_tag =
        src0_phys < SW ? a.stack_tag[ll(a, b, src0_phys)] != 0 : false;
    const U256 code_val = load_word(a, a.code, b, code_n,
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
    const bool is_log = opcode == OP_LOG;
    // without their units, LOG / FAR_CALL and log.precompile are errors
    if (kLog ? (!kPrecomp && is_log && sub_variant == LOG_PRECOMPILE_CALL)
             : (opcode == OP_FAR_CALL || is_log))
        L.lane_error = true;

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
        if ((uint32_t)a.hp_page[ll(a, b, f)] == u_page_field) {
            ptr_heap_slot += f; hp_any = true;
        }
        if ((uint32_t)a.ap_page[ll(a, b, f)] == u_page_field) {
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
    int32_t *mem = use_heap_arena ? a.heap : a.aux_heap;
    const U256 w0 = do_mem ? load_word(a, mem, b, m_n, (uint32_t)(m_base + word0))
                           : u256_zero();
    const U256 w1 = (do_mem && is_unaligned)
        ? load_word(a, mem, b, m_n, (uint32_t)(m_base + word1)) : u256_zero();

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

    // ---------------------------------------------------- log family
    // pubdata ergs first, then the storage / event action (log.rs)
    const uint32_t shard_this = scal[CS_SHARD_IDS] & 0xFF;
    const uint32_t ts_log = L.timestamp + 1;
    const int S = a.storage_slots;
    uint32_t ergs_after = ergs2;
    bool do_sread = false, do_swrite = false, do_event = false;
    bool do_precomp = false, l_precomp = false;
    U256 current_val = u256_zero();
    uint32_t aux_byte = 0;
    int32_t new_j_count = L.j_count, new_ev_count = L.ev_count;
    if (kLog && is_log) {
        const uint32_t ls = sub_variant;
        const bool l_swrite = ls == LOG_STORAGE_WRITE;
        const bool l_event = ls == LOG_EVENT, l_tol1 = ls == LOG_TO_L1_MESSAGE;
        l_precomp = ls == LOG_PRECOMPILE_CALL;
        uint32_t eop = 0;
        if (l_swrite && shard_this == 0)
            eop = L.ergs_per_pubdata * INITIAL_STORAGE_WRITE_PUBDATA_BYTES;
        else if (l_tol1)
            eop = L.ergs_per_pubdata * L1_MESSAGE_PUBDATA_BYTES;
        const uint32_t total = eop + (l_precomp ? src1.w[0] : 0u);
        const bool not_enough = total > ergs2;
        // the soft out-of-ergs path skips the query and spends what is left
        ergs_after = not_enough ? 0 : ergs2 - total;
        L.spent_pubdata += not_enough ? (ergs2 < eop ? ergs2 : eop) : eop;
        do_sread = ls == LOG_STORAGE_READ;
        do_swrite = l_swrite && !not_enough;
        do_event = (l_event || l_tol1) && !not_enough;
        do_precomp = l_precomp && !not_enough;

        // compare-all lookup over the lane's KV slots; a write goes to the
        // match, or to a fresh slot at st_count
        uint32_t key14[14];
        for (int i = 0; i < 8; i++) key14[i] = src0.w[i];
        for (int i = 0; i < 5; i++) key14[8 + i] = this_addr[i];
        key14[13] = shard_this;
        bool found = false;
        int32_t write_slot = 0;
        for (int s = 0; s < S; s++) {
            bool m = a.st_used[ll(a, b, s)] != 0;
            for (int i = 0; i < 14 && m; i++)
                m = (uint32_t)a.st_key[ll(a, b, s * 14 + i)] == key14[i];
            if (!m) continue;
            found = true;
            write_slot += s;
            const U256 v = load_row(a, a.st_val, b, s);
            for (int l = 0; l < 8; l++) current_val.w[l] += v.w[l];
            if (do_swrite) store_row(a, a.st_val, b, s, src1);
        }
        if (do_swrite && !found) {
            if (L.st_count >= S) {
                L.lane_error = true;
            } else {
                for (int i = 0; i < 14; i++)
                    a.st_key[ll(a, b, L.st_count * 14 + i)] = (int32_t)key14[i];
                store_row(a, a.st_val, b, L.st_count, src1);
                a.st_used[ll(a, b, L.st_count)] = 1;
                write_slot = L.st_count;
            }
            L.st_count += 1;
        }

        // journal (slot, previous value) for rollback; events
        if (do_swrite) {
            const int J = a.journal_slots;
            if (L.j_count >= J) {
                L.lane_error = true;
            } else {
                a.j_slot[ll(a, b, L.j_count)] = write_slot;
                store_row(a, a.j_prev, b, L.j_count, current_val);
            }
            new_j_count = L.j_count + 1;
        }
        if (do_event) {
            const int E = a.event_slots;
            aux_byte = l_event ? EVENT_AUX_BYTE : L1_MESSAGE_AUX_BYTE;
            if (L.ev_count >= E) {
                L.lane_error = true;
            } else {
                const uint64_t e = L.ev_count;
                store_row(a, a.ev_key, b, e, src0);
                store_row(a, a.ev_val, b, e, src1);
                a.ev_meta[ll(a, b, e * 2)] = (int32_t)ts_log;
                a.ev_meta[ll(a, b, e * 2 + 1)] = (int32_t)(
                    aux_byte | ((uint32_t)vflag0 << 8) | (L.tx_number << 16));
            }
            new_ev_count = L.ev_count + 1;
        }
    }
    const uint32_t heap_page = base_page + 2, aux_page = base_page + 3;
    if (kPrecomp && do_precomp &&
        precompile_unit<kEc>(a, b, c, src0.w, this_addr[0] & 0xFFFF,
                             heap_page, ts_log, L.rf + RF_WORDS * L.rs, L.rs,
                             &L.pq_emit, &L.pq_nslots))
        L.lane_error = true;

    // ---------------------------------------------------- near call
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

    // ------------------------------------------ far call (far_call.rs)
    const bool is_far_call = kLog && opcode == OP_FAR_CALL;
    bool fc_exc = false, fc_do_sread = false, fc_do_decommit = false;
    bool fc_fresh = false, fc_ctor = false, fc_to_system = false;
    uint32_t fc_left = 0, fc_passed = 0;
    uint32_t fc_new_heap_bound = heap_bound0, fc_new_aux_bound = aux_bound0;
    const uint32_t fc_new_base = L.page_counter;
    uint32_t fc_code_page = 0, fc_code_len = 0;
    uint32_t fc_this_shard = 0, fc_code_shard = 0;
    const int32_t fc_heap_slot = L.frame_count;
    uint32_t fc_addr5[5] = {0, 0, 0, 0, 0};
    uint32_t fc_next_this[5], fc_next_sender[5], fc_next_u128[4];
    uint32_t fc_cd[4] = {0, 0, 0, 0};   // calldata: offset, page, start, length
    U256 fc_hash_storage = u256_zero(), fc_code_hash = u256_zero();
    if (is_far_call) {
        const bool fc_delegate = sub_variant == FAR_DELEGATE;
        const bool fc_mimic = sub_variant == FAR_MIMIC;
        for (int i = 0; i < 5; i++) fc_addr5[i] = src1.w[i];
        const bool dst_kernel = addr_is_kernel(fc_addr5);
        const uint32_t off = src0.w[0], page_f = src0.w[1];
        const uint32_t start = src0.w[2], len = src0.w[3];
        const uint32_t abi7 = src0.w[7];
        uint32_t mode = (abi7 >> 8) & 0xFF;
        if (mode > 2) mode = 0;
        fc_ctor = ((abi7 >> 16) & 0xFF) != 0 && is_kernel;
        fc_to_system = ((abi7 >> 24) & 0xFF) != 0 && dst_kernel;
        fc_code_shard = vflag1 ? (abi7 & 0xFF) : shard_this;
        fc_this_shard = fc_delegate ? shard_this : fc_code_shard;

        // code-hash storage read (skipped for the unavailable-shard mapping)
        const bool trivial = fc_code_shard != 0;
        fc_do_sread = !trivial;
        if (!trivial) {
            uint32_t key14[14] = {0};
            for (int i = 0; i < 5; i++) key14[i] = fc_addr5[i];
            key14[8] = DEPLOYER_SYSTEM_CONTRACT_ADDRESS;
            key14[13] = fc_code_shard;
            for (int s = 0; s < S; s++) {
                bool m = a.st_used[ll(a, b, s)] != 0;
                for (int i = 0; i < 14 && m; i++)
                    m = (uint32_t)a.st_key[ll(a, b, s * 14 + i)] == key14[i];
                if (m) {
                    const U256 v = load_row(a, a.st_val, b, s);
                    for (int l = 0; l < 8; l++) fc_hash_storage.w[l] += v.w[l];
                }
            }
        }
        // default-AA masking for empty slots of user-space targets
        const U256 aa = load_u256(a.default_aa_hash + (uint64_t)b * 8);
        const bool mask_aa = u256_is_zero(fc_hash_storage) && !dst_kernel && !trivial;
        const U256 hash_raw = mask_aa ? aa : fc_hash_storage;
        // versioned-hash validation (the BE byte layout lives in limb 7)
        const uint32_t h7 = hash_raw.w[7];
        const bool vh_ok = (h7 >> 24) == CODE_HASH_VERSION_BYTE;
        const uint32_t marker = (h7 >> 16) & 0xFF;
        const bool marker_rest = marker == CODE_AT_REST_MARKER;
        const bool marker_ctor = marker == YET_CONSTRUCTED_MARKER;
        const bool marker_valid = marker_rest || marker_ctor;
        const bool can_call = (!fc_ctor && marker_rest) || (fc_ctor && marker_ctor);
        const bool callable_direct = vh_ok && marker_valid && can_call;
        const bool degrade_aa = vh_ok && marker_valid && !can_call && !dst_kernel;
        const bool bad_hash = !vh_ok || !marker_valid;
        const bool ctor_system = vh_ok && marker_valid && !can_call && dst_kernel;
        if (callable_direct) {
            fc_code_hash = hash_raw;
            fc_code_hash.w[7] = h7 & 0xFF00FFFFu;   // marker byte -> at rest
            fc_code_len = h7 & 0xFFFF;
        } else if (degrade_aa) {
            fc_code_hash = aa;
            fc_code_len = aa.w[7] & 0xFFFF;
        }

        // ABI quasi-pointer validation and forwarding (as in ret)
        const bool fwd = mode == 1, use_aux = mode == 2;
        const bool deref = (uint32_t)(start + len) < start;
        const bool exc0 = bad_hash || ctor_system || (fwd && !src0_tag) ||
                          deref || (!fwd && off != 0) || off > len;
        if (!exc0) {
            fc_cd[0] = fwd ? 0 : off;
            fc_cd[1] = fwd ? page_f : (use_aux ? aux_page : heap_page);
            fc_cd[2] = fwd ? start + off : start;
            fc_cd[3] = fwd ? len - off : len;
        }
        // memory growth paid against the caller frame's bounds
        const uint32_t upper = deref ? 0xFFFFFFFFu : fc_cd[2] + fc_cd[3];
        const uint32_t bound = use_aux ? aux_bound0 : heap_bound0;
        const bool growth_uf = upper < bound;
        const uint32_t growth = (growth_uf || fwd) ? 0 : upper - bound;
        if (!fwd && !growth_uf) {
            if (use_aux) fc_new_aux_bound = upper;
            else fc_new_heap_bound = upper;
        }
        const uint32_t cost_growth = growth * MEMORY_GROWTH_ERGS_PER_BYTE;
        const bool no_ergs_grow = ergs_after < cost_growth;
        const uint32_t ergs_a = no_ergs_grow ? 0 : ergs_after - cost_growth;
        const uint32_t cost_dec = ERGS_PER_CODE_WORD_DECOMMITTMENT * fc_code_len;
        const bool no_ergs_dec = ergs_a < cost_dec;
        fc_exc = exc0 || no_ergs_grow || no_ergs_dec;
        uint32_t ergs_b = no_ergs_dec ? ergs_a : ergs_a - cost_dec;

        // decommit: bind a pre-staged code-bank slot to the candidate page
        fc_do_decommit = !fc_exc;
        bool bank_found = false;
        uint32_t bound_page = 0;
        for (int p = 0; p < P; p++) {
            bool m = a.cb_valid[ll(a, b, p)] != 0;
            for (int l = 0; l < 8 && m; l++)
                m = (uint32_t)a.cb_hash[ll(a, b, p * 8 + l)] == fc_code_hash.w[l];
            if (m) {
                bank_found = true;
                bound_page += (uint32_t)a.cb_page[ll(a, b, p)];
            }
        }
        // an unknown code hash is the VM's single hard error
        if (fc_do_decommit && !bank_found) L.lane_error = true;
        fc_fresh = bound_page == 0;
        fc_code_page = fc_fresh ? fc_new_base : bound_page;
        if (fc_do_decommit && fc_fresh) {
            for (int p = 0; p < P; p++) {
                bool m = a.cb_valid[ll(a, b, p)] != 0;
                for (int l = 0; l < 8 && m; l++)
                    m = (uint32_t)a.cb_hash[ll(a, b, p * 8 + l)] == fc_code_hash.w[l];
                if (m) a.cb_page[ll(a, b, p)] = (int32_t)fc_new_base;
            }
        }
        // a repeat decommit refunds its cost (far_call.rs:450-453)
        if (fc_do_decommit && !fc_fresh) ergs_b += cost_dec;
        if (fc_exc) fc_code_page = UNMAPPED_PAGE;

        // the 63/64 rule
        const uint32_t max_pass = (ergs_b / 64) * 63;
        const uint32_t leftover = ergs_b - max_pass;
        const uint32_t want = src0.w[6];
        const bool over = want > max_pass;
        fc_passed = over ? max_pass : want;
        fc_left = over ? leftover : leftover + max_pass - want;

        // the callee frame's addresses and context
        for (int i = 0; i < 5; i++) {
            fc_next_this[i] = fc_delegate ? this_addr[i] : fc_addr5[i];
            fc_next_sender[i] = fc_delegate ? msg_sender[i]
                : (fc_mimic ? reg_limb(L, 14, i) : this_addr[i]);
        }
        for (int i = 0; i < 4; i++)
            fc_next_u128[i] = fc_delegate ? frame_u128[i] : L.ctx[i];
        if (fc_heap_slot >= a.heap_frames) L.lane_error = true;
    }

    // ============================================ flags writeback
    const bool writes_flags = set_flags &&
        (is_add || is_sub || is_mul || is_div || is_shift || is_binop);
    const bool resets_flags = is_near_call || is_ret || is_far_call;
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
    else if (do_sread) dst0_val = current_val;
    else if (l_precomp) dst0_val = u256_from32(do_precomp ? 1u : 0u);
    const bool dst0_is_ptr = ptr_writes;
    const bool dst0_write = is_add || is_sub || is_mul || is_div || is_shift ||
        is_binop || ctx_writes_dst || ptr_writes || do_sread || l_precomp ||
        (uma_is_read && !uma_set_panic) ||
        (uma_is_write && uma_increment && !uma_set_panic);

    U256 dst1_val = u256_zero();
    if (is_mul) dst1_val = mul_hi;
    else if (is_div) dst1_val = div_by_zero ? u256_zero() : div_r;
    else if (uma_is_read && uma_increment) dst1_val = incremented_src0;
    const bool dst1_is_ptr = uma_is_read && uma_increment && src0_tag;
    const bool dst1_write = is_mul || is_div ||
        (uma_is_read && uma_increment && !uma_set_panic);

    new_pending = (is_ptr && ptr_panic) || uma_set_panic ||
                  (is_far_call && fc_exc);

    // ====================================== pc + frame machinery
    uint32_t cur[NF];
    for (int f = 0; f < (int)NF; f++) cur[f] = scal[f];
    cur[CS_PC] = is_jump ? (src0.w[0] & 0xFFFF) : new_pc_lin;
    cur[CS_SP] = sp2;
    cur[CS_ERGS_REMAINING] = is_near_call ? nc_left
        : (is_far_call ? fc_left : (is_ret ? 0 : ergs3));
    cur[CS_HEAP_BOUND] = is_uma ? new_heap_bound_u
        : (is_far_call ? fc_new_heap_bound : heap_bound0);
    cur[CS_AUX_HEAP_BOUND] = is_uma ? new_aux_bound_u
        : (is_far_call ? fc_new_aux_bound : aux_bound0);
    if (frame_ok)
        for (int f = 0; f < (int)NF; f++)
            a.cs_scalars[ll(a, b, (uint64_t)depth * NF + f)] = (int32_t)cur[f];
    if (is_near_call || is_far_call) {
        const int32_t push_idx = depth + 1 < D - 1 ? depth + 1 : D - 1;
        if (depth + 1 >= D) L.lane_error = true;
        if (push_idx >= 0) {
            uint32_t pushed[NF];
            for (int f = 0; f < (int)NF; f++) pushed[f] = cur[f];
            pushed[CS_JOURNAL_SNAPSHOT] = (uint32_t)new_j_count;
            pushed[CS_EVENT_SNAPSHOT] = (uint32_t)new_ev_count;
            const uint32_t *p_this = this_addr, *p_sender = msg_sender;
            const uint32_t *p_code = code_addr, *p_u128 = frame_u128;
            if (is_far_call) {
                pushed[CS_PC] = 0;
                pushed[CS_EXCEPTION_HANDLER] = imm0;
                pushed[CS_ERGS_REMAINING] = fc_passed;
                // far frames keep only the static bit
                pushed[CS_FLAGS_WORD] = (flags_word & 1) | (uint32_t)vflag0;
                pushed[CS_BASE_MEMORY_PAGE] = fc_new_base;
                pushed[CS_CODE_PAGE] = fc_code_page;
                pushed[CS_SP] = INITIAL_SP_ON_FAR_CALL;
                pushed[CS_SHARD_IDS] = fc_this_shard | (shard_this << 8) |
                                       (fc_code_shard << 16);
                pushed[CS_HEAP_BOUND] = NEW_FRAME_MEMORY_STIPEND;
                pushed[CS_AUX_HEAP_BOUND] = NEW_FRAME_MEMORY_STIPEND;
                pushed[CS_HEAP_SLOT] = (uint32_t)fc_heap_slot;
                p_this = fc_next_this; p_sender = fc_next_sender;
                p_code = fc_addr5; p_u128 = fc_next_u128;
            } else {
                pushed[CS_PC] = imm0;
                pushed[CS_EXCEPTION_HANDLER] = imm1;
                pushed[CS_ERGS_REMAINING] = nc_passed;
                pushed[CS_FLAGS_WORD] = flags_word | 2;
            }
            const uint64_t pd = push_idx;
            for (int f = 0; f < (int)NF; f++)
                a.cs_scalars[ll(a, b, pd * NF + f)] = (int32_t)pushed[f];
            for (int i = 0; i < 5; i++) {
                a.cs_this[ll(a, b, pd * 5 + i)] = (int32_t)p_this[i];
                a.cs_sender[ll(a, b, pd * 5 + i)] = (int32_t)p_sender[i];
                a.cs_code_addr[ll(a, b, pd * 5 + i)] = (int32_t)p_code[i];
            }
            for (int i = 0; i < 4; i++)
                a.cs_u128[ll(a, b, pd * 4 + i)] = (int32_t)p_u128[i];
        }
    }
    if (is_far_call) {
        // the context register is consumed by the call (far_call.rs:558);
        // a fresh heap / aux-heap frame slot and page range for the callee
        for (int i = 0; i < 4; i++) new_ctx[i] = 0;
        const int F = a.heap_frames;
        if (fc_heap_slot >= 0 && fc_heap_slot < F) {
            a.hp_page[ll(a, b, fc_heap_slot)] = (int32_t)(fc_new_base + 2);
            a.ap_page[ll(a, b, fc_heap_slot)] = (int32_t)(fc_new_base + 3);
        }
        L.frame_count += 1;
        L.page_counter += NEW_MEMORY_PAGES_PER_FAR_CALL;
    }
    if (is_ret) {
        const int32_t parent_idx = depth - 1 > 0 ? depth - 1 : 0;
        if (parent_idx < D) {
            // the parent frame's scalars: field f at ll(par + f)
            const uint64_t par = (uint64_t)parent_idx * NF;
            int32_t *cs = a.cs_scalars;
            cs[ll(a, b, par + CS_ERGS_REMAINING)] = (int32_t)(
                (uint32_t)cs[ll(a, b, par + CS_ERGS_REMAINING)] + ergs3);
            if (is_to_label && is_local_frame)
                cs[ll(a, b, par + CS_PC)] = (int32_t)imm0;
            else if (ret_panicked)
                cs[ll(a, b, par + CS_PC)] = (int32_t)scal[CS_EXCEPTION_HANDLER];
            if (is_local_frame) {
                cs[ll(a, b, par + CS_HEAP_BOUND)] = (int32_t)heap_bound0;
                cs[ll(a, b, par + CS_AUX_HEAP_BOUND)] = (int32_t)aux_bound0;
            }
        }
        if (kLog && ret_panicked) {
            // storage rollback: replay the journal newest-first down to the
            // frame's snapshot; then cancel the frame's events
            const int32_t j_snap = (int32_t)scal[CS_JOURNAL_SNAPSHOT];
            const int32_t ev_snap = (int32_t)scal[CS_EVENT_SNAPSHOT];
            const int J = a.journal_slots, E = a.event_slots;
            for (int32_t idx = new_j_count; idx > j_snap; idx--) {
                const int32_t e = idx - 1 > 0 ? idx - 1 : 0;
                int32_t slot = 0;
                U256 prev = u256_zero();
                if (e < J) {
                    slot = a.j_slot[ll(a, b, e)];
                    prev = load_row(a, a.j_prev, b, e);
                }
                if (slot >= 0 && slot < S) store_row(a, a.st_val, b, slot, prev);
            }
            new_j_count = j_snap;
            for (int32_t pos = ev_snap > 0 ? ev_snap : 0;
                 pos < new_ev_count && pos < E; pos++)
                a.ev_cancelled[ll(a, b, pos)] = 1;
        }
    }
    int32_t new_depth = depth + ((is_near_call || is_far_call) ? 1 : 0) -
                        (is_ret ? 1 : 0);
    if (new_depth < 0) new_depth = 0;

    // ====================================== register writebacks
    if (dst0_write && !dst0_is_stack_mem && dst0_reg > 0)
        write_reg(L, dst0_reg, dst0_val, dst0_is_ptr);
    if (dst1_write && dst1_reg > 0) write_reg(L, dst1_reg, dst1_val, dst1_is_ptr);
    if (nonlocal_ret) {
        // r1 = returndata pointer, the rest of the file wiped
        for (int r = 0; r < 15; r++) {
            for (int l = 0; l < 8; l++) reg_limb(L, r, l) = 0;
            reg_tag(L, r) = r == 0;
        }
        reg_limb(L, 0, 0) = r_off; reg_limb(L, 0, 1) = r_page;
        reg_limb(L, 0, 2) = r_start; reg_limb(L, 0, 3) = r_len;
        for (int i = 0; i < 4; i++) new_ctx[i] = 0;
    }
    if (is_far_call) {
        // far-call register protocol (far_call.rs:571-610): r1 = calldata
        // pointer, r2 = ctor | system markers, r3..r12 kept (tags cleared)
        // only for system calls, r13..r15 zeroed
        for (int r = 0; r < 15; r++) {
            const bool keep = fc_to_system && r >= 2 && r <= 11;
            if (!keep)
                for (int l = 0; l < 8; l++) reg_limb(L, r, l) = 0;
            reg_tag(L, r) = r == 0;
        }
        for (int i = 0; i < 4; i++) reg_limb(L, 0, i) = fc_cd[i];
        reg_limb(L, 1, 0) = (uint32_t)fc_ctor | ((uint32_t)fc_to_system << 1);
    }

    // ======================================== memory writebacks
    const bool dst0_to_stack = dst0_write && dst0_is_stack_mem;
    uint32_t dst0_phys;
    const bool dst0_in_window = map_stack(a, dst0_loc, &dst0_phys);
    if (dst0_to_stack) {
        if (!dst0_in_window) L.lane_error = true;
        if (dst0_phys < SW) {
            store_word(a, a.stack, b, SW, dst0_phys, dst0_val);
            a.stack_tag[ll(a, b, dst0_phys)] = dst0_is_ptr;
        }
    }
    if (uma_do_write) {
        store_word(a, mem, b, m_n, (uint32_t)(m_base + word0), new_w0);
        if (is_unaligned)
            store_word(a, mem, b, m_n, (uint32_t)(m_base + word1), new_w1);
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

    // ============================== log and decommit witness rows
    if (kLog) {
        lr.valid = do_sread || do_swrite || do_event || do_precomp || fc_do_sread;
        if (lr.valid) {
            const uint32_t l_aux = do_precomp ? PRECOMPILE_AUX_BYTE
                : ((do_sread || do_swrite || fc_do_sread) ? STORAGE_AUX_BYTE
                                                         : aux_byte);
            const uint32_t l_rw = do_swrite || do_event;
            const uint32_t l_svc = vflag0 && !fc_do_sread;
            const uint32_t l_shard = fc_do_sread ? fc_code_shard : shard_this;
            lr.meta[0] = ts_log;
            lr.meta[1] = l_aux | (l_rw << 8) | (l_svc << 9) | (l_shard << 16);
            lr.meta[2] = L.tx_number;
            lr.meta[3] = 1;
            if (fc_do_sread) {
                lr.addr[0] = DEPLOYER_SYSTEM_CONTRACT_ADDRESS;
                for (int i = 1; i < 5; i++) lr.addr[i] = 0;
                lr.key = u256_zero();
                for (int i = 0; i < 5; i++) lr.key.w[i] = fc_addr5[i];
                lr.read = lr.written = fc_hash_storage;
            } else {
                for (int i = 0; i < 5; i++) lr.addr[i] = this_addr[i];
                lr.key = src0;
                if (kPrecomp && do_precomp) {   // the resolved pages
                    const uint32_t pr = src0.w[PP_ABI_PAGE_R];
                    const uint32_t pw = src0.w[PP_ABI_PAGE_W];
                    lr.key.w[PP_ABI_PAGE_R] = pr ? pr : base_page + 2;
                    lr.key.w[PP_ABI_PAGE_W] = pw ? pw : base_page + 2;
                }
                // reads copy read_value into written_value (helpers.rs)
                lr.read = (do_sread || do_swrite) ? current_val : u256_zero();
                lr.written = do_sread ? current_val
                    : ((do_swrite || do_event) ? src1 : u256_zero());
            }
        }
        dr.valid = fc_do_decommit;
        if (dr.valid) {
            dr.hash = fc_code_hash;
            dr.meta[0] = L.timestamp + 1;
            dr.meta[1] = fc_code_page;
            dr.meta[2] = fc_code_len;
            dr.meta[3] = 1u | ((uint32_t)fc_fresh << 1);
        }
    }

    // ======================================== lane scalar updates
    L.j_count = new_j_count;
    L.ev_count = new_ev_count;
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
// (meta [rows, 4, B], value [rows, 8, B], flags [rows, B]); an overflowing
// cycle writes all-zero rows and flags its valid slots as a lane error.
// Returns the number of valid slots written.
HD int emit_slots(const K1Args &a, int32_t *meta, int32_t *value,
                  int32_t *flags, int b, uint64_t base, const Slot *slots,
                  bool overflow, Lane &L) {
    const uint64_t B = a.batch;
    int n = 0;
    for (int s = 0; s < SLOTS_PER_CYCLE; s++) {
        const Slot &q = slots[s];
        bool v = q.valid;
        if (v && overflow) {
            L.lane_error = true;
            v = false;
        }
        const uint64_t row = base + s;
        meta[(row * 4 + 0) * B + b] = v ? (int32_t)q.ts : 0;
        meta[(row * 4 + 1) * B + b] = v ? (int32_t)q.type : 0;
        meta[(row * 4 + 2) * B + b] = v ? (int32_t)q.page : 0;
        meta[(row * 4 + 3) * B + b] = v ? (int32_t)q.index : 0;
        for (int l = 0; l < 8; l++)
            value[(row * 8 + l) * B + b] = v ? (int32_t)q.val.w[l] : 0;
        flags[row * B + b] = v ? (int32_t)(q.rw | (q.ptr << 1) | 4u) : 0;
        n += v;
    }
    return n;
}

// append one cycle's valid slots, in slot order, to lane b's rows of the
// chunk block K2 folds (batch-last as emit_slots' arrays), from its
// cursor on; an invalid slot writes nothing
HD void emit_block_rows(const K1Args &a, int b, const Slot *slots,
                        const Lane &L) {
    const uint64_t B = a.batch;
    uint32_t next = blk_cursor(L);
    for (int s = 0; s < SLOTS_PER_CYCLE; s++) {
        const Slot &q = slots[s];
        if (!q.valid) continue;
        const uint64_t row = next++;
        a.blk_meta[(row * 4 + 0) * B + b] = (int32_t)q.ts;
        a.blk_meta[(row * 4 + 1) * B + b] = (int32_t)q.type;
        a.blk_meta[(row * 4 + 2) * B + b] = (int32_t)q.page;
        a.blk_meta[(row * 4 + 3) * B + b] = (int32_t)q.index;
        for (int l = 0; l < 8; l++)
            a.blk_value[(row * 8 + l) * B + b] = (int32_t)q.val.w[l];
        a.blk_flags[row * B + b] = (int32_t)(q.rw | (q.ptr << 1) | 4u);
    }
    blk_cursor(L) = next;
}

// write one cycle's log row at min(step, LQ - 1) of the lane's log queue
HD void emit_log_row(const K1Args &a, int b, int64_t step, const LogRow &lr,
                     Lane &L) {
    const int64_t LQ = a.log_queue_capacity;
    bool v = lr.valid;
    if (v && step >= LQ) {
        L.lane_error = true;
        v = false;
    }
    const uint64_t r = step < LQ - 1 ? step : LQ - 1;
    for (int i = 0; i < 4; i++)
        a.lq_meta[ll(a, b, r * 4 + i)] = v ? (int32_t)lr.meta[i] : 0;
    for (int i = 0; i < 5; i++)
        a.lq_addr[ll(a, b, r * 5 + i)] = v ? (int32_t)lr.addr[i] : 0;
    store_row(a, a.lq_key, b, r, v ? lr.key : u256_zero());
    store_row(a, a.lq_read, b, r, v ? lr.read : u256_zero());
    store_row(a, a.lq_written, b, r, v ? lr.written : u256_zero());
    L.lq_count += v;
}

HD void emit_decommit_row(const K1Args &a, int b, int64_t step,
                          const DecRow &dr, Lane &L) {
    const int64_t DQ = a.decommit_queue_capacity;
    bool v = dr.valid;
    if (v && step >= DQ) {
        L.lane_error = true;
        v = false;
    }
    const uint64_t r = step < DQ - 1 ? step : DQ - 1;
    store_row(a, a.dq_hash, b, r, v ? dr.hash : u256_zero());
    for (int i = 0; i < 4; i++)
        a.dq_meta[ll(a, b, r * 4 + i)] = v ? (int32_t)dr.meta[i] : 0;
    L.dq_count += v;
}

// lane b's whole launch, its register file at rf (RF_WORDS words, stride
// rs)
template <bool kLog, bool kPrecomp, bool kEc = false>
HD void k1_run_lane(const K1Args &a, int b, uint32_t *rf, uint32_t rs) {
    Lane L;
    L.rf = rf;
    L.rs = rs;
    for (int r = 0; r < 15; r++) {
        const U256 v = load_u256(a.regs + ((uint64_t)b * 15 + r) * 8);
        for (int l = 0; l < 8; l++) reg_limb(L, r, l) = v.w[l];
        reg_tag(L, r) = a.reg_ptr[(uint64_t)b * 15 + r] != 0;
    }
    L.lt = a.flags[b * 3 + 0] != 0;
    L.eq = a.flags[b * 3 + 1] != 0;
    L.gt = a.flags[b * 3 + 2] != 0;
    L.timestamp = a.timestamp[b];
    L.mcc = a.mcc[b];
    L.ergs_per_pubdata = a.ergs_per_pubdata[b];
    L.tx_number = a.tx_number[b];
    L.pending = a.pending[b] != 0;
    L.prev_code_word = load_u256(a.prev_code_word + (uint64_t)b * 8);
    L.prev_super_pc = a.prev_super_pc[b];
    L.prev_code_page = a.prev_code_page[b];
    for (int i = 0; i < 4; i++) L.ctx[i] = (uint32_t)a.context_u128[(uint64_t)b * 4 + i];
    L.depth = a.depth[b];
    L.done = a.done[b] != 0;
    L.lane_error = a.lane_error[b] != 0;
    L.wq_count = a.wq_count[b];
    blk_cursor(L) = 0;
    L.j_count = a.j_count[b];
    L.ev_count = a.ev_count[b];
    if (kLog) {
        L.spent_pubdata = a.spent_pubdata[b];
        L.page_counter = a.page_counter[b];
        L.st_count = a.st_count[b];
        L.lq_count = a.lq_count[b];
        L.dq_count = a.dq_count[b];
        L.frame_count = a.frame_count[b];
    } else {
        L.spent_pubdata = L.page_counter = 0;
        L.st_count = L.lq_count = L.dq_count = L.frame_count = 0;
    }

    const int n = a.k_stop < a.k_cycles ? a.k_stop : a.k_cycles;
    const int64_t step0 = *a.step0;
    Slot slots[SLOTS_PER_CYCLE];
    LogRow lr;
    DecRow dr;
    for (int c = 0; c < n; c++) {
        if (L.done) {
            // a frozen lane writes nothing but its all-zero rows
            for (int s = 0; s < SLOTS_PER_CYCLE; s++) slots[s].valid = false;
            lr.valid = dr.valid = false;
            L.pq_emit = L.pq_nslots = 0;
        } else {
            lane_cycle<kLog, kPrecomp, kEc>(a, b, c, L, slots, lr, dr);
        }
        if (kPrecomp && a.pq_capacity > 0) {
            a.pq_emit_blk[(uint64_t)c * a.batch + b] = (int32_t)L.pq_emit;
            a.pq_nslots_blk[(uint64_t)c * a.batch + b] = (int32_t)L.pq_nslots;
        }
        if (kLog && a.log_queue_capacity > 0)
            emit_log_row(a, b, step0 + c, lr, L);
        if (kLog && a.decommit_queue_capacity > 0)
            emit_decommit_row(a, b, step0 + c, dr, L);
        if (a.emit_queue) {
            const int64_t pos = (step0 + c) * SLOTS_PER_CYCLE;
            const int64_t last = (int64_t)a.queue_capacity - SLOTS_PER_CYCLE;
            L.wq_count += emit_slots(a, a.q_meta, a.q_value, a.q_flags, b,
                                     pos < last ? pos : last, slots,
                                     pos > last, L);
        }
        // the block K2 folds keeps every valid slot, past a queue
        // overflow too, as the reference's rolling absorb does
        if (a.emit_block) emit_block_rows(a, b, slots, L);
    }

    for (int r = 0; r < 15; r++) {
        U256 v;
        for (int l = 0; l < 8; l++) v.w[l] = reg_limb(L, r, l);
        store_u256(a.regs + ((uint64_t)b * 15 + r) * 8, v);
        a.reg_ptr[(uint64_t)b * 15 + r] = reg_tag(L, r) != 0;
    }
    a.flags[b * 3 + 0] = L.lt;
    a.flags[b * 3 + 1] = L.eq;
    a.flags[b * 3 + 2] = L.gt;
    a.timestamp[b] = (int32_t)L.timestamp;
    a.mcc[b] = (int32_t)L.mcc;
    a.ergs_per_pubdata[b] = (int32_t)L.ergs_per_pubdata;
    a.tx_number[b] = (int32_t)L.tx_number;
    a.pending[b] = L.pending;
    store_u256(a.prev_code_word + (uint64_t)b * 8, L.prev_code_word);
    a.prev_super_pc[b] = (int32_t)L.prev_super_pc;
    a.prev_code_page[b] = (int32_t)L.prev_code_page;
    for (int i = 0; i < 4; i++) a.context_u128[(uint64_t)b * 4 + i] = (int32_t)L.ctx[i];
    a.depth[b] = L.depth;
    a.done[b] = L.done;
    a.lane_error[b] = L.lane_error;
    a.global_step[b] += n;
    if (a.emit_queue) a.wq_count[b] = L.wq_count;
    if (a.emit_block) a.blk_count[b] = (int32_t)blk_cursor(L);
    if (kLog) {
        a.spent_pubdata[b] = (int32_t)L.spent_pubdata;
        a.page_counter[b] = (int32_t)L.page_counter;
        a.st_count[b] = L.st_count;
        a.j_count[b] = L.j_count;
        a.ev_count[b] = L.ev_count;
        a.lq_count[b] = L.lq_count;
        a.dq_count[b] = L.dq_count;
        a.frame_count[b] = L.frame_count;
    }
}

#ifdef __CUDACC__
// at most K1_THREADS threads a block (k1_block_threads picks fewer)
#define K1_THREADS 128

// The arguments are a __grid_constant__, so that a device function out of
// line may take them by reference without nvcc copying the whole struct
// into each thread's local memory and reaching every array of the instance
// through generic addresses read from that copy (the units out of line did,
// PERF.md).
template <bool kLog, bool kPrecomp, bool kEc>
__global__ void __launch_bounds__(K1_THREADS) k1_kernel(
        const __grid_constant__ K1Args a) {
    extern __shared__ uint32_t k1_rf[];   // the block's register files
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < a.batch)
        k1_run_lane<kLog, kPrecomp, kEc>(a, b, k1_rf + threadIdx.x,
                                         blockDim.x);
}

// The block size: the largest of 128, 64 and 32 threads whose grid still
// spans every SM of the card, so that a small batch does not leave SMs
// idle (B = 32768: 128 threads, 256 blocks; B = 4096: 32 threads, 128
// blocks).  A lane's 255 registers allow 8 warps an SM whatever the block
// size, its 544-byte register file in shared memory 12.
static int k1_block_threads(int batch) {
    return sm_block_threads(batch, K1_THREADS);
}

// one instance's launch: the block size from the SM count, a register
// file a thread in dynamic shared memory (68 KB at 128 threads) and, with
// the units, their window (40 KB at 128 threads and PS_IN = 10: two blocks
// an SM still fit)
template <bool kLog, bool kPrecomp, bool kEc>
static int k1_launch(const K1Args *args, cudaStream_t s) {
    const int threads = k1_block_threads(args->batch);
    const int blocks = (args->batch + threads - 1) / threads;
    const int smem = threads * K1_LANE_WORDS(kPrecomp, args->pq_slots_in)
        * (int)sizeof(uint32_t);
    const cudaError_t e = cudaFuncSetAttribute(
        k1_kernel<kLog, kPrecomp, kEc>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    k1_kernel<kLog, kPrecomp, kEc><<<blocks, threads, smem, s>>>(*args);
    return (int)cudaGetLastError();
}

#ifndef K1_EC_INSTANCE
extern "C" int eravm_k1_ec_launch(const K1Args *args, void *stream);

extern "C" int eravm_k1_threads(int batch) { return k1_block_threads(batch); }

// the instance the config needs (models/fused_cycle.py: precompile_instance,
// ecrecover_instance)
extern "C" int eravm_k1_launch(const K1Args *args, int ecrecover,
                               void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (args->storage_slots > 0 && args->keccak_blocks > 0 && ecrecover)
        return eravm_k1_ec_launch(args, stream);
    if (args->storage_slots > 0 && args->keccak_blocks > 0)
        return k1_launch<true, true, false>(args, s);
    if (args->storage_slots > 0) return k1_launch<true, false, false>(args, s);
    return k1_launch<false, false, false>(args, s);
}
#endif  // K1_EC_INSTANCE
#endif  // __CUDACC__
