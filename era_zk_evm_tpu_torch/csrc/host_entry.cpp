// Host (C++) build of the K1 (all four instances), K2, K3 and sponge
// per-lane bodies, of K1's units alone (ecrecover; keccak256 and sha256) and
// of the probes P1-P7, one lane (or column) after another.
//
// Not a runtime path: the port's wrappers take the kernels on CUDA tensors
// and the plain torch versions on CPU tensors.  This entry lets the tests
// check the kernels' lane logic against the plain versions on a machine
// without CUDA (tests/test_torch_kernel_host.py).  Built again with
// K1_HOOKS_HOST (_build.load_host(hooks=True)), K1's development hooks are
// set at run time (eravm_k1_hooks_host; tests/test_torch_ablate.py).

#include <vector>

#include "cycle_kernel.cu"
#include "rolling_fold.cu"
#include "keccak_f.cu"
#include "keccak_sponge.cu"
#include "probe_keccak.cu"
#include "probe_rate.cu"
#include "probe_uniform.cu"
#include "bisect_fold.cu"
#include "pq_splice.cu"

extern "C" int eravm_k1_host(const K1Args *a, int ecrecover) {
    // the instance eravm_k1_launch chooses; a register file (and the units'
    // window) a lane
    std::vector<uint32_t> rf(K1_LANE_WORDS(true, a->pq_slots_in));
    for (int b = 0; b < a->batch; b++) {
        if (a->storage_slots > 0 && a->keccak_blocks > 0 && ecrecover)
            k1_run_lane<true, true, true>(*a, b, rf.data(), 1);
        else if (a->storage_slots > 0 && a->keccak_blocks > 0)
            k1_run_lane<true, true>(*a, b, rf.data(), 1);
        else if (a->storage_slots > 0)
            k1_run_lane<true, false>(*a, b, rf.data(), 1);
        else k1_run_lane<false, false>(*a, b, rf.data(), 1);
    }
    return 0;
}

#ifdef K1_HOOKS_HOST
// the development hooks of the next eravm_k1_host runs (the build with
// K1_HOOKS_HOST; on the card each is a compile-time constant): the
// DEBUG_SKIP and DEBUG_PASSTHROUGH bits (eravm_gen.h) and the stage, -1 off
extern "C" int eravm_k1_hooks_host(unsigned skip, int stage, unsigned pass) {
    k1_hook_skip = skip;
    k1_hook_stage = stage;
    k1_hook_pass = pass;
    return 0;
}
#endif

// K2 over a compacted chunk block of `rows` rows and its count int32[B]
extern "C" int eravm_k2_host(const void *meta, const void *value,
                             const void *flags, const void *count,
                             void *wc_state, void *wc_count, int rows,
                             int batch) {
    for (int b = 0; b < batch; b++)
        k2_run_lane((const int32_t *)meta, (const int32_t *)value,
                    (const int32_t *)flags, (const int32_t *)count,
                    (int32_t *)wc_state, (int32_t *)wc_count, rows, batch, b);
    return 0;
}

extern "C" int eravm_k3_host(void *states, int n, int iters) {
    for (int i = 0; i < n; i++) k3_run_state((int32_t *)states, i, iters);
    return 0;
}

// one permutation of each of n states (int32[n, 25, 2], in place) by a form
// of keccak.cuh: 0 keccak_f1600, -1 keccak_f1600_unit, -2 24 chained
// keccak_round, 2 and 24 keccak_rounds at the loop trips that
// tools/unit_variants.py's trees build
extern "C" int eravm_perm_host(void *states, int n, int form) {
    for (int i = 0; i < n; i++) {
        uint32_t *s = (uint32_t *)states + (uint64_t)i * 50;
        uint64_t a[25];
        for (int k = 0; k < 25; k++)
            a[k] = (uint64_t)s[2 * k] | ((uint64_t)s[2 * k + 1] << 32);
        switch (form) {
        case 0: keccak_f1600(a); break;
        case -1: keccak_f1600_unit(a); break;
        case -2: for (int r = 0; r < 24; r++) keccak_round(a, KECCAK_RC[r]); break;
        case 2: keccak_rounds<2>(a); break;
        case 24: keccak_rounds<24>(a); break;
        default: return -1;
        }
        for (int k = 0; k < 25; k++) {
            s[2 * k] = (uint32_t)a[k];
            s[2 * k + 1] = (uint32_t)(a[k] >> 32);
        }
    }
    return 0;
}

// the sponge over n streams: words u32[W], offsets int64[n + 1], digests
// int32[n, 8]
extern "C" int eravm_k3s_host(const void *words, const void *offsets,
                              void *digests, int n) {
    for (int t = 0; t < n; t++)
        k3s_run_stream((const uint32_t *)words, (const int64_t *)offsets, t,
                       (int32_t *)digests);
    return 0;
}

// ecrecover_unit on n signatures: digest, r, s, addr int32[n, 8] (u32
// limbs), v and ok int32[n]
extern "C" int eravm_ecrecover_host(const void *digest, const void *v,
                                    const void *r, const void *s, void *ok,
                                    void *addr, int n) {
    for (int i = 0; i < n; i++) {
        U256 out;
        ((int32_t *)ok)[i] = ecrecover_unit(
            load_u256((const int32_t *)digest + 8 * i),
            (uint32_t)((const int32_t *)v)[i],
            load_u256((const int32_t *)r + 8 * i),
            load_u256((const int32_t *)s + 8 * i), &out);
        store_u256((int32_t *)addr + 8 * i, out);
    }
    return 0;
}

// the keccak256 / sha256 units alone (units_kernel), call after call
extern "C" int eravm_units_host(const UnitsArgs *args) {
    std::vector<uint32_t> win(8 * (args->ps_in > 0 ? args->ps_in : 1));
    for (int i = 0; i < args->n; i++) units_lane(*args, i, win.data(), 1);
    return 0;
}

// the ecrecover unit's field arithmetic on n pairs a, b int32[n, 8] (u32
// limbs) into out: op 0 a b mod p, 1 a b mod n, 2 a^2 mod p, 3 a^2 mod n,
// 4 1 / a mod p, 5 1 / a mod n, 6 a ** ((p + 1) / 4) mod p
extern "C" int eravm_fe_host(const void *a, const void *b, void *out, int n,
                             int op) {
    for (int i = 0; i < n; i++) {
        const U256 x = load_u256((const int32_t *)a + 8 * i);
        const U256 y = load_u256((const int32_t *)b + 8 * i);
        U256 r;
        switch (op) {
        case 0: r = fe_mul<false>(x, y); break;
        case 1: r = fe_mul<true>(x, y); break;
        case 2: r = fe_sqr<false>(x); break;
        case 3: r = fe_sqr<true>(x); break;
        case 4: r = fe_inv_p(x); break;
        case 5: r = fe_inv_n(x); break;
        case 6: r = fe_sqrt_pow(x); break;
        default: return 1;
        }
        store_u256((int32_t *)out + 8 * i, r);
    }
    return 0;
}

// the endomorphism split of n scalars k int32[n, 8] (each below the group
// order): out int32[n, 2, 7], per half its odd magnitude's 5 limbs, its
// sign and whether it was even
extern "C" int eravm_secp_split_host(const void *k, void *out, int n) {
    for (int i = 0; i < n; i++) {
        EcScalar h[2];
        ec_split(load_u256((const int32_t *)k + 8 * i), &h[0], &h[1]);
        int32_t *o = (int32_t *)out + 14 * i;
        for (int j = 0; j < 2; j++) {
            for (int l = 0; l < 5; l++) o[7 * j + l] = (int32_t)h[j].m[l];
            o[7 * j + 5] = h[j].neg;
            o[7 * j + 6] = h[j].even;
        }
    }
    return 0;
}

// the round-witness splice, lane after lane: the flag blocks' partials as
// pq_flag_kernel writes them and the table as its last block does, then
// each lane's emit words, scalars and range of rows as pq_move_kernel
// moves them
extern "C" int eravm_pq_splice_host(const SpliceArgs *args) {
    const SpliceArgs &a = *args;
    if (a.n <= 0 || a.batch <= 0) return 0;
    if (a.n > PQ_MAX_CYCLES || a.ps <= 0 || a.ps_in <= 0 || a.ps_in >= a.ps
            || a.ps >= 0x10000 || a.cap < a.ps)
        return 1;
    const uint64_t B = a.batch;
    const int blocks = pq_flag_blocks(a.batch);
    const int gx = blocks / PQ_FLAG_GROUPS;
    for (int i = 0; i < blocks; i++) {
        const int x = i % gx, c0 = i / gx * PQ_FLAG_CYCLES;
        uint32_t mask[PQ_MASK_WORDS] = {0, 0, 0, 0};
        int32_t m = 0x7fffffff;
        for (int b = x * PQ_FLAG_LANES;
             b < a.batch && b < (x + 1) * PQ_FLAG_LANES; b++) {
            for (int c = c0; c < a.n && c < c0 + PQ_FLAG_CYCLES; c++)
                if (a.emit[c * B + b] != 0) mask[c >> 5] |= 1u << (c & 31);
            if (c0 == 0) m = a.pq_blocks[b] < m ? a.pq_blocks[b] : m;
        }
        for (int w = 0; w < PQ_MASK_WORDS; w++)
            a.scratch[i * 5 + w] = (int32_t)mask[w];
        a.scratch[i * 5 + 4] = m;
    }
    const SpliceClock k = splice_clock(a, a.scratch, blocks, 0, 1);
    int32_t *table = a.scratch + blocks * 5;
    for (int c = 0; c < a.n; c++) splice_table_cycle(k, c, table);
    const int r0 = table[0], n_rows = table[1];
    std::vector<int32_t> emitk(a.n);
    for (int b = 0; b < a.batch; b++) {
        int32_t count = 0;
        bool err = false;
        for (int c = 0; c < a.n; c++)
            emitk[c] = splice_lane_cycle(a, table, c, b, &count, &err);
        a.pq_count[b] += count;
        if (err) a.lane_error[b] = 1;
        a.pq_blocks[b] += table[2];
        for (int j = 0; j < n_rows; j++) {
            const int32_t m = table[PQ_TABLE_MAP + j];
            const int c = m >> 16, i = m & 0xffff;
            const bool data = pq_data_row(emitk[c], i, a.ps_in);
            const uint64_t row = (uint64_t)b * a.cap + r0 + j;
            for (int w = 0; w < PQ_ROW_WORDS; w++) {
                const int32_t v = data ? *splice_src(a, c, i, w, b) : 0;
                if (w < 4) a.pq_meta[row * 4 + w] = v;
                else if (w < 12) a.pq_value[row * 8 + w - 4] = v;
                else a.pq_flags[row] = v;
            }
        }
    }
    return 0;
}

// P1 over rows u32[50, B] (batch-last)
extern "C" int eravm_p1_host(void *rows, int B, int iters, int unroll) {
    if (iters % unroll != 0) return 1;
    for (int b = 0; b < B; b++) {
        if (unroll == 1) p1_run_state<1>((uint32_t *)rows, B, b, iters);
        else if (unroll == 2) p1_run_state<2>((uint32_t *)rows, B, b, iters);
        else if (unroll == 4) p1_run_state<4>((uint32_t *)rows, B, b, iters);
        else return 1;
    }
    return 0;
}

// the host's emulated warp: p2_kernel's phase functions run lane after
// lane, every lane finishing a phase before any lane starts the next, so
// that an emulated shuffle (p2_from) reads what its source lane wrote
struct P2HostWarp {
    P2Regs *lanes;
    template <class F> void each(F f) const {
        for (int t = 0; t < 32; t++) f(lanes[t], t);
    }
};

// P2 (fused = 0) or P5 (fused = 1) over state u32[1600, cols], a column
// after another, each on an emulated warp
extern "C" int eravm_p2_host(void *state, int cols, int iters, int fused) {
    std::vector<P2Regs> lanes(32);
    const P2HostWarp w{lanes.data()};
    uint32_t *st = (uint32_t *)state;
    for (int c = 0; c < cols; c++) {
        for (int t = 0; t < 32; t++) p2_load(lanes[t], st, cols, c, t);
        if (fused) p2_permute<true>(w, iters);
        else p2_permute<false>(w, iters);
        for (int t = 0; t < 32; t++) p2_store(lanes[t], st, cols, c, t);
    }
    return 0;
}

// rho + pi's lane map as p2_rho moves it: out int32[1600], for each plane
// of rho's output the plane of its input that it came from (every register
// of the emulated warp labelled with its own plane, then one p2_rho<false>)
extern "C" int eravm_p2_rho_host(void *out) {
    std::vector<P2Regs> lanes(32);
    const P2HostWarp w{lanes.data()};
    for (int t = 0; t < 32; t++)
        for (int i = 0; i < 50; i++)
            lanes[t].a[i] = (uint32_t)((i >> 1) * 64 + 2 * t + (i & 1));
    w.each([&](P2Regs &x, int t) { p2_rho<false>(x, t); });
    for (int t = 0; t < 32; t++)
        for (int i = 0; i < 50; i++)
            ((int32_t *)out)[(i >> 1) * 64 + 2 * t + (i & 1)] =
                (int32_t)lanes[t].b[i];
    return 0;
}

// P3 over st u32[rows, n]: op 0 xor, 1 mix, 2 andnot; rows 8
extern "C" int eravm_p3_host(void *st, int rows, int n, int steps, int op) {
    for (int i = 0; i < n; i++) {
        uint32_t *p = (uint32_t *)st;
#define P3_CASE(OP, ROWS) \
        if (op == OP && rows == ROWS) { \
            p3_run_column<OP, ROWS>(p, n, i, steps); continue; }
        P3_CASE(kXor, 8) P3_CASE(kMix, 8) P3_CASE(kAndNot, 8)
#undef P3_CASE
        return 1;
    }
    return 0;
}

extern "C" int eravm_p4_host(void *states, int n, int iters) {
    for (int i = 0; i < n; i++) p4_run_state((int32_t *)states, i, iters);
    return 0;
}

// P6: out u32[8, TB] from arena u32[8, W, TB] (or u32[TB, 8, W] when
// lane_major) and idx u32[TB], as eravm_p6_launch computes it: each group
// of 32 lanes a warp (mode 1: lane 0's index where every live lane holds
// it), its gathers split over S warps and their sums added as the group's
// first warp adds them from shared memory
extern "C" int eravm_p6_host(const void *arena, const void *idx, void *out,
                             int W, int TB, int reps, int mode,
                             int lane_major, int S) {
    const uint32_t *ix = (const uint32_t *)idx;
    for (int k = 0; k < 8; k++)
        for (int t0 = 0; t0 < TB; t0 += 32) {
            const int n = TB - t0 < 32 ? TB - t0 : 32;
            bool uniform = true;
            for (int t = t0; t < t0 + n; t++) uniform &= ix[t] == ix[t0];
            for (int t = t0; t < t0 + n; t++) {
                const uint32_t i = mode == 1 && uniform ? ix[t0] : ix[t];
                uint32_t acc = 0;
                for (int s = 0; s < S && i < (uint32_t)W; s++)
                    acc += p6_reps((const uint32_t *)arena +
                                       p6_offset(W, TB, k, i, t, lane_major),
                                   p6_share(reps, S, s), 0);
                ((uint32_t *)out)[(uint64_t)k * TB + t] = acc;
            }
        }
    return 0;
}

// P6's word reads: out u32[8, TB] from a word arena (layouts as
// eravm_p6w_launch), the gathers split over S warps as there
extern "C" int eravm_p6w_host(const void *arena, const void *idx, void *out,
                              int W, int TB, int reps, int layout, int S) {
    for (int t = 0; t < TB; t++) {
        uint32_t acc[8] = {0}, part[8];
        for (int s = 0; s < S; s++) {
            p6w_sum((const uint32_t *)arena, W, TB, layout,
                    ((const uint32_t *)idx)[t], t, p6_share(reps, S, s), 0,
                    part);
            for (int l = 0; l < 8; l++) acc[l] += part[l];
        }
        for (int l = 0; l < 8; l++) ((uint32_t *)out)[(uint64_t)l * TB + t] = acc[l];
    }
    return 0;
}

// P6's bound measurements (eravm_p6c_launch): blocks = 0 the chain, out
// u32[n] from arena and start u32[n]; else the lines, out u32[blocks, n]
extern "C" int eravm_p6c_host(const void *arena, const void *start, void *out,
                              int n, int reps, int blocks) {
    const uint32_t *a = (const uint32_t *)arena;
    for (int b = 0; b < (blocks ? blocks : 1); b++)
        for (int t = 0; t < n; t++)
            ((uint32_t *)out)[(uint64_t)b * n + t] = blocks
                ? p6r_sum(a, n, b, t, reps)
                : p6c_chase(a, ((const uint32_t *)start)[t], reps);
    return 0;
}

// P7 over flags u32[kq, B] and st u32[51, B]
extern "C" int eravm_p7_host(const void *flags, void *st, int B, int kq,
                             int variant) {
    for (int b = 0; b < B; b++) {
        const uint32_t *f = (const uint32_t *)flags;
        uint32_t *p = (uint32_t *)st;
        if (variant == kOld) p7_run_lane<kOld>(f, p, B, kq, b);
        else if (variant == kWrapB) p7_run_lane<kWrapB>(f, p, B, kq, b);
        else if (variant == kSel) p7_run_lane<kSel>(f, p, B, kq, b);
        else if (variant == kTwo) p7_run_lane<kTwo>(f, p, B, kq, b);
        else return 1;
    }
    return 0;
}
