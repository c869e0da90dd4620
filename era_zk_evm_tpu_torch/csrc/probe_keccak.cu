// The keccak-f[1600] formulation probes P1, P2 and P5 (CUDA C++, sm_90a).
//
// Replace the TPU kernels of tools/probe_keccak.py:
//   P1 keccak_pallas_rows2d         `iters` chained keccak-f on states held
//                                   as dense rows ([25, 2, 8, B/8] inside);
//   P2 keccak_pallas_bitslice       `iters` keccak-f on 1600 bit-planes,
//                                   32 states per u32, two buffers;
//   P5 keccak_pallas_bitslice_fused P2 with theta applied in the chi reads.
// Their plain versions are in era_zk_evm_tpu_torch/tools/probe_keccak.py.
//
// P1.  A thread per state over a batch-last copy of the states (u32 word w
// of state b at rows[w * B + b], word 2k the low and 2k + 1 the high half of
// lane k), so that a warp's loads of one word coalesce, where K3 reads the
// lane-major [B, 25, 2] layout.  The permutation is keccak.cuh's, with
// `unroll` permutations per loop trip (a template parameter, 1, 2 or 4) and
// `tile` threads a block (at most 1024, the card's limit; the register cap
// follows from the block size).  Bound: integer operations, as K3.
//
// P2 / P5.  A warp per u32 column (8 * G8 columns of 32 states each), the
// column's 1600 planes in the warp's registers for the whole launch: lane t
// holds planes z = 2t (register 0) and 2t + 1 (register 1) of each of the
// 25 keccak lanes, 50 registers.  The warp reads its column once at the
// start and writes it once at the end; the 24 * iters rounds in between
// touch no global memory (and, but for the shared-memory variant below,
// no shared memory).  A round, in phases:
//   parities  C[x][z] = XOR over y, inside the lane (20 three-input XORs);
//   exchange  D[x][z] = C[x - 1][z] ^ C[x + 1][z - 1]: for z = 2t + 1 the
//             lane holds C[x + 1][2t]; for z = 2t it needs C[x + 1][2t - 1],
//             register 1 of lane t - 1 (mod 32): a shuffle a x, 5 a round;
//   theta     (P2) each register ^= its D, one three-input XOR (50);
//   rho + pi  output lane (y, 2x + 3y) at z is input lane (x, y) at z - r,
//             r = rho(x, y): with two z a lane, each output register comes
//             from one fixed register of one fixed lane (p2_rho_source):
//             47 shuffles a round at compile-time offsets (lane (0, 0) has
//             r = 0, and register 1 of r = 1 is the lane's own register 0);
//   chi+iota  one LOP3 a register (50); iota XORs lane (0, 0)'s registers
//             with masks of bits 2t and 2t + 1 of the round constant, whose
//             24 rounds' bits each lane packs into two words once a launch.
// P5 keeps its formulation: no theta pass; each chi input is the pre-theta
// plane XORed with its source plane's D, so D travels with its plane (a
// second shuffle beside each of rho's: 95 a round against P2's 52).
// Bound: integer operations (3,840 a round for 32 states, chip_smoke.py's
// BITSLICE_ROUND_OPS) against 12.8 KB in and out a column.  A P2
// warp-round is ~124 LOP3 on the SM's 64 int32 lanes (~62 cycles) beside
// 52 shuffles on its 32-lane shuffle unit; eight rounds a loop trip keep
// the lane's registers at ~128, so an SM holds 16 warps to hide the
// shuffles' latency (PERF.md: P2 at ~82% of its bound at G8 = 4096).
//
// The phase functions are each lane's (P2Regs, p2_from); p2_round composes
// them through a warp policy: on the card the thread is lane t (P2Lane),
// on the host (host_entry.cpp) every lane runs a phase before any lane runs
// the next, so that an emulated shuffle reads what its source lane wrote.
// Design choices priced by tools/unit_variants.py --design bitslice (all
// compute the same function): warps a block (kP2Warps), a register cap
// (__launch_bounds__' blocks an SM), rounds a loop trip (kP2Trip), and
// trees that edit p2_rho: rho through shared memory in place of shuffles,
// and P5's D formed at the receiver from shuffled parities.

#include "common.cuh"
#include "keccak.cuh"

// ---- P1 -------------------------------------------------------------------

HD void p1_load(const uint32_t *rows, int B, int b, uint64_t a[25]) {
    for (int k = 0; k < 25; k++)
        a[k] = (uint64_t)rows[(uint64_t)(2 * k) * B + b] |
               ((uint64_t)rows[(uint64_t)(2 * k + 1) * B + b] << 32);
}

HD void p1_store(uint32_t *rows, int B, int b, const uint64_t a[25]) {
    for (int k = 0; k < 25; k++) {
        rows[(uint64_t)(2 * k) * B + b] = (uint32_t)a[k];
        rows[(uint64_t)(2 * k + 1) * B + b] = (uint32_t)(a[k] >> 32);
    }
}

template <int kUnroll>
HD void p1_run_state(uint32_t *rows, int B, int b, int iters) {
    uint64_t a[25];
    p1_load(rows, B, b, a);
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int t = 0; t < iters; t += kUnroll) {
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int u = 0; u < kUnroll; u++) keccak_f1600(a);
    }
    p1_store(rows, B, b, a);
}

// ---- P2 / P5 ----------------------------------------------------------------

constexpr int kP2Warps = 4;            // warps (columns) a block
constexpr int kP2Trip = 8;             // rounds a loop trip (divides 24)
static_assert(24 % kP2Trip == 0, "kP2Trip must divide 24");

// A lane's registers: the state a (register h of keccak lane L at a[2L + h],
// plane L * 64 + 2t + h), rho's output b, the parities c (C[x] at c[2x + h]),
// the exchanged parities e (e[x] = C[x][2t - 1]), P5's D (d[2x + h]), the
// round constants' bits (bit r of iota[h]: bit 2t + h of round r's) and the
// current trip's (rc[h] = iota[h] >> the trip's first round).
struct P2Regs {
    uint32_t a[50], b[50], c[10], e[5], d[10], iota[2], rc[2];
};

// The register *v of x (a word of x's arrays) as lane t - k of the warp
// holds it (k a constant, taken mod 32; 0 is the lane's own register).  On
// the card a shuffle (its source lane is taken mod 32 by the hardware); on
// the host x is lanes[t] of the emulated warp's array, so the source is the
// word at v's byte offset inside lanes[t - k].
HD uint32_t p2_from(const P2Regs &x, const uint32_t *v, int t, int k) {
    if ((k & 31) == 0) return *v;
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, *v, t - k);
#else
    const P2Regs &src = (&x)[((t - k) & 31) - t];
    const int off = (int)((const char *)v - (const char *)&x);
    return *(const uint32_t *)((const char *)&src + off);
#endif
}

// rho + pi for register h of output keccak lane dst: output lane (y, 2x +
// 3y) is input lane (x, y) = src rotated by r = rho(x, y), so output z takes
// input z - r: register hs = (h + r) & 1 of lane t - k, k = (r + 1 - h) / 2
// (for r even register h of lane t - r/2; for r odd register 1 - h of lane
// t - (r + 1)/2 or t - (r - 1)/2).  tools/probe_keccak.py::
// bitslice_round_plan's first chi source, tests/test_torch_kernel_host.py.
HD void p2_rho_source(int dst, int h, int *src, int *hs, int *k) {
    const int y = dst % 5, x = (((dst / 5 - 3 * y) % 5 + 5) % 5) * 3 % 5;
    const int r = KECCAK_ROT_C(x + 5 * y);
    *src = x + 5 * y;
    *hs = (h + r) & 1;
    *k = (r + 1 - h) >> 1;
}

// the column's planes of lane t, and its round constants' bits
HD void p2_load(P2Regs &x, const uint32_t *state, int cols, int col, int t) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 50; i++)
        x.a[i] = state[(uint64_t)((i >> 1) * 64 + 2 * t + (i & 1)) * cols + col];
    x.iota[0] = x.iota[1] = 0;
    KECCAK_PRAGMA(unroll)
    for (int r = 0; r < 24; r++) {
        x.iota[0] |= (uint32_t)((KECCAK_RC[r] >> (2 * t)) & 1) << r;
        x.iota[1] |= (uint32_t)((KECCAK_RC[r] >> (2 * t + 1)) & 1) << r;
    }
}

HD void p2_store(const P2Regs &x, uint32_t *state, int cols, int col, int t) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 50; i++)
        state[(uint64_t)((i >> 1) * 64 + 2 * t + (i & 1)) * cols + col] = x.a[i];
}

// theta's parities C[x][2t + h], inside the lane
HD void p2_parities(P2Regs &x) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 10; i++)
        x.c[i] = x.a[i] ^ x.a[i + 10] ^ x.a[i + 20] ^ x.a[i + 30] ^ x.a[i + 40];
}

// theta's exchange: e[x] = C[x][2t - 1], register 1 of C[x] in lane t - 1
HD void p2_exchange(P2Regs &x, int t) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 5; i++) x.e[i] = p2_from(x, &x.c[2 * i + 1], t, 1);
}

// D[cx][2t + h] but for its first term, C[cx - 1][2t + h]: C[cx + 1] at
// z - 1 (the exchanged word for h = 0, the lane's register 0 for h = 1)
HD uint32_t p2_d_rest(const P2Regs &x, int cx, int h) {
    return h ? x.c[2 * ((cx + 1) % 5)] : x.e[(cx + 1) % 5];
}

// P2's theta, in place: a ^ C[x - 1] ^ the rest, one three-input XOR a
// register (D left unnamed, as in keccak.cuh)
HD void p2_theta(P2Regs &x) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 50; i++) {
        const int cx = (i >> 1) % 5, h = i & 1;
        x.a[i] = x.a[i] ^ x.c[2 * ((cx + 4) % 5) + h] ^ p2_d_rest(x, cx, h);
    }
}

// P5's D, formed at the sender so that it travels with its plane
HD void p5_d(P2Regs &x) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 10; i++)
        x.d[i] = x.c[2 * ((i / 2 + 4) % 5) + (i & 1)] ^ p2_d_rest(x, i / 2, i & 1);
}

// rho + pi into b: P2 moves the post-theta planes; P5 the pre-theta planes
// with their D, shuffled beside them
template <bool kFused>
HD void p2_rho(P2Regs &x, int t) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 50; i++) {
        int src, hs, k;
        p2_rho_source(i >> 1, i & 1, &src, &hs, &k);
        uint32_t v = p2_from(x, &x.a[2 * src + hs], t, k);
        if (kFused) v ^= p2_from(x, &x.d[2 * (src % 5) + hs], t, k);
        x.b[i] = v;
    }
}

// chi and iota into a: one LOP3 a register; round u of the trip's bits
HD void p2_chi(P2Regs &x, int u) {
    KECCAK_PRAGMA(unroll)
    for (int i = 0; i < 50; i++) {
        const int lx = (i >> 1) % 5, row = (i >> 1) - lx, h = i & 1;
        x.a[i] = x.b[i] ^ (~x.b[2 * (row + (lx + 1) % 5) + h]
                           & x.b[2 * (row + (lx + 2) % 5) + h]);
    }
    x.a[0] ^= 0u - ((x.rc[0] >> u) & 1u);
    x.a[1] ^= 0u - ((x.rc[1] >> u) & 1u);
}

// One round, phase after phase over the warp w (w.each(f) runs f(regs, t)
// for each of its lanes: once on the card, for the 32 lanes in turn on the
// host).
template <bool kFused, class Warp>
HD void p2_round(const Warp &w, int u) {
    w.each([&](P2Regs &x, int) { p2_parities(x); });
    w.each([&](P2Regs &x, int t) { p2_exchange(x, t); });
    if (!kFused) w.each([&](P2Regs &x, int) { p2_theta(x); });
    else w.each([&](P2Regs &x, int) { p5_d(x); });
    w.each([&](P2Regs &x, int t) { p2_rho<kFused>(x, t); });
    w.each([&](P2Regs &x, int) { p2_chi(x, u); });
}

// `iters` permutations of the warp's column, kP2Trip rounds a loop trip
template <bool kFused, class Warp>
HD void p2_permute(const Warp &w, int iters) {
    KECCAK_PRAGMA(unroll 1)
    for (int i = 0; i < iters; i++) {
        KECCAK_PRAGMA(unroll 1)
        for (int r = 0; r < 24; r += kP2Trip) {
            w.each([&](P2Regs &x, int) {
                x.rc[0] = x.iota[0] >> r;
                x.rc[1] = x.iota[1] >> r;
            });
            KECCAK_PRAGMA(unroll)
            for (int u = 0; u < kP2Trip; u++) p2_round<kFused>(w, u);
        }
    }
}

#ifdef __CUDACC__
template <int kUnroll, int kBlock>
__global__ void __launch_bounds__(kBlock) p1_kernel(uint32_t *rows, int B,
                                                    int iters) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b < B) p1_run_state<kUnroll>(rows, B, b, iters);
}

template <int kBlock>
static int p1_dispatch(uint32_t *rows, int B, int iters, int unroll,
                       int block, cudaStream_t stream) {
    const int blocks = (B + block - 1) / block;
    switch (unroll) {
    case 1: p1_kernel<1, kBlock><<<blocks, block, 0, stream>>>(rows, B, iters); break;
    case 2: p1_kernel<2, kBlock><<<blocks, block, 0, stream>>>(rows, B, iters); break;
    case 4: p1_kernel<4, kBlock><<<blocks, block, 0, stream>>>(rows, B, iters); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// rows: u32[50, B] batch-last; `tile` threads a block (<= 1024); iters a
// multiple of unroll (1, 2 or 4)
extern "C" int eravm_p1_launch(void *rows, int B, int iters, int tile,
                               int unroll, void *stream) {
    if (tile < 1 || tile > 1024 || iters % unroll != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return tile <= 256
        ? p1_dispatch<256>((uint32_t *)rows, B, iters, unroll, tile, s)
        : p1_dispatch<1024>((uint32_t *)rows, B, iters, unroll, tile, s);
}

// the card's warp: this thread is lane t of it
struct P2Lane {
    P2Regs *x;
    int t;
    template <class F> HD void each(F f) const { f(*x, t); }
};

// The blocks an SM is given as 1, which caps no register: ptxas schedules
// P5 4-5% faster with it than with the argument left out, at the same SASS
// a round (PERF.md, P5).
template <bool kFused>
__global__ void __launch_bounds__(32 * kP2Warps, 1)
p2_kernel(uint32_t *state, int cols, int iters) {
    const int col = blockIdx.x * kP2Warps + (threadIdx.x >> 5);
    if (col >= cols) return;      // the whole warp: no shuffle is left short
    P2Regs x;
    const P2Lane w{&x, (int)(threadIdx.x & 31)};
    p2_load(x, state, cols, col, w.t);
    p2_permute<kFused>(w, iters);
    p2_store(x, state, cols, col, w.t);
}

// state: u32[1600, cols] (cols = 8 * G8), permuted in place
extern "C" int eravm_p2_launch(void *state, int cols, int iters, int fused,
                               void *stream) {
    const int blocks = (cols + kP2Warps - 1) / kP2Warps;
    cudaStream_t s = (cudaStream_t)stream;
    if (fused)
        p2_kernel<true><<<blocks, 32 * kP2Warps, 0, s>>>((uint32_t *)state,
                                                         cols, iters);
    else
        p2_kernel<false><<<blocks, 32 * kP2Warps, 0, s>>>((uint32_t *)state,
                                                          cols, iters);
    return (int)cudaGetLastError();
}

// the warps an SM holds at once running p2_kernel<fused> (its occupancy
// at the launch's block size); -1 on error
extern "C" int eravm_p2_warps_per_sm(int fused) {
    int blocks = 0;
    const cudaError_t rc = fused
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, p2_kernel<true>, 32 * kP2Warps, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, p2_kernel<false>, 32 * kP2Warps, 0);
    return rc == cudaSuccess ? blocks * kP2Warps : -1;
}
#endif
