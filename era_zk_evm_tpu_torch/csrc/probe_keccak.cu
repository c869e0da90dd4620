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
// P2 / P5.  A thread per u32 column (8 * G8 columns, 32 states each).  A
// column's state is 1600 words, which no thread's registers hold (255 at
// most), so the state stays in two device buffers [1600][cols], the output
// and a scratch, read and written a plane at a time (neighbouring threads on
// neighbouring columns: every load coalesces), the round alternating the
// two as the TPU kernel does.  The theta parities C (320 words a column)
// go to shared memory, [320][blockDim], so that a warp's accesses fall in
// 32 banks.  rho and pi are plane renamings: chi reads plane
// 64 * lane + ((z - rho) mod 64) of the source lane.  P2 applies theta in
// place (1600 reads and writes a round) before chi; P5 XORs D = C[x - 1][z]
// ^ C[x + 1][z - 1] into each chi read instead.  Bound: integer operations
// (~3,840 a round for 32 states against 12.8 KB in and out a column); this
// design passes the state through device memory every round, so the loads'
// latency, with a warp or a few on an SM, is what it waits on.

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

// Source lane and rho offset of chi's k-th input (k = 0, 1, 2) for output
// lane (x, y): B[x + k][y] is A[xs][ys] rotated by rho, pi mapping (xs, ys)
// to (ys, 2 xs + 3 ys).  tools/probe_keccak.py::_bitslice_round_plan.
HD void p2_chi_source(int x, int y, int k, int *lane, int *rot) {
    const int xx = (x + k) % 5;
    const int ys = xx;
    const int xs = (((y - 3 * xx) % 5 + 5) % 5) * 3 % 5;
    *lane = xs + 5 * ys;
    *rot = KECCAK_ROT_C(xs + 5 * ys);
}

#define P2_AT(buf, p) (buf)[(uint64_t)(p) * (uint64_t)cols + col]
#define P2_D(x, z) \
    (C[(((x) + 4) % 5 * 64 + (z)) * cs] ^ \
     C[(((x) + 1) % 5 * 64 + (((z) + 63) & 63)) * cs])

// theta's column parities of src into C (the thread's 320 words at
// stride cs)
HD void p2_parities(const uint32_t *src, uint32_t *C, int cs, int cols,
                    int col) {
    for (int x = 0; x < 5; x++)
#ifdef __CUDACC__
#pragma unroll 4
#endif
        for (int z = 0; z < 64; z++) {
            uint32_t v = P2_AT(src, x * 64 + z);
            for (int y = 1; y < 5; y++) v ^= P2_AT(src, (x + 5 * y) * 64 + z);
            C[(x * 64 + z) * cs] = v;
        }
}

// P2's theta, in place: the five planes of a (x, z) are loaded before any
// is stored, so that their loads are in flight together
HD void p2_theta(uint32_t *a, const uint32_t *C, int cs, int cols, int col) {
    for (int x = 0; x < 5; x++)
        for (int z = 0; z < 64; z++) {
            const uint32_t d = P2_D(x, z);
            uint32_t v[5];
            for (int y = 0; y < 5; y++) v[y] = P2_AT(a, (x + 5 * y) * 64 + z);
            for (int y = 0; y < 5; y++) P2_AT(a, (x + 5 * y) * 64 + z) = v[y] ^ d;
        }
}

// rho, pi, chi and iota from src to dst (two buffers: the loads of later
// planes may pass the stores of earlier ones); with kFusedTheta, theta's D
// goes into each read
template <bool kFusedTheta>
HD void p2_chi(const uint32_t *__restrict__ src, uint32_t *__restrict__ dst,
               const uint32_t *C, int cs, int cols, int col, uint64_t rc) {
    for (int lane = 0; lane < 25; lane++) {
        const int x = lane % 5, y = lane / 5;
        int l0, r0, l1, r1, l2, r2;
        p2_chi_source(x, y, 0, &l0, &r0);
        p2_chi_source(x, y, 1, &l1, &r1);
        p2_chi_source(x, y, 2, &l2, &r2);
#ifdef __CUDACC__
#pragma unroll 4
#endif
        for (int z = 0; z < 64; z++) {
            const int z0 = (z - r0) & 63, z1 = (z - r1) & 63,
                      z2 = (z - r2) & 63;
            uint32_t a0 = P2_AT(src, l0 * 64 + z0),
                     a1 = P2_AT(src, l1 * 64 + z1),
                     a2 = P2_AT(src, l2 * 64 + z2);
            if (kFusedTheta) {
                a0 ^= P2_D(l0 % 5, z0);
                a1 ^= P2_D(l1 % 5, z1);
                a2 ^= P2_D(l2 % 5, z2);
            }
            uint32_t out = a0 ^ (~a1 & a2);
            if (lane == 0 && ((rc >> z) & 1)) out = ~out;       // iota
            P2_AT(dst, lane * 64 + z) = out;
        }
    }
}
#undef P2_D
#undef P2_AT

// One round from src to dst; C is the thread's 320 parity words at stride
// cs, the column's plane p at src[p * cols + col].
template <bool kFusedTheta>
HD void p2_round(uint32_t *src, uint32_t *dst, uint32_t *C, int cs,
                 int cols, int col, uint64_t rc) {
    p2_parities(src, C, cs, cols, col);
    if (!kFusedTheta) p2_theta(src, C, cs, cols, col);
    p2_chi<kFusedTheta>(src, dst, C, cs, cols, col, rc);
}

// `iters` permutations of one column: rounds alternate state -> scratch ->
// state, so that the result ends in `state`.
template <bool kFusedTheta>
HD void p2_run_column(uint32_t *state, uint32_t *scratch, uint32_t *C, int cs,
                      int cols, int col, int iters) {
    for (int t = 0; t < iters; t++)
        for (int r = 0; r < 24; r += 2) {
            p2_round<kFusedTheta>(state, scratch, C, cs, cols, col,
                                  KECCAK_RC[r]);
            p2_round<kFusedTheta>(scratch, state, C, cs, cols, col,
                                  KECCAK_RC[r + 1]);
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

constexpr int kP2Block = 32;   // threads a block: 320 x 4 x 32 = 40 KB shared

template <bool kFusedTheta>
__global__ void __launch_bounds__(kP2Block) p2_kernel(uint32_t *state,
                                                      uint32_t *scratch,
                                                      int cols, int iters) {
    __shared__ uint32_t parity[320 * kP2Block];
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col < cols)
        p2_run_column<kFusedTheta>(state, scratch, parity + threadIdx.x,
                                   kP2Block, cols, col, iters);
}

// state, scratch: u32[1600, cols] (cols = 8 * G8); permuted in place
extern "C" int eravm_p2_launch(void *state, void *scratch, int cols,
                               int iters, int fused, void *stream) {
    const int blocks = (cols + kP2Block - 1) / kP2Block;
    cudaStream_t s = (cudaStream_t)stream;
    if (fused)
        p2_kernel<true><<<blocks, kP2Block, 0, s>>>(
            (uint32_t *)state, (uint32_t *)scratch, cols, iters);
    else
        p2_kernel<false><<<blocks, kP2Block, 0, s>>>(
            (uint32_t *)state, (uint32_t *)scratch, cols, iters);
    return (int)cudaGetLastError();
}
#endif
