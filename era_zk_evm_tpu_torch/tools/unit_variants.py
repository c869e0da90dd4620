"""Time-only variant trees of K1's keccak256 / sha256 precompile units, for
decomposing the kPrecomp instance's time on the card, and trees with other
unrolls of keccak.cuh's permutation.

    python -m era_zk_evm_tpu_torch.tools.unit_variants --src DIR --out DIR
        [--design old|new|perm|splice|bitslice|uniform]
        [--variants name,...]

Copies the checkout `--src` (a tree of the repository, e.g. the parent
commit unpacked with `git archive`) once per variant into `--out/<name>`,
with an edit to `era_zk_evm_tpu_torch/csrc/` that takes a piece of the
units' work away (or builds it another way: `perm_k3`, `sha_unrolled`,
`unit_noinline`, `smem_window`), and prints the trees' paths.  Each tree then
goes to `tools/k1_times.py --tree`, beside the unedited tree, in one call
on one card: the difference of two times is the piece's cost.  The
variants compute wrong results: they serve timing only, and no program
path reads them.  `--design old` edits the units as they were up to the
byte-window design (commit e7a4b83), `new` the units that read each input
word once into shared memory.  `--design perm` gives keccak_f1600 (K2, K3,
the sponge, P1, P7) t rounds a loop trip (`tripT`, 24: no round loop)
where the tree's own runs four, or theta's D formed apart (`theta_d`):
these compute right results, and each tree times against the unedited
one to choose the form.  `--design splice` prices the round-witness
splice's design (csrc/pq_splice.cu): other step and block sizes, one step
buffer in place of two, 4-byte stores in place of 16-byte ones, and K1
storing every row of a call's block again (`k1_all_rows`); these compute
right results too (K1's extra rows are ones the splice never reads), but
`no_reads` and `no_stores`, which time the move without its reads or its
stores.  `--design bitslice` prices the bit-sliced probes P2 / P5
(csrc/probe_keccak.cu, a warp a column): rho through shared memory in
place of shuffles (`rho_shared`, built on the card only), 1 or 2 warps a
block (`warps1`, `warps2`) where the tree has 4, registers capped for 5
blocks an SM (`minblocks5`), 1, 2, 4, 6, 12 or 24 rounds a loop trip
(`tripT`) where it has 8, and P5's D formed at the receiver
(`p5_d_at_receiver`); these compute right results, timed with
`k1_times.py --tree T --cases bitslice`, which holds each against K3.
`--design uniform` prices the uniform-index probe P6
(csrc/probe_uniform.cu): in place of its weak loads (`ld.global`), weak
ones through L2 alone (`cg`), strong ones at the CTA's scope (`relaxed`,
served by L1) or at the system's (`strong`, LDG.E.STRONG.SYS, past L1); 8
or 32 loads a trip in flight (`inflight8`, `inflight32`) where it has 16;
every load at the element's own address, without the offset by a kernel
argument that the wrapper passes as 0 (`same_address`: ptxas then folds
the weak loads into one; `relaxed_same`, the CTA-scope strong loads at
one address, which it keeps); and the block's arena tile staged once into shared
memory by bulk copies, each gather then one `ld.shared` (`staged`, the
form closest to the TPU kernel's VMEM arena, built on the card only;
where W <= 256 and TB is a multiple of 32).  These compute right results, timed with `k1_times.py
--tree T --cases uniform`, which holds each against its plain version;
the split S is an argument of the launch, which that case times itself.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil

SOURCE = "era_zk_evm_tpu_torch/csrc/cycle_kernel.cu"

#: P6's staged form (the `uniform` design's `staged`): a block of S warps
#: over one lane group at one k copies the group's arena tile, W x 32
#: elements, into shared memory once (bulk copies, an mbarrier counting
#: their bytes), then gathers from it: batch-last [W][32], a uniform
#: index's 32 lanes on 32 banks; lane-major [32][W], on one bank where W is
#: a multiple of 32
P6_STAGED_KERNEL = r"""constexpr int kP6StageW = 256;

__global__ void __launch_bounds__(32 * kP6MaxSplit)
    p6s_kernel(const uint32_t *arena, const uint32_t *idx, uint32_t *out,
               int W, int TB, int reps, int mode, int lane_major, int S,
               uint32_t zero) {
    __shared__ alignas(128) uint32_t tile[kP6StageW * 32];
    __shared__ uint32_t part[32 * kP6MaxSplit];
    __shared__ alignas(8) uint64_t bar;
    const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
    const int t0 = blockIdx.x * 32, t = t0 + lane, k = blockIdx.y;
    const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar);
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(tile);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
        asm volatile("fence.mbarrier_init.release.cluster;");
    }
    __syncthreads();
    if (s == 0) {
        const int rows = lane_major ? 32 : W;
        const uint32_t row_bytes = lane_major ? 4 * W : 128;
        if (lane == 0)
            asm volatile("{ .reg .b64 st; mbarrier.arrive.expect_tx."
                         "shared::cta.b64 st, [%0], %1; }"
                         ::"r"(b), "r"(rows * row_bytes) : "memory");
        __syncwarp();
        for (int row = lane; row < rows; row += 32) {
            const uint32_t *src = arena + (lane_major
                ? ((uint64_t)(t0 + row) * 8 + k) * W
                : ((uint64_t)k * W + row) * TB + t0);
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                         "complete_tx::bytes [%0], [%1], %2, [%3];"
                         ::"r"(dst + row * row_bytes), "l"(src),
                         "r"(row_bytes), "r"(b) : "memory");
        }
    }
    uint32_t done = 0;
    while (!done)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta"
                     ".b64 p, [%1], 0; selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(b) : "memory");
    const bool live = t < TB;
    const uint32_t i = p6_index(live ? idx[t] : 0, live, mode);
    uint32_t acc = 0;
    if (live && i < (uint32_t)W) {
        // as p6_reps: load j of a trip at 4j x zero bytes on, the trip's
        // address moved on by 4 kP6InFlight x zero (zero = 0)
        uint32_t a = dst + 4 * (lane_major ? lane * W + i : i * 32 + lane);
        const int n = p6_share(reps, S, s);
        int r = 0;
        for (; r + kP6InFlight <= n; r += kP6InFlight,
                                     a += 4 * kP6InFlight * zero) {
            uint32_t v[kP6InFlight];
#pragma unroll
            for (int j = 0; j < kP6InFlight; j++)
                asm volatile("{ .reg .u32 b; mad.lo.u32 b, %1, %2, %3; "
                             "ld.shared.u32 %0, [b]; }"
                             : "=r"(v[j]) : "r"(zero), "r"(4 * j), "r"(a));
#pragma unroll
            for (int j = 0; j < kP6InFlight; j++) acc += v[j];
        }
        for (; r < n; r++, a += 4 * zero) {
            uint32_t v;
            asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
            acc += v;
        }
    }
    if (S > 1) {
        part[threadIdx.x] = acc;
        __syncthreads();
        if (s == 0)
            for (int q = 1; q < S; q++) acc += part[q * 32 + lane];
    }
    if (s == 0 && live) out[(uint64_t)k * TB + t] = acc;
}
"""

#: variant -> [(old text, new text)] for each design, or (file, old text,
#: new text) for a file of csrc/ other than cycle_kernel.cu; every old text
#: must occur in its file exactly once
VARIANTS = {
    "old": {
        # the unit returns at entry: K1 with the call but no unit work
        "unit_off": [("    *emit = *nslots = 0;\n",
                      "    *emit = *nslots = 0;\n    return false;\n")],
        # keccak-f and the compression emptied (the input still consumed)
        "no_perm": [
            ("        keccak_f1600(st);\n", ""),
            ("        sha256_compress(st, blk);\n",
             "        for (int i = 0; i < 8; i++) st[i] ^= blk[i] ^ blk[8 + i];\n"),
        ],
        # the absorb's frame reads and byte window emptied (padding kept)
        "no_absorb": [
            ("        for (int w = 0; w < 6; w++) {\n",
             "        for (int w = 0; w < 0; w++) {\n"),
            ("uint32_t byte = g < in_len ? window[sh + j] : 0u;",
             "uint32_t byte = 0u;"),
            ("        const U256 w0 = frame_word(a, b, on_h, slot, in_off + 2 * k);\n"
             "        const U256 w1 = frame_word(a, b, on_h, slot, in_off + 2 * k + 1);\n",
             "        const U256 w0 = u256_zero(), w1 = u256_zero();\n"),
        ],
        # the mem_in rows' second read of each input word gone (zeros)
        "rows_noread": [("(in_row ? frame_word(a, b, r_on_h, r_slot, idx)",
                         "(in_row ? u256_zero()")],
        # no round-witness row written (emit flag and slot count kept)
        "no_rows": [("for (uint32_t i = 0; i <= last; i++) {",
                     "for (uint32_t i = 0; i < 0u; i++) {")],
        # the window's shared memory allocated, unused: what the smaller
        # L1 left beside it costs the old design
        "smem_window": [
            ("    const int smem = threads * RF_WORDS * (int)sizeof(uint32_t);",
             "    const int smem = threads * (RF_WORDS + (kPrecomp ? 8 * "
             "args->pq_slots_in : 0)) * (int)sizeof(uint32_t);")],
    },
    "new": {
        "unit_off": [("    *emit = *nslots = 0;\n",
                      "    *emit = *nslots = 0;\n    return false;\n")],
        "no_perm": [
            ("        keccak_f1600_unit(st);\n", ""),
            ("        sha256_compress(st, blk);\n",
             "        for (int i = 0; i < 8; i++) st[i] ^= blk[i] ^ blk[8 + i];\n"),
        ],
        # K2's and K3's permutation (rotations read from a table) in place
        # of the unit's own
        "perm_k3": [("        keccak_f1600_unit(st);\n",
                     "        keccak_f1600(st);\n")],
        # the unit out of line (a call from the interpreter's cycle)
        "unit_noinline": [("HD bool precompile_unit(",
                           "HD_NOINLINE bool precompile_unit(")],
        # the compression's 64 rounds all unrolled (4 trips of 16)
        "sha_unrolled": [
            ("sha256.cuh", "#pragma unroll 1\n#endif\n"
             "    for (int r = 0; r < 64; r += 16) {",
             "#pragma unroll\n#endif\n"
             "    for (int r = 0; r < 64; r += 16) {")],
        # the input words' loads into the window gone (the window stale)
        "no_stage": [("    stage_words(fr, first, n_load, win, rs);\n",
                      "    stage_words(fr, first, 0, win, rs);\n")],
        # the rate lanes' assembly from the window gone
        "no_lanes": [("            st[l] ^= x;\n", "")],
        "no_rows": [
            ("    if (a.pq_capacity > 0) {\n        // rows: the mem_in rows",
             "    if (false) {\n        // rows: the mem_in rows"),
            ("    if (a.pq_capacity > 0) {\n        // the mem_out row",
             "    if (a.pq_capacity > 0) {\n"
             "        *emit = PQ_EMIT(n_in, n_out);\n"
             "        *nslots = n_words + 1 + is_ec;\n    }\n"
             "    if (false) {\n        // the mem_out row"),
        ],
    },
    "splice": {
        # the move's step of 4, 16 or 32 rows (8 in the tree)
        **{f"chunk{r}": [("pq_splice.cu", "#define PQ_CHUNK 8 ",
                          f"#define PQ_CHUNK {r} ")] for r in (4, 16, 32)},
        # blocks of 512 threads, steps of 16 rows (a row a warp)
        "threads512": [("pq_splice.cu", "#define PQ_CHUNK 8 ",
                        "#define PQ_CHUNK 16 "),
                       ("pq_splice.cu", "#define PQ_MOVE_THREADS 256\n",
                        "#define PQ_MOVE_THREADS 512\n")],
        # time only: no scratch word read (all zero fills), or no queue
        # row stored: what the reads and the stores cost alone
        "no_reads": [("pq_splice.cu",
                      "        const bool d = pq_data_row(emitk[c * PQ_TILE "
                      "+ l], i, a.ps_in);\n",
                      "        const bool d = false;\n")],
        "no_stores": [("pq_splice.cu",
                       "        pq_move_store(a, bufs + (s & 1) * BUF, b0, "
                       "lanes,\n",
                       "        if (n_rows < 0) pq_move_store(a, bufs + "
                       "(s & 1) * BUF, b0, lanes,\n")],
        # one buffer: a step's copies issued after the last step's stores
        "one_buffer": [
            ("pq_splice.cu",
             "        if (s + 1 < steps) {\n",
             "        cp_async_wait<0>();\n        __syncthreads();\n"
             "        pq_move_store(a, bufs, b0, lanes, (uint64_t)r0 + j0,\n"
             "                      n_rows - j0 < PQ_CHUNK ? n_rows - j0"
             " : PQ_CHUNK);\n        __syncthreads();\n"
             "        if (s + 1 < steps) {\n"),
            ("pq_splice.cu",
             "            pq_move_issue(a, emitk, map, bufs + ((s + 1) & 1) "
             "* BUF, b0,\n",
             "            pq_move_issue(a, emitk, map, bufs, b0,\n"),
            ("pq_splice.cu",
             "        cp_async_commit();\n        cp_async_wait<1>();\n"
             "        __syncthreads();\n        const int left = n_rows - "
             "j0;\n        pq_move_store(a, bufs + (s & 1) * BUF, b0, "
             "lanes,\n                      (uint64_t)r0 + j0, left < "
             "PQ_CHUNK ? left : PQ_CHUNK);\n        __syncthreads();\n",
             "        cp_async_commit();\n")],
        # the queue's rows stored as 4-byte words, not 16-byte ones
        "word_stores": [
            ("pq_splice.cu",
             "        ((int4 *)a.pq_meta)[row] = make_int4(t[0], t[PQ_PAD], "
             "t[2 * PQ_PAD],\n                                             "
             "t[3 * PQ_PAD]);\n",
             "        for (int q = 0; q < 4; q++)\n"
             "            a.pq_meta[row * 4 + q] = t[q * PQ_PAD];\n"),
            ("pq_splice.cu",
             "        ((int4 *)a.pq_value)[row * 2 + h] = make_int4(\n"
             "            t[0], t[PQ_PAD], t[2 * PQ_PAD], t[3 * PQ_PAD]);\n",
             "        for (int q = 0; q < 4; q++)\n"
             "            a.pq_value[row * 8 + 4 * h + q] = t[q * PQ_PAD];\n")],
        # K1 stores every row of a call's block again, zeros too (the
        # splice still reads only the data rows): what the contract saves
        "k1_all_rows": [
            ("        for (uint32_t i = 0; i < n_in; i++) {\n",
             "        for (uint32_t i = 0; i < ps_in; i++) {\n"),
            ("            const U256 val = window_word(win, rs, i);\n",
             "            const U256 val = i < n_in ? window_word(win, rs, i)"
             " : u256_zero();\n"),
            ("        for (uint32_t j = 0; j < n_out; j++) {\n",
             "        for (uint32_t j = 0; j < ps_out; j++) {\n"),
            ("            const U256 val = j ? out2 : out;\n",
             "            const U256 val = j >= n_out ? u256_zero()"
             " : (j ? out2 : out);\n")],
    },
    "bitslice": {
        # rho (and P5's D) through a shared-memory buffer a warp in place
        # of shuffles (card only: the g++ build has no shared memory)
        "rho_shared": [
            ("probe_keccak.cu",
             "HD void p2_rho(P2Regs &x, int t) {\n",
             "HD void p2_rho(P2Regs &x, int t) {\n"
             "    __shared__ uint32_t staged[kP2Warps][60 * 32];\n"
             "    uint32_t *buf = staged[threadIdx.x >> 5];\n"
             "    __syncwarp();\n"
             "    for (int j = 0; j < 50; j++) buf[j * 32 + t] = x.a[j];\n"
             "    if (kFused)\n"
             "        for (int j = 0; j < 10; j++) buf[(50 + j) * 32 + t] = "
             "x.d[j];\n"
             "    __syncwarp();\n"),
            ("probe_keccak.cu",
             "uint32_t v = p2_from(x, &x.a[2 * src + hs], t, k);",
             "uint32_t v = buf[(2 * src + hs) * 32 + ((t - k) & 31)];"),
            ("probe_keccak.cu",
             "if (kFused) v ^= p2_from(x, &x.d[2 * (src % 5) + hs], t, k);",
             "if (kFused) v ^= buf[(50 + 2 * (src % 5) + hs) * 32"
             " + ((t - k) & 31)];")],
        # 1 or 2 warps (columns) a block where the tree has 4
        **{f"warps{w}": [("probe_keccak.cu", "constexpr int kP2Warps = 4;",
                          f"constexpr int kP2Warps = {w};")]
           for w in (1, 2)},
        # registers capped so that an SM holds 5 blocks (20 warps) where
        # the tree's ~128 registers let it hold 4
        "minblocks5": [("probe_keccak.cu",
                        "__launch_bounds__(32 * kP2Warps, 1)\n",
                        "__launch_bounds__(32 * kP2Warps, 5)\n")],
        # 1 to 24 rounds a loop trip where the tree has 8
        **{f"trip{t}": [("probe_keccak.cu", "constexpr int kP2Trip = 8;",
                         f"constexpr int kP2Trip = {t};")]
           for t in (1, 2, 4, 6, 12, 24)},
        # P5: no D formed at the sender (nor theta's exchange); the receiver
        # forms it from C[xs - 1] at the plane's z and C[xs + 1] at z - 1,
        # shuffled from the source (three shuffles a register, not two)
        "p5_d_at_receiver": [
            ("probe_keccak.cu",
             "    w.each([&](P2Regs &x, int t) { p2_exchange(x, t); });\n",
             "    if (!kFused)\n"
             "        w.each([&](P2Regs &x, int t) { p2_exchange(x, t); });\n"),
            ("probe_keccak.cu",
             "    else w.each([&](P2Regs &x, int) { p5_d(x); });\n", ""),
            ("probe_keccak.cu",
             "if (kFused) v ^= p2_from(x, &x.d[2 * (src % 5) + hs], t, k);",
             "if (kFused)\n"
             "            v ^= p2_from(x, &x.c[2 * ((src % 5 + 4) % 5) + hs], t, k)\n"
             "                ^ (hs ? p2_from(x, &x.c[2 * ((src % 5 + 1) % 5)], t, k)\n"
             "                      : p2_from(x, &x.c[2 * ((src % 5 + 1) % 5) + 1],\n"
             "                                t, k + 1));")],
    },
    "uniform": {
        **{name: [("probe_uniform.cu", '#define P6_LD_OP "ld.global"\n',
                   f'#define P6_LD_OP "{op}"\n')]
           for name, op in (("cg", "ld.global.cg"),
                            ("relaxed", "ld.relaxed.cta.global"),
                            ("strong", "ld.volatile.global"))},
        **{f"inflight{n}": [("probe_uniform.cu",
                             "constexpr int kP6InFlight = 16;",
                             f"constexpr int kP6InFlight = {n};")]
           for n in (8, 32)},
        "same_address": [("probe_uniform.cu",
                          "constexpr bool kP6Offset = true;",
                          "constexpr bool kP6Offset = false;")],
        "relaxed_same": [("probe_uniform.cu",
                          '#define P6_LD_OP "ld.global"\n',
                          '#define P6_LD_OP "ld.relaxed.cta.global"\n'),
                         ("probe_uniform.cu",
                          "constexpr bool kP6Offset = true;",
                          "constexpr bool kP6Offset = false;")],
        "staged": [
            ("probe_uniform.cu",
             "// arena u32[8, W, TB] (lane_major 0) or u32[TB, 8, W] "
             "(lane_major 1), idx\n",
             P6_STAGED_KERNEL + "\n// arena u32[8, W, TB] (lane_major 0) or "
             "u32[TB, 8, W] (lane_major 1), idx\n"),
            ("probe_uniform.cu",
             "    p6_shape(TB, S, 8, &grid, &block);\n",
             "    if (W <= kP6StageW && W % 4 == 0 && TB % 32 == 0) {\n"
             "        p6s_kernel<<<dim3(TB / 32, 8), 32 * S, 0,\n"
             "                     (cudaStream_t)stream>>>(\n"
             "            (const uint32_t *)arena, (const uint32_t *)idx,\n"
             "            (uint32_t *)out, W, TB, reps, mode, lane_major, S,\n"
             "            (uint32_t)zero);\n"
             "        return (int)cudaGetLastError();\n    }\n"
             "    p6_shape(TB, S, 8, &grid, &block);\n")],
    },
    "perm": {
        **{f"trip{t}": [("keccak.cuh", "constexpr int kKeccakTrip = 4;",
                         f"constexpr int kKeccakTrip = {t};")]
           for t in (1, 2, 24)},
        # theta's D named once a column, as keccak.cuh had it first
        "theta_d": [("keccak.cuh",
                     "const uint64_t r = rotl64(c[(x + 1) % 5], 1);",
                     "const uint64_t r = c[(x + 4) % 5] ^ "
                     "rotl64(c[(x + 1) % 5], 1);"),
                    ("keccak.cuh", "a[x + 5 * y] ^ c[(x + 4) % 5] ^ r,",
                     "a[x + 5 * y] ^ r,")],
    },
}


def make_variants(src: pathlib.Path, out: pathlib.Path, design: str,
                  names: list[str]) -> list[pathlib.Path]:
    trees = []
    for name in names:
        edits = VARIANTS[design][name]
        tree = out / name
        if tree.exists():
            shutil.rmtree(tree)
        shutil.copytree(src, tree, ignore=shutil.ignore_patterns(
            "_build", "__pycache__", ".checkout", ".git"))
        for edit in edits:
            path = tree / (SOURCE if len(edit) == 2 else
                           pathlib.Path(SOURCE).parent / edit[0])
            old, new = edit[-2:]
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"unit_variants: {name}: {old!r} occurs "
                                 f"{text.count(old)} times in {path}")
            path.write_text(text.replace(old, new))
        trees.append(tree)
    return trees


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the checkout to copy")
    ap.add_argument("--out", required=True, help="where the trees go")
    ap.add_argument("--design", choices=sorted(VARIANTS), default="new")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    names = (args.variants.split(",") if args.variants
             else list(VARIANTS[args.design]))
    for tree in make_variants(pathlib.Path(args.src), pathlib.Path(args.out),
                              args.design, names):
        print(tree)


if __name__ == "__main__":
    main()
