#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`era_zk_evm_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:
  device        a CUDA card is required; prints its name and power limit;
  build         compiles K1, K2, K3, the sponge, the splice and the probes
                from the sources in this tree; the ptxas lines (by kernel for
                K1, K2, the splice and the ecrecover unit alone) and K1's
                block size at B = 4096 and 32768 (its grid must span the
                card's SMs);
  native        the port's copy of the C++ scalar oracle (native/), built
                with g++ on the card's host beside the nvcc build: the g++
                version and the build's seconds;
  K1-small      K1 against its plain torch version on the family programs
                (both memory-witness modes), every state field equal;
  units-off     configs X and Y of testing/units_off.py (the precompile
                units, ecrecover or a precompile queue asked for without
                what they need) at 96 lanes through K1, every field equal
                to the plain engine on the CPU, and their lane_error;
  K1            WORKLOAD at B = 32768, one 128-cycle call, kernel vs plain;
  K1-ablate     K1's development hooks (models/fused_cycle.py: DEBUG_SKIP,
                DEBUG_STAGE; dev-only, their results wrong by design):
                two hooked builds of K1, compiled beside the main build,
                DEBUG_SKIP = {stack_rw, heap_rw} (a perfect cache's
                bound) and DEBUG_STAGE = 7 (the last cut before the
                cycle's first store), each timed on WORKLOAD at
                B = 32768 for 128 cycles beside the default K1 in the same
                phase, with their ptxas lines; checks: the stage-cut launch
                leaves every field but timestamp as the entry state had it
                (global_step advanced by the chunk), the skip build equals
                the default K1 on a program that touches neither arena
                (ablate_fused.PROG_ALU), and a default launch after both
                still equals its plain version;
  K1-b / K2     mode (b) at B = 32768: a second 128-cycle K1 chunk alone,
                timed, against the plain engine (every field, and K1's
                compacted records against the plain compaction of the
                engine's slot rows), then K2 folding those records against
                rolling_absorb_rows, with the bound of the work the
                records need (their permutations and bytes);
  K1-rolling-queue  the rolling commitment beside the memory queue, B =
                32768: two 64-cycle K1 + K2 chunks against the plain
                engine, every field and the digests;
  main-a/main-b the memory-witness main path at full size (bench geometry,
                B = 32768, WORKLOAD): 8 chained 128-cycle calls with a queue
                rewind between them, both modes; lanes 0..7 equal to a plain
                CPU run of the same calls;
  native-baseline  the oracle's single-core witness-traced cycles/s on the
                card's host, run on WORKLOAD as bench.py's
                measure_native_baseline runs it (one call), with the host's
                CPU model and vs_native, main-a's pipelined cycles/s over
                it;
  mesh          parallel.run_block on 4 shards of the card (8192 lanes a
                shard), main-a's and main-b's calls again: every gathered
                field equal to the unsharded main-path state, the aggregates
                to its sums, the rolling block commitment (K2's sponges, the
                digests gathered, one sponge launch) to the host fold of its
                lanes' digests; run_block_fused on fresh shards to the same;
                the walls of one call on 1 and 4 shards (shards of one card
                share it: not a scaling figure);
  K1-log-small  K1's storage-enabled instance (LOG family, FAR_CALL, log
                and decommit queues) against plain on the LOG and far-call
                program sets, 2 x 16 lanes, with their contracts;
  K1-storage    bench_storage's geometry, B = 32768, STORAGE_WORKLOAD: one
                128-cycle call kernel vs plain over the whole batch, then a
                second call timed;
  K1-farcall    bench_farcall's geometry, B = 16384, caller and callee with
                storage and code bank populated: 144 cycles kernel vs plain,
                again with the log and decommit queues on;
  K1-fuzz       tests/test_torch_fuzz.py's two campaigns (random
                programs; random far-call scenarios with their contracts),
                each cycled over B = 4096 lanes, 160 cycles kernel vs plain;
                each distinct program's first lane against the native
                oracle (native.compare.compare_lanes: status, cycles,
                registers, tags, flags, heap, the memory, log and decommit
                streams);
  K3            chained keccak-f against plain at N = 131072 x 1 (the
                fingerprints' shape, timed), 65536 x 4, 1 x 3 and 1000 x 2
                (a ragged last block), K3 in place on a copy, timed over
                10 launches back to back; times at bench_keccak's and
                bench_keccak_u32pair's shapes, and the plain version's
                at the second, equal; one permutation's latency on one
                thread (N = 1 chained) beside its bound, the
                permutation's SASS at one instruction a cycle; the SASS a
                keccak round of K3, K2, the sponge and the units alone
                (cuobjdump);
  P1 ... P7     the tool probes (era_zk_evm_tpu_torch/tools/): each kernel
                against its plain version on the card, small and at the
                tools' shapes where the plain version is quick; then the
                tools' entry points (`main`) with the launch counts, and
                CUDA-event times at the JAX tools' default shapes (P1
                131072 x 128, tile 2048; P2 / P5 G8 = 128 and 4096, the
                best of 3, each against the plain version and K3, with its
                share of the bound, the warps an SM holds, the SASS a
                round and P2 at G8 = 4096 over K3 on as many permutations
                (bench_keccak's 65536 x 2048); P3 8
                rows, inner 512, iters 65536 on 132 x 2048 columns, with
                its loop's SASS instructions a step; P4 4096 rounds,
                beside its serial floor (4096 rounds of K3's N = 1 latency
                over 24); P6 W = 256, TB = 256, 4096 and 32768, REPS 512,
                the tool's index and a random one, elements in the tool's
                batch-last arena and a lane-major one in both modes, and
                whole 256-bit words in the lane-major word arena (8 x
                32-bit and 2 x 128-bit loads) and the lane-last one K1
                reads, each beside its L1 floor (its warp loads' sectors)
                and its share of it, the split S at each TB, the loops'
                load opcodes and loads in flight (SASS), an empty launch
                beside the tool's shape, and the earlier design's latency
                floor (a warp's chain of dependent strong loads) and
                line_sum, which bound nothing; P7 B = 32768, 16 slots,
                every variant);
  fold-tools    the fold tools' entry points at their default shapes
                (era_zk_evm_tpu_torch/tools/: probe_rolling's profile, fold
                and rates, B = 32768, 128 cycles; probe_foldparts' none,
                half and noperm; probe_bsparts; probe_fold_split, main and
                pieces; probe_bsfold's perm and transpose): K2's time on
                each block beside its bound, both memory-witness modes'
                rates with K1's and K2's device time; their own checks
                (mode (a)'s valid slots equal to mode (b)'s records a lane,
                K2 on mode (a)'s queue compacted equal to mode (b)'s
                sponges, every K2 run equal to rolling_absorb_rows), K2 and
                P2 launched, every timed value finite and > 0, every line
                without a counterpart with its reason;
  K1-wave-segment  the witness wave's first 256-cycle segment, B = 4096,
                kernel vs plain over the whole batch;
  witness-wave  the log family's witness path at bench_block's tiny-mix
                geometry, B = 4096: every lane runs one tx to its end in
                256-cycle segments with compacted packed drains, then the
                per-lane digests, block folds, grand products (K3) and the
                block product; lanes 0..7 equal to a plain CPU run;
  wave-profile  the same wave under torch.profiler: the device's busy
                time and idle share, and its largest device ops;
  K1-precompile-small  K1's precompile instance (keccak256 / sha256 units,
                round-witness rows spliced at the block clock) against plain
                on the precompile test programs and the precompile mix,
                chunks of 8 cycles, every field; every lane against the
                native oracle as in K1-fuzz;
  K1-precompile bench_storage's geometry with the units on, B = 32768, the
                precompile mix: one 128-cycle call (K1 and the splice
                kernel) kernel vs plain over the whole batch, timed, with
                its bound; the keccak256 / sha256 units alone
                (fused_cycle.precompile_units, a call a thread) on every
                lane's call staged on its heap, timed, with their operation
                bound, the first 2048 lanes against plain;
  K1-ecrecover-small  K1's ecrecover instance (the secp256k1 unit in the
                cycle, two round-witness out rows) against plain on the
                ecrecover test programs and the signed-transfer mix, chunks
                of 8 cycles, every field; EC_ORACLE_LANES of them against
                the native oracle (its recovery is correctness-grade
                shift-add arithmetic, seconds a signature: the rejected
                edge cases and one signed transfer);
  K1-ecrecover  the same geometry with ecrecover on, B = 32768, every lane a
                signed transfer whose recovery falls in cycle 9: one
                128-cycle call kernel vs plain over the whole batch, then
                two more from the same entry state timed, with its bound
                (the unit's own field operations, ecrecover_counts) and the
                old algorithm's (a Shamir ladder, ladder_modmuls); the unit
                alone (ops.secp256k1.ecrecover_unit) on the same 32768
                signatures, timed, its first 2048 against plain;
  pq-splice     the round-witness splice kernel (csrc/pq_splice.cu)
                against its plain version on the card, every field it
                touches, on K1-precompile's and K1-ecrecover's scratch
                blocks at B = 32768 and on K1-ecrecover's again with the
                clock started near the capacity (overflow); times, the
                device time by kernel (torch.profiler), the bound of the
                bytes it must move (k1_times.splice_bytes: the kept lanes'
                data rows read, the surviving blocks' rows written) and its
                share, the flagged and overflowed cycles;
  block-tiny    execute_block at bench_block's tiny-mix shape and knobs
                (B = 4096, 8192 txs): a warm run, a timed run (txs/s,
                utilization, the scheduler's profile) and a run under
                torch.profiler (device idle share); the first 256 txs equal
                to a plain CPU run at B = 64;
  block-precompile  the same on the precompile mix with the units and the
                round-witness queue on;
  block-ecrecover  the same on the signed-transfer mix (ecrecover_mix) with
                ecrecover on; its first 64 txs (one wave) checked;
  block-realistic  execute_block on bench_block's realistic mix (B = 4096,
                chunk 128), txs/s, utilization, device idle and
                vs_engine_ideal against one long tx per lane;
                every block phase counts the sponge's launches and K3's;
  block-commit  each block phase's commitment phase alone
                (block.commit_block on its txs' results, equal to the
                block's): host wall, device busy time, K3's and the
                sponge's device time and launches;
  block-objects execute_block with streams="objects" (the reference's
                query structs) and streams="packed" on the same 8192 txs of
                the tiny mix, B = 4096 (so lanes refill): equal
                commitments, products, net states, cycles and registers,
                and each tx's structs equal to queries_from_packed of its
                packed streams; both walls, txs/s and the host split;
  sorted-queue  the witness wave's first 256-cycle segment, B = 4096: the
                sorted-queue functions (sort, K3 fingerprints, grand
                products, block product) on the card equal to the same
                functions on a CPU copy of the state, the first 256 lanes
                to the host references, and the sorted queue's products to
                the emission order's over every lane; CUDA-event ms a step;
  net-states-by-tx  the bootloader block (tests/test_bootloader.py) at
                B = 4096, 160 cycles on K1: every lane's per-tx buckets
                hold their markers, the first 64 lanes equal to a plain CPU
                run;
  segmented-block  the segmented executor (models/executor.py) on K1 at
                B = 4096: tests/test_executor.py's program with per-lane
                depth, rounds, keys and callee order on tight geometry
                (max_depth 31, 8 storage slots, 3 code pages, 4 heap
                frames, 14-cycle segments), so that every spill protocol
                fires, equal to a one-shot K1 run on big geometry on every
                lane (streams, registers, merged storage); the first 32
                lanes of the one-shot run against the plain engine on the
                card; counts of what moved, the host split by step, K1's
                device time and the device's idle share;
  checkpoint    the segmented state saved halfway, loaded onto the card
                and run to the end: equal to the uninterrupted run; save
                and load seconds and the file size;
  checkpoint-mesh  the same file loaded with mesh= (4 shards of the card)
                and run 217 cycles with run_block, equal to the file
                loaded unsharded and run with run_cycles;
  debug-trace   trace_cycles on 4 lanes of bench_farcall's program at
                B = 4096, 64 cycles, one K1 launch a cycle, equal to the
                plain step's trace on the CPU; cycles/s;
  dryrun-multichip  parallel.dryrun_multichip on 8 shards of the card, its
                lines equal to the JAX run's in MULTICHIP_r05.json (the
                aggregates and both block commitments); then measure(1) and
                measure(4) on shards of the card, printed as the throughput
                the shards of one card retain;
  differential  testing/differential.diff_run with the engine on the card
                against the port's golden oracle: the far-call programs
                with their contracts, the keccak256 precompile programs with
                and without the round-witness queue;
  batched-hashes  ops.keccak.keccak256_batched (a K3 launch a rate block)
                on 3072 messages against the golden keccak256, and
                ops.sha256.sha256_blocks on 4096 against hashlib;
  K3-sponge     the ragged keccak256 sponge against its plain version on
                the card, bit for bit: the edge lengths of a rate block and
                a mixed batch, a T = 1 fold of 8192 digests, block-
                realistic's memory-family streams cut to their first 2048
                blocks; times beside the bound and the serial floor (the
                longest stream's blocks at one permutation's single-thread
                latency), and the kernel's time on the whole streams; the
                log fingerprints through K3 and through the sponge, timed
                and equal;
  launches      K1 (each instance), K2, K3, the sponge and the splice
                launched on their main paths; block-tiny's sponge and K3 launches at most two
                a queue family and one; K3's on block-tiny and the sorted
                queue.
The card's name and power limit come on a line of their own, the kernels'
JSON record on the line before the last, and the last line is the device
record.  The script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from era_zk_evm_tpu_torch import _build, native
from era_zk_evm_tpu_torch.block import TxSpec, commit_block, execute_block
from era_zk_evm_tpu_torch.config import VmConfig, precompile_queue_slots
from era_zk_evm_tpu_torch.golden.precompiles import (
    keccak256 as golden_keccak256,
)
from era_zk_evm_tpu_torch.isa import params
from era_zk_evm_tpu_torch.isa.abi import code_hash_for_bytecode
from era_zk_evm_tpu_torch.models import (
    batched_vm, executor, fused_cycle, net_states,
)
from era_zk_evm_tpu_torch.models.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from era_zk_evm_tpu_torch.models.spill import extend_streams, rewind_queues
from era_zk_evm_tpu_torch.models.state import (
    FIELD_NAMES, LANE_AXIS, clone_state, make_entry_state, populate_code_bank,
    populate_storage, reference_view,
)
from era_zk_evm_tpu_torch.native.compare import compare_lanes
from era_zk_evm_tpu_torch.ops import keccak, secp256k1
from era_zk_evm_tpu_torch.ops.goldilocks import gl_reduce64
from era_zk_evm_tpu_torch.ops.sha256 import sha256_blocks
from era_zk_evm_tpu_torch.ops.u256 import wide
from era_zk_evm_tpu_torch.parallel import make_mesh, run_block, shard_state
from era_zk_evm_tpu_torch.parallel.dryrun import dryrun_multichip
from era_zk_evm_tpu_torch.parallel.fused import run_block_fused
from era_zk_evm_tpu_torch.parallel.mesh import block_aggregates
from era_zk_evm_tpu_torch.parallel.scaling import measure
from era_zk_evm_tpu_torch.testing import (
    block_programs, ec_programs, fuzz_programs, log_programs, splice_cases,
    spill_programs, units_off, witness_programs,
)
from era_zk_evm_tpu_torch.testing.debug_trace import trace_cycles
from era_zk_evm_tpu_torch.testing.differential import diff_run
from era_zk_evm_tpu_torch.testing.programs import (
    FAMILY_PROGRAMS, FARCALL_CALLEE_ADDRESS, STORAGE_WORKLOAD, WORKLOAD,
    assemble, farcall_callee, farcall_caller, tiny_mix_program,
)
from era_zk_evm_tpu_torch.testing.wave import run_wave, wave_commitments
from era_zk_evm_tpu_torch.tools.k1_times import splice_bytes
from era_zk_evm_tpu_torch.tools import (
    ablate_fused, bisect_fold, k1_times, probe_bsfold, probe_bsparts,
    probe_fold_split, probe_foldparts, probe_keccak, probe_rolling,
    probe_uniform,
)
from era_zk_evm_tpu_torch.witness import packed, sorted_queue
from era_zk_evm_tpu_torch.witness.commitment import (
    block_commitment, device_log_streams, device_rolling_commitments,
    serialize_decommittment, serialize_log_query, serialize_memory_query,
)
from era_zk_evm_tpu_torch.witness.rolling import (
    compact_slot_rows, finalize_rolling, rolling_absorb_rows,
)

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda:0"
B_FULL = 32768
K = 128            # cycles per call
CALLS = 8          # chained calls per pipelined sweep
SWEEPS = 2         # pipelined sweeps; the fastest is kept
PLAIN_CYCLES = 16  # cycles of the plain version timed at full size
FULL_ERGS = (1 << 31) - 1
B_FARCALL, FARCALL_CYCLES = 16384, 144
B_WAVE, WAVE_SEGMENT = 4096, 256
WAVE_FRACS = {"memory": 0.125, "log": 0.5}   # bench_block's drain budgets
#: K3 against plain at (states, iters); K3 timed at bench.py's keccak
#: shapes, and its plain version at the second (one plain call at the
#: first takes seconds)
K3_CHECKS = ((131072, 1), (65536, 4), (1, 3), (1000, 2))
K3_BENCH = (("bench_keccak", 65536, 2048),
            ("bench_keccak_u32pair", 131072, 128))
K3_PLAIN_BENCH = "bench_keccak_u32pair"
K3_REPS = 10                  # K3 launches a timing, back to back
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
INT32_LANES = 132 * 64                        # SMs x int32 lanes per SM
#: a lower count of the int32 operations of one lane-cycle of K1: fetching
#: and decoding an instruction and the 256-bit add and sub every cycle
#: computes take more than this
K1_MIN_OPS = 64
#: K1-ablate's hooked builds: a perfect stack / heap cache, and the cut
#: after stage 7 (far call, flags, dst), the last before the first store
ABLATE_SKIP, ABLATE_STAGE = frozenset({"stack_rw", "heap_rw"}), 7
#: int32 operations of one keccak-f[1600], counting 3-input logic ops as
#: one: per round theta 80 (column parities 20, their rotations 10, the
#: update folded into one 3-input XOR per word 50), rho 48, chi 50, iota 2
#: (24 rounds)
KECCAK_OPS = 24 * 180
#: int32 operations of one sha256 compression (csrc/sha256.cuh), counting a
#: rotate and a 3-input logic op as one: per round 17 (two Sigma at 4, ch
#: and maj at 1, 7 adds), per scheduled word 11, and the 8 final adds
SHA256_OPS = 64 * 17 + 48 * 11 + 8
#: int32 operations of one 256-bit modular multiplication in the ecrecover
#: unit's earlier design (a square-and-multiply ladder), a lower count: 64
#: limb products at 4 each (multiply low and high, two carry-adds), the fold
#: of the high half by 2**32 + 977 (16 products) and a final compare and
#: subtraction (16); it prices the old algorithm's bound, printed beside
#: the new one
LADDER_MODMUL_OPS = 64 * 4 + 16 * 4 + 16
#: int32 operations of the unit's arithmetic (csrc/secp256k1.cuh), lower
#: counts: the 512-bit product, a mad.lo and a madc.hi a limb product and
#: an addc a row; the square, 28 cross products at 2, their 7 rows' addc,
#: the doubling (16) and the 8 squares (16); the reduction mod p, a
#: multiply-add and two carried adds a limb (fold 1), 8 carries (fold 2),
#: the conditional subtraction's 8 adds and 8 selects; mod n, the three
#: folds' 8 x 5, 5 x 5 and 1 x 5 limb products at 2 each and the
#: subtraction's 16
MUL512_OPS = 64 * 2 + 8
SQR512_OPS = 28 * 2 + 7 + 16 + 16
RED_P_OPS = 8 * 4 + 8 + 16
RED_N_OPS = 2 * (8 * 5 + 5 * 5 + 5) + 16
#: the unit's point formulas: (multiplications, squares) mod p
DBL_MS, MADD_MS = (2, 5), (8, 3)
B_BLOCK, TAIL_MULT, CHECK_TXS, CHECK_BATCH = 4096, 4, 256, 64
EC_CHECK_TXS = 64                 # block-ecrecover's CPU check: one wave
UNIT_PLAIN = 2048                 # the unit alone: lanes held to plain
#: bench_block's knobs (bench.py:653-660) at its tiny-mix chunk
BLOCK_KNOBS = dict(chunk=64, k_inner=64, refill_frac=0.25, order="cost_desc",
                   tail_chunk_mult=TAIL_MULT, adaptive_chunk=True,
                   drain_compact_frac={"memory": 0.125, "log": 0.5})
#: bench_block's realistic mix runs 4 * 4096 txs; cut to half so that the
#: phase (a timed and a profiled run) stays near a minute on the card
REALISTIC_CHUNK, REALISTIC_TXS = 128, 2 * 4096
SECTOR = 32                                   # bytes of one DRAM sector
#: the ragged sponge's edge lengths in words (around a 34-word rate block),
#: the random lengths of its mixed batch, and the block fold's digests
SPONGE_EDGE, SPONGE_MIXED, FOLD_DIGESTS = (0, 1, 33, 34, 35, 67, 68), 64, 8192
#: K3 chained at N = 1: one permutation's latency on one thread
SERIAL_ITERS = 20000
#: the sponge's plain version takes one step a rate block of the longest
#: stream (block-realistic's memory family: 16954 blocks, 150-220 s on the
#: card); it checks each stream's first SPONGE_PLAIN_BLOCKS blocks, so that
#: the script stays under 800 s, and the kernel is also timed on the whole
#: streams
SPONGE_PLAIN_BLOCKS = 2048
#: block-objects: the tiny mix's txs; sorted-queue: lanes held against the
#: host references; net-states-by-tx: lanes held against a CPU run
OBJECTS_TXS, SQ_HOST_LANES, NET_CPU_LANES = 2 * 4096, 256, 64
#: K1-ecrecover-small's lanes held against the native oracle: the edge
#: cases it rejects before recovering (short of ergs, r or s zero or n, r
#: off the curve; the output window past the frame, lane 14, stops out of
#: bounds on both sides and is compared on its status alone) and the first
#: signed transfer of the mix, one recovery (seconds of host time)
EC_ORACLE_LANES = (3, 4, 5, 6, 7, 8, 14, 15)
#: bench.py's measure_native_baseline (bench.py:112-125)
BASELINE_RUN = dict(ergs=(1 << 31) - 1, max_cycles=350_000,
                    witness_cap=1 << 21, collect_witness=True)
#: segmented-block: the segment (max_depth 31: segment <= (31 - 3) // 2),
#: the one-shot run's cycles (more than the slowest lane needs), the lanes
#: held against the plain engine; debug-trace: lanes and cycles traced
SEG_LEN, SEG_BOUND, SEG_PLAIN_LANES = 14, 424, 32
TRACE_LANES, TRACE_CYCLES = (0, 1, B_BLOCK // 2, B_BLOCK - 1), 64
#: the probes' shapes: the JAX tools' defaults (tools/probe_keccak.py main,
#: probe_vpu_rate, probe_round_rate; tools/probe_mosaic_uniform.py;
#: tools/bisect_fold.py), and card-filling sizes where the tool's is a
#: block or two
P_BATCH, P_ITERS, P_TILE = 131072, 128, 2048
P_G8 = (128, 4096)
P3_ROWS, P3_INNER, P3_ITERS = 8, 512, 65536
P3_COLS = 132 * 2048           # columns: 2048 threads on each of 132 SMs
P3_ROW_ITERS = 64              # the kernels line's P3 shape: plain runs it
P4_ITERS, P4_TILE, P4_COLS = 4096, 1024, 132 * 512
P6_W, P6_TBS, P6_REPS = 256, (256, 4096, 32768), 512
#: int32 operations of one bit-sliced keccak round of 32 states (a u32
#: column), 3-input logic ops counted as one: the parities 640 (two 3-input
#: XORs each), theta 1600 (a 3-input XOR a plane), chi 1600 (a LOP3 a
#: plane); iota and the renamings rho and pi left out
BITSLICE_ROUND_OPS = 640 + 1600 + 1600
#: int32 operations of one P3 row-step on the card: rotl1 is one funnel
#: shift, a ^ (~b & c) one LOP3
P3_CARD_OPS = {"xor": 1, "mix": 2, "andnot": 1}
#: each probe's launch count: (module, counter)
PROBE_COUNTS = {"P1": (probe_keccak, "P1_LAUNCHES"),
                "P2": (probe_keccak, "P2_LAUNCHES"),
                "P3": (probe_keccak, "P3_LAUNCHES"),
                "P4": (probe_keccak, "P4_LAUNCHES"),
                "P5": (probe_keccak, "P5_LAUNCHES"),
                "P6": (probe_uniform, "P6_LAUNCHES"),
                "P7": (bisect_fold, "P7_LAUNCHES")}


def bench_config(batch: int, rolling: bool) -> VmConfig:
    """bench.py's geometry: mode (a) queues one call, mode (b) commits."""
    return VmConfig(batch=batch, code_words=16, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=64, aux_heap_words=16, max_depth=8,
                    queue_capacity=0 if rolling else K * 8,
                    rolling_commitment=rolling)


def small_config(batch: int, rolling: bool) -> VmConfig:
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=64, aux_heap_words=16, max_depth=8,
                    queue_capacity=0 if rolling else 48 * 8 * 2,
                    rolling_commitment=rolling)


def log_config(batch: int) -> VmConfig:
    """tests/test_fused_cycle.py::_log_config(batch, 128)."""
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=64, aux_heap_words=16, max_depth=8,
                    queue_capacity=K * 8 * 2, storage_slots=8,
                    journal_slots=16, event_slots=16,
                    log_queue_capacity=K * 2, heap_frames=4, code_pages=4,
                    decommit_queue_capacity=K * 2)


def storage_config(batch: int) -> VmConfig:
    """bench.py bench_storage's geometry (bench.py:263-268)."""
    return VmConfig(batch=batch, code_words=16, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=16, aux_heap_words=16, max_depth=8,
                    queue_capacity=0, storage_slots=8, journal_slots=64,
                    event_slots=64, log_queue_capacity=0)


def farcall_config(batch: int, n_calls: int = 12) -> VmConfig:
    """bench.py bench_farcall's geometry (bench.py:343-348)."""
    return VmConfig(batch=batch, code_words=16, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=16, aux_heap_words=8, max_depth=8,
                    queue_capacity=0, storage_slots=4, journal_slots=8,
                    event_slots=8, heap_frames=n_calls + 2, code_pages=2)


def with_units(cfg: VmConfig, blocks: int, ecrecover: bool = False):
    """`cfg` with the keccak256 / sha256 units (2 keccak blocks, 2 sha256
    rounds), ecrecover if asked, and a round-witness queue of `blocks`
    blocks of PS rows (PS from precompile_queue_slots: 11, or 12 with
    ecrecover)."""
    cfg = dataclasses.replace(cfg, precompile_keccak_blocks=2,
                              precompile_sha_rounds=2,
                              precompile_ecrecover=ecrecover)
    return dataclasses.replace(cfg, precompile_queue_capacity=blocks * sum(
        precompile_queue_slots(cfg)))


def block_config(batch: int, chunk: int = 64, precompile: bool = False,
                 ecrecover: bool = False) -> VmConfig:
    """bench.py bench_block's geometry (bench.py:574-579: queues sized to
    chunk * tail_mult cycles); with `precompile`, the units and a
    round-witness queue of as many blocks."""
    cfg = VmConfig(batch=batch, code_words=16, stack_words=256,
                   sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                   heap_words=32, aux_heap_words=16, max_depth=8,
                   queue_capacity=chunk * 8 * TAIL_MULT, storage_slots=8,
                   journal_slots=64, event_slots=64,
                   log_queue_capacity=chunk * TAIL_MULT)
    if precompile:
        cfg = with_units(cfg, chunk * TAIL_MULT, ecrecover)
    return cfg


def wave_config(batch: int) -> VmConfig:
    """bench.py bench_block's tiny-mix geometry (chunk 64, tail_mult 4)."""
    return block_config(batch)


def precompile_storage_config(batch: int, ecrecover: bool = False):
    """bench_storage's geometry with the units on (and ecrecover, if asked)
    and a round-witness queue of K blocks."""
    return with_units(storage_config(batch), K, ecrecover)


def precompile_small_config(batch: int) -> VmConfig:
    """tests/test_torch_precompile.py::precompile_config (chunk 32)."""
    return with_units(VmConfig(
        batch=batch, code_words=32, stack_words=256, sweep_gating=False,
        stack_abs_words=64, stack_sp_base=960, heap_words=32,
        aux_heap_words=16, max_depth=8, queue_capacity=4 * 32 * 8,
        storage_slots=8, journal_slots=64, event_slots=16,
        log_queue_capacity=4 * 32, heap_frames=2, code_pages=2,
        decommit_queue_capacity=4 * 32), 32)


def ecrecover_small_config(batch: int) -> VmConfig:
    """tests/test_torch_ecrecover.py::ec_config (chunk 32) at `batch`."""
    return VmConfig(batch=batch, code_words=64, stack_words=2048,
                    heap_words=64, max_depth=8, queue_capacity=96 * 8,
                    storage_slots=16, journal_slots=32, event_slots=32,
                    log_queue_capacity=96, heap_frames=2, code_pages=2,
                    decommit_queue_capacity=96, precompile_keccak_blocks=3,
                    precompile_sha_rounds=3, precompile_ecrecover=True,
                    precompile_queue_capacity=32 * 16)


def state_tensors(state) -> dict:
    """The state's tensors by field name, to be compared where they lie."""
    return {name: getattr(state, name) for name in FIELD_NAMES}


def compare(a: dict, b: dict) -> tuple[list[str], int]:
    """Fields that differ, and the largest absolute difference (u32 values);
    tensors of one device, compared there."""
    bad, err = [], 0
    for name in a:
        x, y = a[name], b[name]
        if x.shape != y.shape:
            bad.append(name)
            continue
        d = 0 if torch.equal(x, y) else int(
            ((x.to(torch.int64) & 0xFFFFFFFF)
             - (y.to(torch.int64) & 0xFFFFFFFF)).abs().max())
        if d:
            bad.append(name)
            err = max(err, d)
    return bad, err


def require_equal(what: str, a: dict, b: dict) -> int:
    bad, err = compare(a, b)
    if bad:
        raise AssertionError(f"{what}: kernel != plain in {bad} "
                             f"(max abs err {err})")
    return err


def lanes(arrays: dict, n: int) -> dict:
    """The first n lanes of every stored field (on its lane axis,
    state.LANE_AXIS)."""
    return {k: (v[..., :n] if LANE_AXIS[k] == -1 else v[:n])
            for k, v in arrays.items()}


def timed_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


_T0 = time.time()


def phase(tag: str, **fields) -> None:
    """One phase's line, with the script's elapsed seconds."""
    fields["t_s"] = round(time.time() - _T0, 1)
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo, with its vendor,
    family, model and stepping (a virtualised host may name it "unknown")
    and the processor count."""
    fields, n = {}, 0
    for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = (x.strip() for x in line.partition(":"))
        n += key == "processor"
        fields.setdefault(key, value)
    return (f"{fields.get('model name', '?')} ({fields.get('vendor_id', '?')}"
            f" family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} stepping "
            f"{fields.get('stepping', '?')}, {n} processors)")


def oracle_lanes(words: list, entries: list, config: VmConfig,
                 max_cycles: int, lanes) -> tuple[list, float]:
    """The native oracle on the programs of `lanes` (ergs 1 << 20, the
    config's heap), and its seconds."""
    t0 = time.perf_counter()
    out = [native.run_oracle(words[i], entry_address=entries[i],
                             ergs=1 << 20, max_cycles=max_cycles,
                             heap_words=config.heap_words)
           for i in lanes]
    return out, time.perf_counter() - t0


def require_oracle_equal(what: str, state, results: list, lanes) -> int:
    """K1's `lanes` against the oracle's results; the number of lanes
    compared in full (the rest erred on both sides: status alone)."""
    diffs, full = compare_lanes(state, results, lanes)
    if diffs:
        raise AssertionError(f"{what}: K1 != native oracle in {len(diffs)} "
                             f"observables: {diffs[:8]}")
    return full


def pow_modmuls(e: int) -> int:
    """Multiplications of x ** e by square-and-multiply from x."""
    return e.bit_length() - 1 + e.bit_count() - 1


def ladder_modmuls(digest: int, r: int, s: int) -> int:
    """Modular multiplications that one recovery of a valid signature needs
    in the unit's earlier design (a Shamir ladder, square-and-multiply
    powers), at its least: r^3
    (2), the square root's power, its check (1), the power for 1 / r, u1
    and u2 (2), G + R (16), the ladder over u1 and u2 from their top bit (a
    doubling at 7 per further bit, an addition at 16 per further bit set in
    either scalar), the power for 1 / Z and the affine conversion (4).
    Additions and subtractions are not counted."""
    n, p = secp256k1.N_INT, secp256k1.P_INT
    r_inv = pow(r, -1, n)
    u1, u2 = -digest * r_inv % n, s * r_inv % n
    ladder = 7 * (max(u1, u2).bit_length() - 1) \
        + 16 * ((u1 | u2).bit_count() - 1)
    return (2 + pow_modmuls((p + 1) // 4) + 1 + pow_modmuls(n - 2) + 2 + 16
            + ladder + pow_modmuls(p - 2) + 4)


def ladder_ops(signatures) -> int:
    """int32 operations of the recoveries of `signatures` ((digest, v, r,
    s) each) in the old algorithm: its multiplications and the keccak-f of
    each public key (the earlier design's bound, printed beside the new
    one)."""
    muls = {}
    total = 0
    for digest, _, r, s in signatures:
        key = (digest, r, s)
        if key not in muls:
            muls[key] = ladder_modmuls(digest, r, s)
        total += muls[key] * LADDER_MODMUL_OPS + KECCAK_OPS
    return total


def chain_counts(e: int) -> tuple[int, int]:
    """(squares, multiplications) of the unit's addition chain for x ** e
    (`_build.pow_chain`)."""
    builds, runs, tail = _build.pow_chain(e)
    return (sum(b for _, _, b in builds) + sum(z + r for z, r in runs[1:])
            + tail, len(builds) + len(runs) - 1)


def ecrecover_counts(digest: int, v: int, r: int, s: int) -> dict:
    """The field operations one recovery takes in the unit
    (csrc/secp256k1.cuh), by its fixed schedule: multiplications and
    squares mod p and mod n, bare 512-bit products (the endomorphism
    split), and keccak-f; a rejected signature stops where the unit does."""
    n, p = secp256k1.N_INT, secp256k1.P_INT
    c = {"mp": 0, "sp": 0, "mn": 0, "sn": 0, "prod": 0, "keccak": 0}

    def point(ms, k=1):
        c["mp"] += ms[0] * k
        c["sp"] += ms[1] * k

    if not (0 < r < n and 0 < s < n and v <= 1):
        return c
    sq, mu = chain_counts((p + 1) // 4)
    c["mp"] += 1 + mu                     # r^2 r, the root's chain
    c["sp"] += 2 + sq                     # r^2, the chain, the root's check
    y_sq = (r ** 3 + 7) % p
    if pow(y_sq, (p - 1) // 2, p) != 1 and y_sq:
        return c
    sq, mu = chain_counts(n - 2)
    c["sn"] += sq
    c["mn"] += mu + 2                     # 1 / r, u1, u2
    c["prod"] += 8                        # two splits: 2 rounding, 2 low
    # R's table: 2R, d.Z^2, d.Z^3 and R on the curve by d.Z, 7 mixed
    # additions, the rescaling of 7 entries (a z^2, 3 multiplications, and
    # 6 z-ratio products), the table's Z
    point(DBL_MS)
    c["sp"] += 1 + 7
    c["mp"] += 3 + 7 * 3 + 6 + 1
    point(MADD_MS, 7)
    c["sp"] += 1                          # zt^2
    c["mp"] += 1                          # zt^3
    dr, dg = _build.secp_digits(_build.SECP_WINDOW_R),         _build.secp_digits(_build.SECP_WINDOW_G)
    top = max(_build.SECP_WINDOW_R * (dr - 1), _build.SECP_WINDOW_G * (dg - 1))
    point(DBL_MS, top)
    # R, lambda R: 2 additions a digit (the very first a copy), lambda's
    # beta x; G, lambda G: 2 a digit, each entry scaled by zt^2 and zt^3
    point(MADD_MS, 2 * dr - 1)
    c["mp"] += dr + 2 * 2 * dg
    point(MADD_MS, 2 * dg)
    # the even halves' corrections, made in every lane: 4 additions, G's
    # and lambda G's points scaled (4), two beta x
    point(MADD_MS, 4)
    c["mp"] += 4 + 2
    sq, mu = chain_counts(p - 2)
    c["sp"] += sq + 1                     # 1 / Z's chain, zinv^2
    c["mp"] += mu + 1 + 1 + 2             # Z zt, zinv^3, x and y
    c["keccak"] = 1
    return c


def ecrecover_ops(signatures) -> int:
    """int32 operations of the unit's recoveries of `signatures` ((digest,
    v, r, s) each), by `ecrecover_counts`."""
    seen, total = {}, 0
    for sig in signatures:
        if sig not in seen:
            c = ecrecover_counts(*sig)
            seen[sig] = (c["mp"] * (MUL512_OPS + RED_P_OPS)
                         + c["sp"] * (SQR512_OPS + RED_P_OPS)
                         + c["mn"] * (MUL512_OPS + RED_N_OPS)
                         + c["sn"] * (SQR512_OPS + RED_N_OPS)
                         + c["prod"] * MUL512_OPS + c["keccak"] * KECCAK_OPS)
        total += seen[sig]
    return total


def splice_check(config: VmConfig, entry, pq_block: tuple, sm_mhz: float,
                 overflow: bool = False) -> dict:
    """pq-splice: the splice kernel against its plain version on the card,
    on a chunk's scratch block as K1 wrote it, into `entry`'s queue (with
    `overflow`, its clock started so that the later half of the flagged
    cycles, at least one, pass the capacity): every field the splice
    touches equal.  The kernel's best of 3 launches (each on a fresh copy
    of the state), its device time by kernel (`torch.profiler`, a launch's
    mean over 3 more; {} where the profiler saw no kernel), the plain
    version's time, the bound of the bytes it must move
    (`k1_times.splice_bytes`: the data rows its lanes keep read, the range
    its blocks cover written), and the flagged and overflowed cycles."""
    ps = pq_block[0].shape[1]
    flagged = (pq_block[3][:K] != 0).any(1)
    start = (config.precompile_queue_capacity // ps
             - int(flagged.sum()) // 2) if overflow else 0

    def fresh():
        st = clone_state(entry)
        if overflow:
            st.pq_blocks.fill_(start)
        return st

    fields = splice_cases.SPLICE_FIELDS
    kst, pst = fresh(), fresh()
    fused_cycle.splice_rows(kst, config, pq_block, K)
    plain_ms = timed_ms(lambda: fused_cycle.splice_precompile_rows(
        pst, config, pq_block, K))
    err = require_equal(f"pq-splice overflow={overflow}",
                        {f: getattr(kst, f) for f in fields},
                        {f: getattr(pst, f) for f in fields})
    times = []
    for _ in range(3):
        st = fresh()
        times.append(timed_ms(lambda: fused_cycle.splice_rows(
            st, config, pq_block, K)))
        del st
    # the device time by kernel, a launch's mean over 3 launches (the
    # profiler can miss a window's first device events: up to 3 windows,
    # until it has seen both kernels)
    for _ in range(3):
        states = [fresh() for _ in range(3)]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for st in states:
                fused_cycle.splice_rows(st, config, pq_block, K)
            torch.cuda.synchronize()
        del states
        kernels = {e.key.split("(")[0]: round(
            e.self_device_time_total / 1e3 / e.count, 4)
            for e in prof.key_averages() if e.key.startswith("pq_")}
        if len(kernels) == 2:
            break
    ovf = int(((start + torch.cumsum(flagged.long(), 0) - flagged.long())
               * ps > config.precompile_queue_capacity - ps)[flagged].sum())
    if overflow and not (ovf and bool(kst.lane_error.any())):
        raise AssertionError("pq-splice: the overflow case did not overflow")
    n_bytes = splice_bytes(pq_block[3][:K].cpu(), pq_block[4][:K].cpu(), ps,
                           config.precompile_queue_capacity, start)
    bound = bound_ms(n_bytes, 0, sm_mhz)
    return {"ms": min(times), "ms_all": ";".join(f"{t:.4f}" for t in times),
            "device_ms": json.dumps(kernels),
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "bound_share": bound[0] / min(times),
            "bytes": n_bytes, "flagged": int(flagged.sum()),
            "overflowed": ovf, "err": err}


def unit_check(signatures: list, dev) -> dict:
    """The ecrecover unit alone (a signature a thread) on the K1-ecrecover
    lanes' signatures: its best of 3 times and recoveries/s, and its first
    UNIT_PLAIN lanes against the plain recovery on the card."""
    digest, r, s = (torch.tensor(
        [secp256k1.to_limbs(c[i]) for c in signatures], dtype=torch.int64)
        .to(torch.int32).to(dev) for i in (0, 2, 3))
    v = torch.tensor([c[1] for c in signatures], dtype=torch.int32).to(dev)
    ok, addr = secp256k1.ecrecover_unit(digest, v, r, s)
    m = UNIT_PLAIN
    want_ok, want_addr = secp256k1.ecrecover_batched(digest[:m], v[:m],
                                                     r[:m], s[:m])
    if not (torch.equal(ok[:m], want_ok) and torch.equal(addr[:m],
                                                          want_addr)):
        raise AssertionError("the ecrecover unit alone != plain")
    times = [timed_ms(lambda: secp256k1.ecrecover_unit(digest, v, r, s))
             for _ in range(3)]
    return {"unit_ms": round(min(times), 4),
            "unit_recoveries_per_sec": len(signatures) / (min(times) / 1e3),
            "unit_ok": int(ok.sum()), "unit_plain_lanes": m}


def units_check(config: VmConfig, state, mix: list, sm_mhz: float) -> dict:
    """The keccak256 / sha256 units alone (a call a thread), staged as K1's
    unit reads them: every lane's call of the precompile mix (keccak256 of
    64 bytes at byte 0, or sha256 of its 1 or 2 rounds at word 0) on its
    heap after the K1-precompile call.  Their main path, the entry point
    `precompile_units` with its count zeroed just before; the kernel's
    device time (torch.profiler, 3 launches) and the call's CUDA-event
    times, against the operation bound of its keccak-f and compressions and
    the plain version's time; its first UNIT_PLAIN lanes against the plain
    version on the card."""
    rounds = torch.tensor([r for *_, r in mix], dtype=torch.int32)
    sha = (rounds > 0).to(torch.int32)
    zero = torch.zeros_like(rounds)
    call = torch.stack([sha, zero, zero, 64 * (1 - sha), rounds],
                       dim=1).to(state.heap.device)
    arena = state.heap                     # [F * HW, 8, B], frame 0 first
    fused_cycle.PRECOMPILE_UNIT_LAUNCHES = 0
    out, err = fused_cycle.precompile_units(config, arena, call)
    torch.cuda.synchronize()
    launches = fused_cycle.PRECOMPILE_UNIT_LAUNCHES
    if launches != 1 or bool(err.any()):
        raise AssertionError(f"units alone: {launches} launches, "
                             f"{int(err.sum())} errors")
    m = UNIT_PLAIN
    want, want_err = fused_cycle.precompile_units_plain(
        config, arena[..., :m].contiguous(), call[:m])
    max_err = int((out[:m] - want).abs().max())
    if max_err or not torch.equal(err[:m], want_err):
        raise AssertionError("the keccak256 / sha256 units alone != plain")
    times = [timed_ms(lambda: fused_cycle.precompile_units(config, arena,
                                                           call))
             for _ in range(3)]
    # the kernel's own time: a call's CUDA-event time holds the host's
    # launch work, longer than the kernel
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused_cycle.precompile_units(config, arena, call)
        torch.cuda.synchronize()
    kernel = [e for e in prof.key_averages() if "units_kernel" in e.key]
    if not kernel:
        raise AssertionError("torch.profiler recorded no units_kernel")
    device_ms = sum(e.self_device_time_total for e in kernel) / 1e3 \
        / sum(e.count for e in kernel)
    plain_ms = timed_ms(lambda: fused_cycle.precompile_units_plain(
        config, arena, call))
    perms = int((rounds == 0).sum())
    comps = int(rounds.sum())
    bound = bound_ms(0, perms * KECCAK_OPS + comps * SHA256_OPS, sm_mhz)
    return {"launches": launches, "err": max_err, "ms": device_ms,
            "ms_events": ";".join(f"{t:.4f}" for t in times),
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "keccak_f": perms,
            "sha256_compressions": comps, "plain_lanes": m}


def bound_ms(n_bytes: float, n_ops: float, sm_mhz: float) -> tuple:
    """(least time in ms, what sets it): bytes over the HBM rate against
    int32 operations over the card's int32 issue rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (INT32_LANES * sm_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: K1 arguments it only reads
_K1_READ_ONLY = {"code", "cb_valid", "cb_hash", "default_aa_hash"}
#: K1 outputs whose old contents it never reads: the witness queue rows
_K1_WRITE_ONLY = {"lq_meta", "lq_addr", "lq_key", "lq_read", "lq_written",
                  "dq_hash", "dq_meta", "wq_meta", "wq_value", "wq_flags",
                  "pq_meta", "pq_value", "pq_flags"}


def changed_bytes(a: torch.Tensor, b: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors in which two tensors of one shape
    differ."""
    x, y = (t.contiguous().reshape(-1).view(torch.uint8) for t in (a, b))
    pad = -x.numel() % SECTOR
    if pad:
        zeros = x.new_zeros(pad)
        x, y = torch.cat([x, zeros]), torch.cat([y, zeros])
    return int((x.view(-1, SECTOR) != y.view(-1, SECTOR)).any(1).sum()) \
        * SECTOR


def k1_bytes(before, after, config: VmConfig) -> int:
    """A lower count of the bytes one K1 call must move to turn `before`
    into `after`: each input it only reads, once; of the state it writes,
    each 32-byte sector the call changed, read once and written once (a
    witness queue row only written).  State it reads and leaves as it was
    is not counted, so every kernel moves at least this much.  The sectors
    are those of the reference layout (`state.reference_view`), whatever
    layout the state is stored in, so that one piece of work has one floor
    for every layout of the kernel."""
    before, after = reference_view(before), reference_view(after)
    fields = [field for _, field, _ in fused_cycle._k1_fields(config)]
    if config.queue_capacity:
        fields += ["wq_meta", "wq_value", "wq_flags"]
    if config.precompile_queue_capacity:
        fields += ["pq_meta", "pq_value", "pq_flags", "pq_count", "pq_blocks"]
    total = 0
    for field in fields:
        a, b = getattr(before, field), getattr(after, field)
        if field in _K1_READ_ONLY:
            total += a.nbytes
        else:
            total += changed_bytes(a, b) * (1 if field in _K1_WRITE_ONLY
                                            else 2)
    return total


def staged_log_run(run: str, dev):
    """The entry state of one of the LOG / far-call runs, on `dev`."""
    config = log_config(log_programs.LANES)
    words, entries, banks = log_programs.stage(run)
    st = make_entry_state(config, words, ergs=1 << 20, device=dev)
    populate_storage(st, config, entries)
    populate_code_bank(st, config, banks)
    return config, st


def farcall_entry(batch: int, dev, queues: bool = False):
    """bench_farcall's entry state (bench.py:360-365) on `dev`; with
    `queues`, the log and decommit witness queues on, one row per cycle."""
    config = farcall_config(batch)
    if queues:
        config = dataclasses.replace(
            config, log_queue_capacity=FARCALL_CYCLES,
            decommit_queue_capacity=FARCALL_CYCLES)
    callee = assemble(farcall_callee())
    h = code_hash_for_bytecode(callee)
    st = make_entry_state(config, [assemble(farcall_caller())] * batch,
                          ergs=FULL_ERGS, device=dev)
    entry = (0, params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS,
             FARCALL_CALLEE_ADDRESS, h)
    populate_storage(st, config, [[entry]] * batch)
    populate_code_bank(st, config, [[(h, callee)]] * batch)
    return config, st


def wave_programs(batch: int) -> list:
    """bench_block's tiny mix: one tx per lane, iteration counts from
    RandomState(11) (bench.py:628-633)."""
    lengths = np.random.RandomState(11).choice(
        [4, 8, 16, 32], size=batch, p=[0.5, 0.25, 0.15, 0.1])
    cache = {}
    return [cache.setdefault(int(n), assemble(tiny_mix_program(int(n))))
            for n in lengths]


def as_txs(rows) -> list:
    """TxSpecs of (entry address, program source, iteration count) rows,
    each tx's iteration count as its cost hint."""
    cache = {}
    return [TxSpec(program=cache.setdefault(src, assemble(src)),
                   ergs=FULL_ERGS, entry_address=entry, cost_hint=n)
            for entry, src, n, *_ in rows]


def mix_txs(mix: str, n_txs: int) -> list:
    """The block's transactions: bench_block's tiny or realistic mix
    (bench.py:628-650) or the precompile mix, iteration counts from
    RandomState(11)."""
    if mix == "tiny":
        rows = [(0x8001, tiny_mix_program(int(n)), int(n))
                for n in block_programs.tiny_mix_lengths(n_txs)]
    elif mix == "realistic":
        rows = [(0x8001, block_programs.realistic_program(int(n)), int(n))
                for n in block_programs.realistic_lengths(n_txs)]
    else:
        rows = block_programs.precompile_mix(n_txs)
    return as_txs(rows)


def profiled(fn) -> dict:
    """fn() under torch.profiler: the wall time, the device's busy time
    (device-side events: kernels, copies, fills) and idle share, and its
    largest device items.  Only the device is traced: host ops are not
    needed here, and tracing them slowed a long block's run and its
    post-processing by minutes."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in ops) / 1e6
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(ops, key=lambda kv: -kv[1])[:5]

    def kernel_ms(name):
        return round(sum(t for k, t, _ in ops if name in k) / 1e3, 3)

    return {"profiled_wall_s": round(wall, 4),
            "device_busy_s": round(busy, 4),
            "idle_share": round(1 - busy / wall, 4),
            "k1_device_ms": kernel_ms("k1_kernel"),
            "k3_device_ms": kernel_ms("k3_kernel"),
            "sponge_device_ms": kernel_ms("k3s_kernel"),
            "sponge_events": sum(c for k, _, c in ops if "k3s_kernel" in k),
            "splice_device_ms": kernel_ms("pq_"),
            "top": ";".join(f"{k[:40]}:{t / 1e3:.2f}ms" for k, t, _ in top)}


def block_phase(tag: str, config: VmConfig, txs: list, knobs: dict, dev,
                warm: bool = True) -> tuple:
    """execute_block on the card: a warm run (if asked), a timed run with
    the launch counts set to 0 just before it, and a profiled run.  Returns
    (result, wall seconds, launches, profile)."""
    if warm:
        execute_block(config, txs, device=dev, **knobs)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    blk = execute_block(config, txs, device=dev, **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": fused_cycle.K1_LAUNCHES,
                "K1_precompile": fused_cycle.K1_PRECOMPILE_LAUNCHES,
                "K1_ecrecover": fused_cycle.K1_ECRECOVER_LAUNCHES,
                "splice": fused_cycle.PQ_SPLICE_LAUNCHES,
                "K3": keccak.K3_LAUNCHES, "sponge": keccak.K3S_LAUNCHES}
    if not blk.all_ok:
        bad = sum(t.status != "ok" for t in blk.txs)
        raise AssertionError(f"{tag}: {bad} txs ended in error")
    prof = profiled(lambda: execute_block(config, txs, device=dev, **knobs))
    return blk, wall, launches, prof


def check_on_cpu(tag: str, config: VmConfig, txs: list, knobs: dict,
                 blk, n_txs: int = CHECK_TXS) -> None:
    """The first n_txs txs through the port on the CPU (plain versions) at
    B = CHECK_BATCH: every tx's status, cycles, registers, family digests
    and sorted-log product equal to the card's block.  The policy knobs do
    not change a tx's results; the CPU run takes the ones that waste the
    fewest lane-cycles (no tail escalation or adaptive chunks, refill at an
    eighth of the lanes)."""
    cpu_knobs = dict(knobs, tail_chunk_mult=1, adaptive_chunk=False,
                     refill_frac=0.125)
    ref = execute_block(dataclasses.replace(config, batch=CHECK_BATCH),
                        txs[:n_txs], device="cpu", **cpu_knobs)
    for i, (a, b) in enumerate(zip(ref.txs, blk.txs)):
        if (a.status, a.cycles) != (b.status, b.cycles) \
                or not np.array_equal(a.registers, b.registers) \
                or ref.tx_commitments[i] != blk.tx_commitments[i] \
                or ref.sorted_log_products[i] != blk.sorted_log_products[i]:
            raise AssertionError(f"{tag}: tx {i} differs from the CPU run")


def block_fields(blk, wall: float, n_txs: int) -> dict:
    return {"txs": n_txs, "txs_per_sec": n_txs / wall,
            "wall_s": round(wall, 4),
            "utilization": round(blk.stats["utilization"], 4),
            "mean_tx_cycles": round(float(np.mean(
                [r.cycles for r in blk.txs])), 1),
            "rounds": blk.stats["rounds"],
            "adaptive_launches": blk.stats["adaptive_launches"],
            "all_ok": blk.all_ok,
            "families": ",".join(sorted(blk.commitments)),
            **{f"host_{k}": v for k, v in blk.stats["profile"].items()}}


def commit_phase(config: VmConfig, blk, dev) -> dict:
    """execute_block's commitment phase alone (`block.commit_block`) on a
    block's tx results, equal to the block's: its host wall (synchronised,
    best of 3), the launches of one run, and a run under torch.profiler."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        keccak.K3_LAUNCHES = keccak.K3S_LAUNCHES = 0
        t0 = time.perf_counter()
        got = commit_block(config, blk.txs, dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if got != (blk.tx_commitments, blk.commitments, blk.sorted_log_products):
        raise AssertionError("the commitment phase alone differs from the "
                             "block's")
    launches = {"sponge": keccak.K3S_LAUNCHES, "K3": keccak.K3_LAUNCHES}
    prof = profiled(lambda: commit_block(config, blk.txs, dev))
    return {"wall_s": round(min(walls), 4),
            **{f"launches_{k}": v for k, v in launches.items()},
            # the profiler can miss the phase's first device events: then
            # its device time is read from the whole block's profile
            "profile_complete": prof["sponge_events"] == launches["sponge"],
            **{k: prof[k] for k in ("device_busy_s", "k3_device_ms",
                                    "sponge_device_ms", "sponge_events",
                                    "top")}}


def card_fields(t_phase: float) -> dict:
    """A phase line's wall since `t_phase` (perf_counter) and the card's
    name and power limit, as nvidia-smi gives them."""
    return {"wall_s": round(time.perf_counter() - t_phase, 2),
            "card": json.dumps(nvidia_smi("name,power.limit"))}


def reset_counts() -> None:
    """Every kernel's launch count to 0 (before a path is driven)."""
    fused_cycle.K1_LAUNCHES = fused_cycle.K1_PRECOMPILE_LAUNCHES = 0
    fused_cycle.K1_ECRECOVER_LAUNCHES = keccak.K3_LAUNCHES = 0
    keccak.K3S_LAUNCHES = fused_cycle.PQ_SPLICE_LAUNCHES = 0
    secp256k1.EC_UNIT_LAUNCHES = fused_cycle.PRECOMPILE_UNIT_LAUNCHES = 0


def objects_phase(dev) -> dict:
    """block-objects: execute_block in both stream forms on the tiny mix's
    OBJECTS_TXS txs at B = 4096 (bench_block's knobs), objects first with
    the launch counts set to 0 just before it; every result equal, each
    tx's query structs equal to queries_from_packed of its packed streams;
    both walls and both runs' host split.  Returns the objects run's
    launches."""
    t_phase = time.perf_counter()
    config = block_config(B_BLOCK)
    txs = mix_txs("tiny", OBJECTS_TXS)
    walls, runs = {}, {}
    for form in ("objects", "packed"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        runs[form] = execute_block(config, txs, device=dev, streams=form,
                                   **BLOCK_KNOBS)
        torch.cuda.synchronize()
        walls[form] = time.perf_counter() - t0
        if form == "objects":
            launches = {"K1": fused_cycle.K1_LAUNCHES,
                        "K3": keccak.K3_LAUNCHES,
                        "sponge": keccak.K3S_LAUNCHES}
        if not runs[form].all_ok:
            raise AssertionError(f"block-objects: {form} txs in error")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"block-objects: launches {launches}")
    obj, pk = runs["objects"], runs["packed"]
    for name in ("tx_commitments", "commitments", "sorted_log_products",
                 "block_log_product"):
        if getattr(obj, name) != getattr(pk, name):
            raise AssertionError(f"block-objects: {name} differ")
    t0 = time.perf_counter()
    n_records = 0
    for a, b in zip(obj.txs, pk.txs):
        if (a.status, a.cycles, a.net_states) \
                != (b.status, b.cycles, b.net_states) \
                or not np.array_equal(a.registers, b.registers) \
                or sorted(a.streams) != sorted(b.streams):
            raise AssertionError(f"block-objects: tx {a.tx} differs")
        for name, stream in a.streams.items():
            if packed.queries_from_packed(name, b.streams[name]) != stream:
                raise AssertionError(f"block-objects: tx {a.tx} {name} "
                                     "structs != its packed records")
            n_records += len(stream)
    phase("block-objects", **card_fields(t_phase), batch=B_BLOCK,
          txs=len(txs), equal=True,
          records=n_records, objects_wall_s=round(walls["objects"], 4),
          objects_txs_per_sec=len(txs) / walls["objects"],
          packed_wall_s=round(walls["packed"], 4),
          packed_txs_per_sec=len(txs) / walls["packed"],
          check_s=round(time.perf_counter() - t0, 2),
          **{f"launches_{k}": v for k, v in launches.items()},
          **{f"objects_host_{k}": v
             for k, v in obj.stats["profile"].items()},
          **{f"packed_host_{k}": v for k, v in pk.stats["profile"].items()})
    return launches


def _sq_path(state) -> tuple:
    """The sorted-queue functions on one state: (fingerprints lo, hi,
    valid, lane products lo, hi, block product lo, hi, the five sorted
    arrays)."""
    (lo, hi), valid = sorted_queue.log_queue_fingerprints(state)
    lanes = sorted_queue.grand_product(lo, hi, valid)
    return (lo, hi, valid, *lanes, *sorted_queue.block_grand_product(*lanes),
            *sorted_queue.sort_log_queue(state))


def _gl_ints(lo: torch.Tensor, hi: torch.Tensor) -> list[int]:
    return [a | (b << 32) for a, b in zip(lo.tolist(), hi.tolist())]


def sorted_queue_phase(dev, wave_words: list) -> int:
    """sorted-queue: the witness wave's first segment at B = 4096, then the
    sorted-queue path on the card with the launch counts set to 0 just
    before it, equal to the same functions on a CPU copy of the state; the
    first SQ_HOST_LANES lanes against the host references, the permutation
    identity over every lane; CUDA-event ms a step.  Returns K3's
    launches on the path."""
    t_phase = time.perf_counter()
    config = wave_config(B_WAVE)
    st = make_entry_state(config, wave_words, ergs=FULL_ERGS, device=dev)
    fused_cycle.run_cycles(st, config, WAVE_SEGMENT, k_inner=WAVE_SEGMENT)
    torch.cuda.synchronize()
    reset_counts()
    got = _sq_path(st)
    torch.cuda.synchronize()
    k3 = keccak.K3_LAUNCHES
    if k3 != 1:
        raise AssertionError(f"sorted-queue: {k3} K3 launches, not 1")
    host = dataclasses.replace(st, **{n: getattr(st, n).cpu()
                                      for n in FIELD_NAMES})
    t0 = time.perf_counter()
    want = _sq_path(host)
    cpu_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"sorted-queue: output {i} card != CPU")
    lo, hi, valid, plo, phi = (t.cpu() for t in got[:5])
    products = _gl_ints(plo, phi)
    # the sorted copy, written back through the reference view: its
    # products (the permutation identity) and its streams (the host sort)
    sorted_st = clone_state(st)
    ref = reference_view(sorted_st)
    for name, arr in zip(("lq_meta", "lq_addr", "lq_key", "lq_read",
                          "lq_written"), got[7:]):
        getattr(ref, name).copy_(arr)
    (slo, shi), svalid = sorted_queue.log_queue_fingerprints(sorted_st)
    if _gl_ints(*(t.cpu() for t in sorted_queue.grand_product(
            slo, shi, svalid))) != products:
        raise AssertionError("sorted-queue: sorted product != emission "
                             "order's")
    t0 = time.perf_counter()
    n = SQ_HOST_LANES
    streams = device_log_streams(st)[:n]
    sorted_streams = device_log_streams(sorted_st)[:n]
    for b in range(n):
        fps = [x | (y << 32) for x, y, v in zip(
            lo[b].tolist(), hi[b].tolist(), valid[b].tolist()) if v]
        if fps != [sorted_queue.host_fingerprint(q) for q in streams[b]] \
                or products[b] != sorted_queue.host_grand_product(
                    streams[b]) \
                or sorted_streams[b] != sorted(
                    streams[b], key=sorted_queue.host_sort_key):
            raise AssertionError(f"sorted-queue: lane {b} != the host "
                                 "references")
    host_s = time.perf_counter() - t0
    fp_dev, gp_dev = got[:3], got[3:5]
    steps = {"sort": lambda: sorted_queue.sort_log_queue(st),
             "fingerprints": lambda: sorted_queue.log_queue_fingerprints(st),
             "grand_product": lambda: sorted_queue.grand_product(*fp_dev),
             "block_product": lambda: sorted_queue.block_grand_product(
                 *gp_dev)}
    ms = {}
    for name, fn in steps.items():
        fn()
        ms[name] = min(timed_ms(fn) for _ in range(3))
    phase("sorted-queue", **card_fields(t_phase), batch=B_WAVE,
          rows_per_lane=config.log_queue_capacity,
          records=int(valid.sum()), equal_to_cpu=True,
          equal_to_host_lanes=n, permutation_identity=True, k3_launches=k3,
          **{f"{k}_ms": round(v, 4) for k, v in ms.items()},
          cpu_copy_s=round(cpu_s, 2), host_refs_s=round(host_s, 2),
          block_product=_gl_ints(got[5].cpu()[None], got[6].cpu()[None])[0])
    return k3


def net_states_phase(dev) -> int:
    """net-states-by-tx: the bootloader block at B = 4096 on K1 (launch
    counts set to 0 just before it), its per-tx net states and final net
    states; every lane's buckets hold the expected markers, the first
    NET_CPU_LANES lanes equal to a plain CPU run.  Returns K1's
    launches."""
    t_phase = time.perf_counter()
    wp = witness_programs
    config = wp.bootloader_config(B_WAVE)
    st = wp.bootloader_state(config, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fused_cycle.run_cycles(st, config, wp.MAX_CYCLES)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k1 = fused_cycle.K1_LAUNCHES
    if k1 == 0 or not bool(st.done.all()) or bool(st.lane_error.any()):
        raise AssertionError(f"net-states-by-tx: K1 launches {k1}, "
                             f"{int(st.done.sum())} lanes done")
    t0 = time.perf_counter()
    logs = device_log_streams(st)
    by_tx = net_states.net_states_by_tx(st, config, logs)
    nets = net_states.device_net_states(st, config, logs)
    extract_s = time.perf_counter() - t0
    for b, per_tx in enumerate(by_tx):
        ok = sorted(per_tx) == list(range(len(wp.TX_SEQUENCE)))
        for tx_i, contract_i in enumerate(wp.TX_SEQUENCE):
            bucket = per_tx.get(tx_i, {"events": [], "storage_writes": []})
            ev = bucket["events"]
            writes = [q for q in bucket["storage_writes"]
                      if q.address == wp.TX_ADDRS[contract_i]]
            ok = ok and len(ev) == 1 and ev[0].value \
                == wp.TX_MARKS[contract_i] and ev[0].address \
                == wp.TX_ADDRS[contract_i] and len(writes) == 1 \
                and writes[0].written_value == wp.TX_MARKS[contract_i]
        if not ok:
            raise AssertionError(f"net-states-by-tx: lane {b}'s buckets")
    n = NET_CPU_LANES
    cpu_config = wp.bootloader_config(n)
    cpu = wp.bootloader_state(cpu_config, "cpu")
    fused_cycle.run_cycles(cpu, cpu_config, wp.MAX_CYCLES)
    cpu_logs = device_log_streams(cpu)
    if by_tx[:n] != net_states.net_states_by_tx(cpu, cpu_config, cpu_logs) \
            or nets[:n] != net_states.device_net_states(cpu, cpu_config,
                                                        cpu_logs):
        raise AssertionError("net-states-by-tx: lanes differ from the CPU")
    phase("net-states-by-tx", **card_fields(t_phase), batch=B_WAVE,
          cycles=wp.MAX_CYCLES,
          txs_per_lane=len(wp.TX_SEQUENCE), equal_to_cpu_lanes=n,
          k1_launches=k1, run_s=round(run_s, 4),
          extract_s=round(extract_s, 3),
          log_records=sum(len(s) for s in logs))
    return k1


#: the segmented block's stream families and their struct serializers
SERIALIZERS = {"memory": serialize_memory_query, "log": serialize_log_query,
               "decommit": serialize_decommittment}


def segment_config(batch: int, big: bool = False) -> VmConfig:
    """The segmented block's geometry (bench_farcall's stack): tight, with
    max_depth 31, 8 storage slots, 3 code pages and 4 heap frames, a memory
    queue of 8 rows a cycle and log and decommit queues at
    tests/test_executor.py's 16 rows for 6 cycles; or big enough that
    nothing spills in SEG_BOUND cycles."""
    kw = dict(batch=batch, code_words=64, stack_words=256, sweep_gating=False,
              stack_abs_words=64, stack_sp_base=960, heap_words=16,
              aux_heap_words=8, journal_slots=64, event_slots=64)
    if big:
        return VmConfig(max_depth=56, queue_capacity=SEG_BOUND * 8,
                        storage_slots=40, log_queue_capacity=SEG_BOUND,
                        heap_frames=18, code_pages=6,
                        decommit_queue_capacity=SEG_BOUND, **kw)
    rows = -(-SEG_LEN * 16 // 6)
    return VmConfig(max_depth=31, queue_capacity=SEG_LEN * 8,
                    storage_slots=8, log_queue_capacity=rows, heap_frames=4,
                    code_pages=3, decommit_queue_capacity=rows, **kw)


def segment_programs(batch: int) -> list:
    """Lane b runs tests/test_executor.py's caller with key_base
    1000 (b + 1), recursion depth 32 + b % 17 and 8 + b % 7 rounds over the
    4 callees rotated by b % 4."""
    callees = spill_programs.callees(4)
    return [spill_programs.caller(callees[b % 4:] + callees[:b % 4],
                                  1000 * (b + 1), 32 + b % 17, 8 + b % 7)
            for b in range(batch)]


def _frame_counts(spilled) -> np.ndarray:
    return np.array([len(f) for f in spilled.frames])


def _map_sizes(host) -> np.ndarray:
    return np.array([len(m) for m in host.maps])


#: the executor's steps, as `models/executor.py` names them: (name, step,
#: a probe of what the call moves, the counters of its rise and fall)
EXECUTOR_STEPS = (
    ("normalize_callstack", "normalize", lambda a: _frame_counts(a[2]),
     "frames_spilled", "frames_restored"),
    ("_touched_in_log_queue", "detect", None, None, None),
    ("drain_witness_queues", "drain", None, None, None),
    ("compact_log_state_host", "compact", None, None, None),
    ("spill_storage_kv", "kv_spill", lambda a: _map_sizes(a[2]),
     "keys_spilled", None),
    ("rehydrate_keys", "kv_spill", lambda a: _map_sizes(a[2]), None,
     "keys_rehydrated"),
    ("spill_code_bank", "code_spill", lambda a: _map_sizes(a[2]),
     "contracts_spilled", None),
    ("rehydrate_code", "code_spill", lambda a: _map_sizes(a[2]), None,
     "contracts_rehydrated"),
    ("reclaim_heap_frames", "reclaim",
     lambda a: int(a[0].frame_count.sum()), None, "heap_frames_reclaimed"),
    ("clone_state", "clone", None, None, None),
)


@contextlib.contextmanager
def executor_split(seconds: dict, counts: dict):
    """Time each step of run_block_segments (between two synchronisations)
    into `seconds` by EXECUTOR_STEPS's step, count its calls and what it
    moves into `counts`; the module's names are restored on exit."""
    saved = {name: getattr(executor, name) for name, *_ in EXECUTOR_STEPS}

    def wrap(name, step, probe, rise, fall):
        fn = saved[name]

        def run(*args, **kw):
            before = probe(args) if probe else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[step] = seconds.get(step, 0.0) + time.perf_counter() - t0
            counts[name] = counts.get(name, 0) + 1
            if probe:
                d = np.asarray(probe(args)) - before
                for key, moved in ((rise, d.clip(min=0)),
                                   (fall, (-d).clip(min=0))):
                    if key:
                        counts[key] = counts.get(key, 0) + int(moved.sum())
            return out
        return run

    for entry in EXECUTOR_STEPS:
        setattr(executor, entry[0], wrap(*entry))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(executor, name, fn)


def k1_timed(events: list):
    """fused_cycle.run_cycles, each call between two CUDA events."""
    def run(state, config, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_cycle.run_cycles(state, config, n)
        end.record()
        events.append((start, end))
        return state
    return run


def merged_storage(state, host_maps) -> list[dict]:
    """Each lane's storage map: the host overflow map, then the device KV
    table's used entries (key and value limb tuples)."""
    ref = reference_view(state)
    keys = ref.st_key.cpu().numpy().view(np.uint32)
    vals = ref.st_val.cpu().numpy().view(np.uint32)
    used = ref.st_used.cpu().numpy()
    out = []
    for b in range(used.shape[0]):
        m = {k: tuple(int(x) for x in v) for k, v in host_maps[b].items()}
        for i in np.nonzero(used[b])[0]:
            m[tuple(keys[b, i].tolist())] = tuple(vals[b, i].tolist())
        out.append(m)
    return out


def copy_hosts(hosts):
    """A copy of a segmented run's host stores that the run can go on
    changing: the protocols add, pop and replace entries and frames, and
    never change one in place, so copying the lists and maps suffices."""
    return executor.BlockHosts(
        storage=type(hosts.storage)([dict(m) for m in hosts.storage.maps]),
        code=type(hosts.code)([dict(m) for m in hosts.code.maps]),
        frames=type(hosts.frames)([list(f) for f in hosts.frames.frames]))


def host_stores(hosts) -> tuple:
    """A segmented run's host stores as plain values, to compare two
    runs."""
    def plain(v):
        return v.tolist() if isinstance(v, np.ndarray) else v
    return ([[{k: plain(v) for k, v in f.items()} for f in lane]
             for lane in hosts.frames.frames],
            [{k: plain(v) for k, v in m.items()} for m in hosts.storage.maps],
            [{k: {f: plain(x) for f, x in e.items()} for k, e in m.items()}
             for m in hosts.code.maps])


def segmented_phase(dev) -> tuple:
    """segmented-block: run_block_segments on K1 at B_BLOCK lanes, every
    spill protocol firing, in two calls split at a segment boundary (the
    second from the first's state and hosts, as a resumed block runs),
    against a one-shot K1 run on big geometry: the concatenated memory,
    log and decommit streams, the final registers and the merged storage
    maps of every lane; the first SEG_PLAIN_LANES lanes of the one-shot
    run against the plain engine on the card.  The segmented run's host
    split, K1's CUDA-event time, the device's idle share (torch.profiler,
    device activity only).  Returns (K1's launches in the segmented run,
    the plain check's max abs err, what the checkpoint phase resumes
    from)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    programs = segment_programs(B_BLOCK)
    callees = spill_programs.callees(4)
    assemble_s = time.perf_counter() - t0
    # the one-shot reference, on geometry where nothing spills
    big_cfg = segment_config(B_BLOCK, big=True)
    big = spill_programs.stage(big_cfg, programs, callees, callees, dev)
    t0 = time.perf_counter()
    fused_cycle.run_cycles(big, big_cfg, SEG_BOUND)
    torch.cuda.synchronize()
    oneshot_s = time.perf_counter() - t0
    n_cycles = int(big.monotonic_cycle_counter.max())
    if not bool(big.done.all()) or bool(big.lane_error.any()) \
            or n_cycles >= SEG_BOUND:
        raise AssertionError(f"segmented-block: the one-shot run ends at "
                             f"{n_cycles} cycles, {int(big.done.sum())} "
                             "lanes done")
    n = SEG_PLAIN_LANES
    t0 = time.perf_counter()
    plain_cfg = dataclasses.replace(big_cfg, batch=n)
    plain = spill_programs.stage(plain_cfg, programs[:n], callees, callees,
                                 dev)
    batched_vm.run_cycles(plain, plain_cfg, SEG_BOUND)
    plain_err = require_equal("segmented-block one-shot B=32",
                              lanes(state_tensors(big), n),
                              state_tensors(plain))
    del plain
    plain_s = time.perf_counter() - t0
    # the one-shot streams as each lane's record bytes, which are the
    # bytes of its query structs serialized (a struct costs ~8x to build)
    t0 = time.perf_counter()
    want_regs = big.regs.clone()
    want = {}
    for fam, (words, valid) in packed.serialize_all(big, SERIALIZERS).items():
        rows = words[valid].cpu().numpy().view(np.uint32)
        counts = valid.sum(1).cpu().numpy()
        want[fam] = [r.tobytes()
                     for r in np.split(rows, np.cumsum(counts)[:-1])]
    want_storage = merged_storage(big, [{}] * B_BLOCK)
    del big
    oneshot_read_s = time.perf_counter() - t0

    # the segmented run on tight geometry, 2 callees staged in the bank
    # and 2 in the host code map from t = 0
    config = segment_config(B_BLOCK)
    st = spill_programs.stage(config, programs, callees, callees[:2], dev)
    hosts = spill_programs.cold_code_hosts(config, callees[2:])
    first = SEG_LEN * (n_cycles // SEG_LEN // 2)
    seconds, counts, events, got, second = {}, {}, [], {}, {}
    run = k1_timed(events)
    prof, resume = [], {}

    def segments(part: int, acc: dict) -> None:
        nonlocal st, hosts
        st, hosts, streams = executor.run_block_segments(
            st, config, run, part, SEG_LEN, hosts=hosts)
        extend_streams(acc, streams, B_BLOCK)

    torch.cuda.synchronize()
    reset_counts()
    with executor_split(seconds, counts):
        prof.append(profiled(lambda: segments(first, got)))
        resume.update(state=clone_state(st), hosts=copy_hosts(hosts),
                      cycles=n_cycles - first)
        prof.append(profiled(lambda: segments(n_cycles - first, second)))
    k1 = fused_cycle.K1_LAUNCHES
    k1_ms = sum(a.elapsed_time(b) for a, b in events)
    extend_streams(got, second, B_BLOCK)
    resume.update(config=config, final=st, final_hosts=hosts,
                  streams=second)

    t0 = time.perf_counter()
    if not bool(st.done.all()) or bool(st.lane_error.any()):
        raise AssertionError("segmented-block: lanes not done or in error")
    if not torch.equal(st.regs, want_regs):
        raise AssertionError("segmented-block: registers != one-shot")
    for fam, ser in SERIALIZERS.items():
        bad = [b for b in range(B_BLOCK)
               if b"".join(map(ser, got[fam][b])) != want[fam][b]]
        if bad:
            raise AssertionError(f"segmented-block: {fam} streams of "
                                 f"{len(bad)} lanes != one-shot ({bad[:4]})")
    if merged_storage(st, hosts.storage.maps) != want_storage:
        raise AssertionError("segmented-block: storage maps != one-shot")
    moved = ("frames_spilled", "frames_restored", "keys_spilled",
             "keys_rehydrated", "contracts_spilled", "contracts_rehydrated",
             "heap_frames_reclaimed")
    if k1 == 0 or any(counts.get(k, 0) == 0 for k in moved):
        raise AssertionError(f"segmented-block: K1 {k1}, {counts}")
    check_s = time.perf_counter() - t0
    wall = sum(p["profiled_wall_s"] for p in prof)
    busy = sum(p["device_busy_s"] for p in prof)
    segments_run = counts["normalize_callstack"] - 2
    phase("segmented-block", **card_fields(t_phase), batch=B_BLOCK,
          cycles=n_cycles, segment=SEG_LEN, segments=segments_run,
          replays=counts["clone_state"] - segments_run,
          storage_replays=counts.get("rehydrate_keys", 0),
          code_replays=counts.get("rehydrate_code", 0),
          **{k: counts[k] for k in moved}, k1_launches=k1,
          run_wall_s=round(wall, 3), k1_device_ms=round(k1_ms, 3),
          device_busy_s=round(busy, 4), idle_share=round(1 - busy / wall, 4),
          **{f"host_{k}_s": round(v, 3) for k, v in sorted(seconds.items())},
          records=sum(len(s) for fam in got.values() for s in fam),
          equal_lanes=B_BLOCK, plain_lanes=n, oneshot_k1_s=round(oneshot_s, 3),
          assemble_s=round(assemble_s, 2), plain_s=round(plain_s, 2),
          oneshot_read_s=round(oneshot_read_s, 2),
          check_s=round(check_s, 2))
    return k1, plain_err, resume


def checkpoint_phase(dev, resume: dict) -> None:
    """checkpoint: the segmented state saved halfway (save_checkpoint),
    loaded back onto the card (load_checkpoint's default device) and run
    to the end with the halfway host stores: every field of the final
    state, the host stores and the second half's streams equal to the
    uninterrupted run's.  The host stores are host objects; they are not
    part of the checkpoint format."""
    t_phase = time.perf_counter()
    config = resume["config"]
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "ckpt"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, resume["state"], config)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.perf_counter()
        st, loaded_cfg = load_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _resume_phase(t_phase, resume, st, loaded_cfg, save_s, load_s, size)
        checkpoint_mesh_phase(dev, path, config, resume["cycles"])


def _resume_phase(t_phase, resume, st, loaded_cfg, save_s, load_s,
                  size) -> None:
    """The checkpoint phase's resume from the loaded state, and its line."""
    config = resume["config"]
    if loaded_cfg != config or st.done.device.type != "cuda":
        raise AssertionError("checkpoint: config or device differs")
    reset_counts()
    t0 = time.perf_counter()
    st, hosts, streams = executor.run_block_segments(
        st, config, fused_cycle.run_cycles, resume["cycles"], SEG_LEN,
        hosts=resume["hosts"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    k1 = fused_cycle.K1_LAUNCHES
    err = require_equal("checkpoint: resumed != uninterrupted",
                        state_tensors(st), state_tensors(resume["final"]))
    if host_stores(hosts) != host_stores(resume["final_hosts"]) \
            or streams != resume["streams"] or k1 == 0:
        raise AssertionError("checkpoint: host stores or streams differ")
    phase("checkpoint", **card_fields(t_phase), batch=config.batch,
          resumed_cycles=resume["cycles"], save_s=round(save_s, 3),
          load_s=round(load_s, 3), file_bytes=size,
          resume_s=round(resume_s, 3), k1_launches=k1, max_abs_err=err,
          equal=True)


def trace_phase(dev) -> int:
    """debug-trace: trace_cycles over TRACE_LANES of bench_farcall's
    program at B_BLOCK lanes, one K1 launch (k = 1) a cycle, equal to the
    same lanes' trace through the plain step on the CPU.  Returns K1's
    launches."""
    t_phase = time.perf_counter()
    config, st = farcall_entry(B_BLOCK, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    st, traces = trace_cycles(st, config, TRACE_CYCLES,
                              lanes=list(TRACE_LANES), with_registers=True)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    k1 = fused_cycle.K1_LAUNCHES
    t0 = time.perf_counter()
    cpu_cfg, cpu = farcall_entry(len(TRACE_LANES), "cpu")
    _, want = trace_cycles(cpu, cpu_cfg, TRACE_CYCLES,
                           lanes=list(range(len(TRACE_LANES))),
                           with_registers=True)
    cpu_s = time.perf_counter() - t0
    far_calls = sum("far_call" in s.asm for s in traces[0])
    if k1 != TRACE_CYCLES or traces != want or not far_calls:
        raise AssertionError(f"debug-trace: K1 launches {k1}, far calls "
                             f"{far_calls}, equal {traces == want}")
    phase("debug-trace", **card_fields(t_phase), batch=B_BLOCK,
          lanes=",".join(map(str, TRACE_LANES)), cycles=TRACE_CYCLES,
          k1_launches=k1, trace_s=round(trace_s, 3),
          cycles_per_sec=round(TRACE_CYCLES / trace_s, 1),
          cpu_trace_s=round(cpu_s, 2), far_calls=far_calls,
          equal_to_cpu=True)
    return k1


MESH_SHARDS = 4                          # shards of one card in the mesh phase
UNITS_OFF_BATCH = 96                     # configs X and Y: 32 x the 3 lanes
DRYRUN_DEVICES = 8
HASH_MESSAGES = 1024                     # a message length in batched-hashes
HASH_LENGTHS = (0, 136, 200)             # keccak256: 1, 2 and 2 rate blocks
SHA_MESSAGES, SHA_LENGTH = 4096, 100     # sha256: 2 blocks a message


def units_off_phase(dev) -> None:
    """units-off: configs X and Y (testing/units_off.py: the precompile
    units, ecrecover or a precompile queue asked for without what they
    need, which run with the units off) through K1 on the card, every
    field equal to the plain engine on the CPU, with the lane_error
    pattern the units give."""
    t_phase = time.perf_counter()
    reps = UNITS_OFF_BATCH // len(units_off.PROGRAMS)
    words = [assemble(s) for s in units_off.PROGRAMS] * reps
    entry = units_off.ENTRY * reps
    launches = {}
    for name, config in units_off.configs(UNITS_OFF_BATCH).items():
        ks, ps = (make_entry_state(config, words, ergs=units_off.ERGS,
                                   entry_address=entry, device=d)
                  for d in (dev, "cpu"))
        reset_counts()
        fused_cycle.run_cycles(ks, config, units_off.N_CYCLES)
        torch.cuda.synchronize()
        launches[name] = fused_cycle.K1_LAUNCHES
        fused_cycle.run_cycles(ps, config, units_off.N_CYCLES)
        require_equal(f"units-off config {name}",
                      {k: v.cpu() for k, v in state_tensors(ks).items()},
                      state_tensors(ps))
        if ks.lane_error.tolist() != units_off.LANE_ERRORS[name] * reps \
                or launches[name] == 0:
            raise AssertionError(f"units-off {name}: lane_error or launches")
    phase("units-off", **card_fields(t_phase), batch=UNITS_OFF_BATCH,
          cycles=units_off.N_CYCLES, configs="X,Y", equal_to_plain=True,
          k1_launches_x=launches["X"], k1_launches_y=launches["Y"])


def mesh_phase(dev, results: dict, entries: dict) -> dict:
    """mesh: parallel.run_block on MESH_SHARDS shards of the card (8192
    lanes a shard), main-a's and main-b's calls again (the same count of
    K-cycle calls, a queue rewind between them): every gathered field
    equal to the unsharded main-path state, the aggregates equal to the
    unsharded state's, the rolling block commitment equal to the host fold
    of the unsharded lanes' digests; then run_block_fused on fresh shards,
    in 64-cycle launches, to the same state.  The walls are of one
    K-cycle call, synchronised, on one shard of B_FULL lanes and on the
    MESH_SHARDS shards: shards of one card share it, so this is no
    scaling figure.  Returns the launches of the sharded run_block calls."""
    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    fields, launches = {}, {"K1": 0, "K2": 0, "sponge": 0}
    for mode, cfg in (("a", bench_config(B_FULL, rolling=False)),
                      ("b", bench_config(B_FULL, rolling=True))):
        want, n_calls = results[mode][0], results[mode][1]
        one = clone_state(entries[mode])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_block(one, cfg, K, k_inner=K)
        torch.cuda.synchronize()
        wall_1 = time.perf_counter() - t0
        del one
        for fused in (False, True):
            sharded = shard_state(entries[mode], mesh)
            reset_counts()
            fused_cycle.K2_LAUNCHES = 0
            walls = []
            for call in range(n_calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if fused:
                    sharded, agg = run_block_fused(sharded, cfg, K, mesh)
                else:
                    sharded, agg = run_block(sharded, cfg, K, k_inner=K)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                for shard in sharded.shards:
                    rewind_queues(shard)
            if not fused:
                got = {"K1": fused_cycle.K1_LAUNCHES,
                       "K2": fused_cycle.K2_LAUNCHES,
                       "sponge": keccak.K3S_LAUNCHES}
                if got["K1"] == 0 or mode == "b" and (
                        got["K2"] == 0 or got["sponge"] == 0):
                    raise AssertionError(f"mesh {mode}: launches {got}")
                launches = {k: launches[k] + v for k, v in got.items()}
            how = "run_block_fused" if fused else "run_block"
            require_equal(f"mesh mode {mode} {how}: gathered != unsharded",
                          state_tensors(sharded.gather(dev)),
                          state_tensors(want))
            # the queues were rewound after the last call, on both sides
            after = block_aggregates(sharded, cfg)
            whole = block_aggregates(want, cfg)
            # the last call's own aggregates: all but its witness queries
            # outlive the rewind
            bad = [k for k in whole if not torch.equal(after[k], whole[k])
                   or k != "witness_queries"
                   and not torch.equal(agg[k], whole[k])]
            if bad:
                raise AssertionError(f"mesh {mode} {how}: aggregates {bad}")
            if mode == "a" and int(agg["witness_queries"]) == 0:
                raise AssertionError("mesh a: no witness queries")
        if mode == "b":
            got = agg["memory_block_commitment"].cpu().numpy().view(np.uint8)
            if got.tobytes() != block_commitment(
                    device_rolling_commitments(want)):
                raise AssertionError("mesh b: block commitment != host fold")
            fields["commitment"] = got.tobytes().hex()[:16]
        fields[f"{mode}_calls"] = n_calls
        fields[f"{mode}_wall_1_shard_ms"] = round(wall_1 * 1e3, 3)
        fields[f"{mode}_wall_{MESH_SHARDS}_shards_ms"] = round(
            float(np.median(walls)) * 1e3, 3)
        fields[f"{mode}_root_ergs"] = float(agg["root_ergs"])
        fields[f"{mode}_cycles_retired"] = float(agg["cycles_retired"])
    phase("mesh", **card_fields(t_phase), batch=B_FULL, shards=MESH_SHARDS,
          lanes_a_shard=B_FULL // MESH_SHARDS, cycles_per_call=K,
          equal_to_unsharded=True, walls="shards of one card share it: "
          "not a scaling figure", **fields,
          **{f"launches_{k}": v for k, v in launches.items()})
    return launches


def dryrun_phase(dev) -> None:
    """dryrun-multichip: parallel.dryrun_multichip on DRYRUN_DEVICES shards
    of the card; its aggregates and both block commitments equal to the
    JAX run recorded in MULTICHIP_r05.json (read from the file), then
    measure(1) and measure(4) on shards of the card, as the throughput
    the shards of one card retain."""
    t_phase = time.perf_counter()
    record = json.loads((ROOT / "MULTICHIP_r05.json").read_text())
    want = [ln for ln in record["tail"].splitlines()
            if not ln.startswith("dryrun_multichip scaling")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(DRYRUN_DEVICES, devices=[dev] * DRYRUN_DEVICES,
                         scaling=False)
    got = out.getvalue().splitlines()
    if got != want:
        raise AssertionError(f"dryrun-multichip: {got} != {want}")
    rates = {1: measure(1), MESH_SHARDS: measure(MESH_SHARDS,
                                                 devices=[dev] * MESH_SHARDS)}
    phase("dryrun-multichip", **card_fields(t_phase),
          devices=DRYRUN_DEVICES, equal_to_record="MULTICHIP_r05.json",
          commitment=got[1].rsplit("=", 1)[1][:16],
          rate_1_shard=round(rates[1], 1),
          **{f"rate_{MESH_SHARDS}_shards": round(rates[MESH_SHARDS], 1)},
          shared_card_retention=round(rates[MESH_SHARDS] / rates[1], 4))


def checkpoint_mesh_phase(dev, path: pathlib.Path, config,
                          n_cycles: int) -> None:
    """checkpoint-mesh: the checkpoint phase's file loaded with mesh=
    (MESH_SHARDS shards of the card) and run n_cycles with run_block,
    equal to the same file loaded unsharded and run with run_cycles, every
    field and the aggregates."""
    t_phase = time.perf_counter()
    one, _ = load_checkpoint(path)
    t0 = time.perf_counter()
    sharded, loaded_cfg = load_checkpoint(
        path, mesh=make_mesh(devices=[dev] * MESH_SHARDS))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if loaded_cfg != config or len(sharded.shards) != MESH_SHARDS:
        raise AssertionError("checkpoint-mesh: config or shards differ")
    reset_counts()
    sharded, agg = run_block(sharded, config, n_cycles)
    torch.cuda.synchronize()
    k1 = fused_cycle.K1_LAUNCHES
    fused_cycle.run_cycles(one, config, n_cycles)
    err = require_equal("checkpoint-mesh: sharded != unsharded resume",
                        state_tensors(sharded.gather(dev)),
                        state_tensors(one))
    whole = block_aggregates(one, config)
    if k1 == 0 or any(not torch.equal(agg[k], whole[k]) for k in whole):
        raise AssertionError("checkpoint-mesh: launches or aggregates")
    phase("checkpoint-mesh", **card_fields(t_phase), batch=config.batch,
          shards=MESH_SHARDS, cycles=n_cycles, load_s=round(load_s, 3),
          k1_launches=k1, max_abs_err=err, equal=True)


def differential_phase(dev) -> int:
    """differential: testing/differential.diff_run with the engine on the
    card (K1's kLog and kPrecomp instances) against the port's golden
    oracle, on the far-call programs with their contracts and the
    keccak256 precompile programs (with and without the round-witness
    queue).  Returns K1's launches."""
    t_phase = time.perf_counter()
    keccak_addr = params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS

    def pp_config(batch, cycles, **kw):
        # tests/test_batched_precompiles.py::_config
        return VmConfig(
            batch=batch, queue_capacity=cycles * 8, heap_words=64,
            stack_words=2048, code_words=64, max_depth=8, storage_slots=16,
            journal_slots=32, event_slots=32, log_queue_capacity=cycles,
            heap_frames=2, code_pages=2, decommit_queue_capacity=cycles,
            precompile_keccak_blocks=3, precompile_sha_rounds=3, **kw)

    runs = {
        "far_calls": (log_programs.FAR_PROGRAMS,
                      dict(contracts=log_programs.CONTRACTS, max_cycles=128)),
        "precompile": (block_programs.KECCAK_PROGRAMS, dict(
            config=pp_config(len(block_programs.KECCAK_PROGRAMS), 128),
            max_cycles=128, entry_address=keccak_addr)),
        "round_witness": (block_programs.ROUND_WITNESS_PROGRAMS, dict(
            config=pp_config(len(block_programs.ROUND_WITNESS_PROGRAMS), 96,
                             precompile_queue_capacity=15 * 4),
            max_cycles=96, entry_address=keccak_addr)),
    }
    reset_counts()
    lanes = 0
    for programs_, kw in runs.values():
        diff_run(programs_, device=dev, **kw)
        lanes += len(programs_)
    k1 = fused_cycle.K1_LAUNCHES
    if k1 == 0 or fused_cycle.K1_PRECOMPILE_LAUNCHES == 0:
        raise AssertionError("differential: K1 did not run on the card")
    phase("differential", **card_fields(t_phase), sets=",".join(runs),
          lanes=lanes, k1_launches=k1,
          k1_precompile_launches=fused_cycle.K1_PRECOMPILE_LAUNCHES,
          equal_to_golden=True)
    return k1


def batched_hashes_phase(dev) -> int:
    """batched-hashes: ops.keccak.keccak256_batched (one K3 launch a rate
    block) over HASH_MESSAGES messages of each HASH_LENGTHS length, against
    the golden keccak256, and ops.sha256.sha256_blocks over SHA_MESSAGES
    messages, against hashlib, on the card.  Returns K3's launches."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    reset_counts()
    n_blocks = 0
    for length in HASH_LENGTHS:
        msgs = [rng.bytes(length) for _ in range(HASH_MESSAGES)]
        blocks = keccak.pad_messages(msgs)
        n_blocks += blocks.shape[1]
        got = keccak.digest_from_state(keccak.keccak256_batched(
            torch.from_numpy(blocks.view(np.int32)).to(dev)))
        if got != [golden_keccak256(m) for m in msgs]:
            raise AssertionError(f"batched-hashes: keccak256 at {length} B")
    k3 = keccak.K3_LAUNCHES
    if k3 != n_blocks:
        raise AssertionError(f"batched-hashes: {k3} K3 launches, "
                             f"{n_blocks} blocks")
    msgs = [rng.bytes(SHA_LENGTH) for _ in range(SHA_MESSAGES)]
    padded = [m + b"\x80" + bytes((55 - len(m)) % 64)
              + (8 * len(m)).to_bytes(8, "big") for m in msgs]
    words = np.frombuffer(b"".join(padded), dtype=">u4").astype(np.uint32)
    blocks = torch.from_numpy(words.view(np.int32).reshape(
        SHA_MESSAGES, -1, 16)).to(dev)
    out = sha256_blocks(blocks).cpu().numpy().view(np.uint32).astype(">u4")
    if [row.tobytes() for row in out] != [hashlib.sha256(m).digest()
                                          for m in msgs]:
        raise AssertionError("batched-hashes: sha256")
    phase("batched-hashes", **card_fields(t_phase),
          keccak_messages=HASH_MESSAGES * len(HASH_LENGTHS),
          keccak_lengths=",".join(map(str, HASH_LENGTHS)), k3_launches=k3,
          sha256_messages=SHA_MESSAGES, sha256_blocks=blocks.shape[1],
          equal_to_golden_and_hashlib=True)
    return k3


def sponge_blocks(streams) -> list:
    """Each stream's rate blocks in the sponge: n // 34 + 1 for n words."""
    return [int(s.size) // 34 + 1 for s in streams]


def sponge_phase(dev, sm_mhz: float, memory_streams: list,
                 log_records: np.ndarray) -> tuple:
    """K3-sponge: the ragged sponge against its plain version on the card,
    bit for bit, on the edge lengths and a mixed batch, on a T = 1 fold of
    8192 digests and on block-realistic's memory-family streams (each cut
    to its first SPONGE_PLAIN_BLOCKS blocks); CUDA-event times (best of 3)
    beside the bound and the serial floor (the longest stream's blocks at
    one permutation's single-thread latency, K3 at N = 1 chained
    SERIAL_ITERS times), and the kernel's time on the whole streams; and
    the log fingerprints through K3 (the path's) and through the sponge,
    both timed and equal.  Returns the kernels line's (max abs err, ms,
    plain ms, bound) at block-realistic's cut memory streams."""
    rng = np.random.default_rng(7)
    lengths = SPONGE_EDGE + tuple(rng.integers(0, 12 * 34, SPONGE_MIXED))
    sets = (("edge", [rng.integers(0, 1 << 32, int(n), dtype=np.uint32)
                      for n in lengths]),
            ("fold", [rng.integers(0, 1 << 32, 8 * FOLD_DIGESTS,
                                   dtype=np.uint32)]),
            ("realistic_memory", [
                s.reshape(-1)[:SPONGE_PLAIN_BLOCKS * packed.RATE_WORDS - 1]
                for s in memory_streams]))
    one = torch.zeros((1, 25, 2), dtype=torch.int32, device=dev)
    keccak.keccak_f1600_(one, 16)
    perm_ms = timed_ms(lambda: keccak.keccak_f1600_(one, SERIAL_ITERS)) \
        / SERIAL_ITERS
    err, fields = 0, {"perm_latency_us": round(perm_ms * 1e3, 4)}
    for name, streams in sets:
        args = packed.ragged_words(streams, dev)
        keccak.keccak256_ragged(*args)                           # warm
        box = {}
        ms = min(timed_ms(lambda: box.__setitem__(
            "k", keccak.keccak256_ragged(*args))) for _ in range(3))
        plain_ms = timed_ms(lambda: box.__setitem__(
            "p", keccak.keccak256_ragged_plain(*args[:2])))
        err = max(err, require_equal(f"sponge {name}", {"digests": box["k"]},
                                     {"digests": box["p"]}))
        nbs = sponge_blocks(streams)
        n_bytes = sum(4 * t.numel() * (2 if t.dtype == torch.int64 else 1)
                      for t in args) + 32 * len(streams)
        bound = bound_ms(n_bytes, sum(nbs) * KECCAK_OPS, sm_mhz)
        fields.update({f"{name}_streams": len(streams),
                       f"{name}_blocks": sum(nbs),
                       f"{name}_longest": max(nbs), f"{name}_ms": round(ms, 4),
                       f"{name}_plain_ms": round(plain_ms, 1),
                       f"{name}_bound_ms": round(bound[0], 4),
                       f"{name}_bound_by": bound[1],
                       f"{name}_serial_floor_ms": round(max(nbs) * perm_ms,
                                                        4)})
        del args, box
    # the kernel alone on block-realistic's whole memory streams
    args = packed.ragged_words(memory_streams, dev)
    keccak.keccak256_ragged(*args)                               # warm
    nbs = sponge_blocks(memory_streams)
    n_bytes = sum(4 * t.numel() * (2 if t.dtype == torch.int64 else 1)
                  for t in args) + 32 * len(memory_streams)
    bound = bound_ms(n_bytes, sum(nbs) * KECCAK_OPS, sm_mhz)
    fields.update({
        "realistic_whole_blocks": sum(nbs),
        "realistic_whole_longest": max(nbs),
        "realistic_whole_ms": round(min(timed_ms(
            lambda: keccak.keccak256_ragged(*args)) for _ in range(3)), 4),
        "realistic_whole_bound_ms": round(bound[0], 4),
        "realistic_whole_serial_floor_ms": round(max(nbs) * perm_ms, 4)})
    del args
    # the fingerprints: K3 on one padded block a record (packed.fingerprints)
    # against the sponge on 32-word streams at offsets 32 i
    recs = torch.from_numpy(log_records.view(np.int32)).to(dev)
    n = recs.shape[0]
    offsets = torch.arange(n + 1, dtype=torch.int64, device=dev) * 32
    order = torch.arange(n, dtype=torch.int32, device=dev)

    def fp_sponge():
        d = keccak.keccak256_ragged(recs.reshape(-1), offsets, order)
        return gl_reduce64(wide(d[:, 0]), wide(d[:, 1]))

    box = {}
    fp_k3 = min(timed_ms(lambda: box.__setitem__(
        "k3", packed.fingerprints(recs))) for _ in range(4))
    fp_sp = min(timed_ms(lambda: box.__setitem__("sp", fp_sponge()))
                for _ in range(4))
    for a, b in zip(box["k3"], box["sp"]):
        if not torch.equal(a, b):
            raise AssertionError("fingerprints: K3 and the sponge differ")
    phase("K3-sponge", equal=True, **fields, fingerprint_records=n,
          fingerprints_k3_ms=round(fp_k3, 4),
          fingerprints_sponge_ms=round(fp_sp, 4))
    return (err, fields["realistic_memory_ms"],
            fields["realistic_memory_plain_ms"],
            (fields["realistic_memory_bound_ms"],
             fields["realistic_memory_bound_by"]))


def p3_sass_per_step(sass: str | None) -> dict:
    """SASS instructions a step of P3's main loop at 8 rows, by op, in the
    built library's cuobjdump listing: (all, logic) in the first loop, the
    unrolled one, over the steps a trip (eravm_p3_unroll); {} where the
    toolkit has no cuobjdump."""
    if sass is None:
        return {}
    unroll = _build.load().eravm_p3_unroll()
    out = {}
    for op, code in (("xor", 0), ("mix", 1), ("andnot", 2)):
        loops = k1_times.sass_loops(sass, rf"p3_kernelILi{code}ELi8E")
        if loops:   # the unrolled loop comes first, its remainder after
            n_all, n_logic = loops[0]
            out[op] = (n_all / unroll, n_logic / unroll)
    return out


def p7_permutations(flags: torch.Tensor, count: torch.Tensor,
                    variant: str) -> int:
    """Permutations the fold P7 runs on these inputs."""
    c, n = count.clone(), 0
    for flg in flags:
        valid = (flg & 4) != 0
        wrap = ((flg >> 2) & c & 1) != 0
        n += int((valid if variant == "old" else wrap).sum())
        c = c + valid.to(torch.int32)
    return n


def probe_phases(dev, sm_mhz: float, listing: str | None,
                 k3_same_perms_ms: float, n1_us: float) -> dict:
    """The tool probes P1-P7: each kernel against its plain version on the
    card; times at the tools' shapes; then the tools' entry points, the
    probes' main path, with the launch counts zeroed just before.
    `listing` is the built library's SASS (cuobjdump; None without it),
    `k3_same_perms_ms` K3's time at bench_keccak's 65536 x 2048, as many
    permutations as P2 runs at G8 = 4096, `n1_us` K3's single-thread
    latency a permutation (P4's serial floor).  Returns {probe: (launches, max
    abs err, ms, plain ms, bound)} for the kernels line."""
    pk, pu, bf = probe_keccak, probe_uniform, bisect_fold
    gen = torch.Generator().manual_seed(21)

    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def best_ms(fn, reps=3):
        fn()
        return min(timed_ms(fn) for _ in range(reps))

    def check(what, got, want):
        return require_equal(what, {"out": got}, {"out": want})

    rows = {}
    # -- P1 ----------------------------------------------------------------
    st = rand(P_BATCH, 25, 2)
    err = 0
    for tile, unroll in ((64, 1), (512, 2), (P_TILE, 4)):
        small = st[:4096]
        err = max(err, check(f"P1 tile={tile} unroll={unroll}",
                             pk.keccak_rows2d(small, 4, tile, unroll),
                             keccak.keccak_f1600_plain(small, 4)))
    box = {}
    ms = best_ms(lambda: box.__setitem__("k", pk.keccak_rows2d(
        st, P_ITERS, P_TILE)))
    plain_ms = timed_ms(lambda: box.__setitem__(
        "p", keccak.keccak_f1600_plain(st, P_ITERS)))
    err = max(err, check("P1 131072 x 128", box["k"], box["p"]))
    # the probe tools' other rows2d instance, at the same shape
    err = max(err, check("P1 131072 x 128 tile=512 unroll=2",
                         pk.keccak_rows2d(st, P_ITERS, 512, 2), box["p"]))
    k3_ms = best_ms(lambda: keccak.keccak_f1600(st, P_ITERS))
    rows["P1"] = [err, ms, plain_ms, bound_ms(
        2 * P_BATCH * 200, P_BATCH * P_ITERS * KECCAK_OPS, sm_mhz)]
    phase("P1", batch=P_BATCH, iters=P_ITERS, tile=P_TILE, equal=True,
          ms=round(ms, 3), plain_ms=round(plain_ms, 1),
          bound_ms=round(rows["P1"][3][0], 3), k3_same_shape_ms=round(k3_ms, 3),
          perms_per_sec=P_BATCH * P_ITERS / (ms / 1e3))
    del st, box

    # -- P2 / P5 -----------------------------------------------------------
    # the planes of random states, so that each output is held against its
    # plain version and, through planes_to_states, against K3; each kernel
    # the best of 3 at both G8, its share of the bound, the warps an SM
    # holds, the SASS a round, and P2 at G8 = 4096 (as many permutations as
    # bench_keccak) over K3's time there
    lib = _build.load()
    design = k1_times.bitslice_design(pathlib.Path(__file__).resolve().parent)
    occupancy = {"P2": lib.eravm_p2_warps_per_sm(0),
                 "P5": lib.eravm_p2_warps_per_sm(1)}
    p2_sass = k1_times.bitslice_round_sass(listing, design["trip"])
    times = {}
    for g8 in P_G8:
        states = rand(256 * g8, 25, 2)
        planes = pk.states_to_planes(states)
        cols = 8 * g8
        bound = bound_ms(2 * 6400 * cols,
                         cols * 24 * P_ITERS * BITSLICE_ROUND_OPS, sm_mhz)
        if g8 == P_G8[0]:       # checked at the timed shape
            box = {}
            plain_ms = timed_ms(lambda: box.__setitem__(
                "p", pk.keccak_bitslice_plain(planes, P_ITERS)))
            k3 = keccak.keccak_f1600(states, P_ITERS)
        else:                   # checked at one permutation, then timed
            want = pk.keccak_bitslice_plain(planes, 1)
            k3 = keccak.keccak_f1600(states, 1)
        for name, f in (("P2", pk.keccak_bitslice),
                        ("P5", pk.keccak_bitslice_fused)):
            if g8 == P_G8[0]:
                ms = best_ms(lambda: box.__setitem__("k", f(planes, P_ITERS)))
                err = max(check(f"{name} G8={g8}", box["k"], box["p"]),
                          check(f"{name} G8={g8} against K3",
                                pk.planes_to_states(box["k"]), k3))
                rows[name] = [err, ms, plain_ms, bound]
            else:
                got = f(planes, 1)
                err = max(rows[name][0],
                          check(f"{name} G8={g8}", got, want),
                          check(f"{name} G8={g8} against K3",
                                pk.planes_to_states(got), k3))
                del got
                ms = best_ms(lambda: f(planes, P_ITERS))
                rows[name][0] = err
            times[(name, g8)] = (ms, bound[0])
        del planes, states, k3
    sass_fields = {f"{n}_sass_round": "not measured" if v is None else
                   ", ".join(f"{k} {x:g}" for k, x in v.items())
                   for n, v in p2_sass.items()}
    phase("P2-P5", iters=P_ITERS, equal=True, **{
        f"{n}_g{g}_ms": round(t[0], 4) for (n, g), t in times.items()}, **{
        f"{n}_g{g}_perms_per_sec": 256 * g * P_ITERS / (t[0] / 1e3)
        for (n, g), t in times.items()}, **{
        f"g{g}_bound_ms": round(t[1], 4) for (n, g), t in times.items()}, **{
        f"{n}_g{g}_share_of_bound": round(t[1] / t[0], 4)
        for (n, g), t in times.items()}, **{
        f"P5_over_P2_g{g}": round(times[("P5", g)][0]
                                  / times[("P2", g)][0], 3) for g in P_G8},
        **design, **{f"{n}_warps_an_sm_held": w for n, w in occupancy.items()},
        **{f"g{g}_warps_an_sm": round(min(8 * g / 132, occupancy["P2"]), 2)
           for g in P_G8}, **sass_fields,
        k3_same_perms_ms=round(k3_same_perms_ms, 3),
        p2_g4096_vs_k3_same_perms=round(
            times[("P2", P_G8[1])][0] / k3_same_perms_ms, 4),
        plain_g128_ms=round(rows["P2"][2], 1))

    # -- P3 ----------------------------------------------------------------
    sass = p3_sass_per_step(listing)
    peak = INT32_LANES * sm_mhz * 1e6
    steps = P3_ITERS * (P3_INNER // P3_ROWS)
    fields = {}
    for op in ("xor", "mix", "andnot"):
        x = rand(P3_ROWS, P3_COLS)
        box = {}
        ms = best_ms(lambda: box.__setitem__("k", pk.alu_chain(
            x, op, P3_INNER, P3_ROW_ITERS)))
        plain_ms = timed_ms(lambda: box.__setitem__("p", pk.alu_chain_plain(
            x, op, P3_INNER, P3_ROW_ITERS)))
        err = check(f"P3 {op}", box["k"], box["p"])
        # the probe tools' shape: 1024 columns as [8, 8, 128]
        narrow = x[:, :1024].reshape(P3_ROWS, 8, 128)
        err = max(err, check(
            f"P3 {op} 1024 columns",
            pk.alu_chain(narrow, op, P3_INNER, P3_ROW_ITERS),
            pk.alu_chain_plain(narrow, op, P3_INNER, P3_ROW_ITERS)))
        row_steps = P3_ROW_ITERS * (P3_INNER // P3_ROWS)
        bound = bound_ms(2 * 4 * P3_ROWS * P3_COLS, row_steps * P3_ROWS
                         * P3_COLS * P3_CARD_OPS[op], sm_mhz)
        if op == "andnot":
            rows["P3"] = [err, ms, plain_ms, bound]
        full_s = timed_ms(lambda: pk.alu_chain(x, op, P3_INNER,
                                               P3_ITERS)) / 1e3
        fields[f"{op}_ms"] = round(full_s * 1e3, 3)
        fields[f"{op}_ops_per_sec"] = steps * P3_ROWS \
            * pk.OPS_PER_STEP[op] * P3_COLS / full_s
        fields[f"{op}_card_ops_vs_peak"] = round(
            steps * P3_ROWS * P3_CARD_OPS[op] * P3_COLS / full_s / peak, 4)
        if op in sass:
            n_all, n_logic = sass[op]
            fields[f"{op}_sass_per_step"] = n_all
            fields[f"{op}_logic_per_step"] = n_logic
            fields[f"{op}_instr_per_sec"] = n_all * steps * P3_COLS / full_s
            fields[f"{op}_logic_per_sec"] = \
                n_logic * steps * P3_COLS / full_s
            fields[f"{op}_logic_vs_peak"] = round(
                n_logic * steps * P3_COLS / full_s / peak, 4)
        else:
            fields[f"{op}_sass_per_step"] = "not measured"
        del x
    phase("P3", rows=P3_ROWS, inner=P3_INNER, iters=P3_ITERS,
          columns=P3_COLS, equal=True, int32_peak_per_sec=peak, **fields)

    # -- P4 ----------------------------------------------------------------
    x = rand(P4_TILE, 25, 2)
    box = {}
    ms = best_ms(lambda: box.__setitem__("k", pk.round_chain(x, P4_ITERS)))
    plain_ms = timed_ms(lambda: box.__setitem__(
        "p", pk.round_chain_plain(x, P4_ITERS)))
    err = check("P4", box["k"], box["p"])
    rows["P4"] = [err, ms, plain_ms, bound_ms(
        2 * P4_TILE * 200, P4_TILE * P4_ITERS * KECCAK_OPS // 24, sm_mhz)]
    # each thread's P4_ITERS rounds are dependent: at most one round of K3's
    # single-thread permutation (its N = 1 latency over 24) at a time
    serial_ms = P4_ITERS * n1_us / 24 / 1e3
    big = rand(P4_COLS, 25, 2)
    big_ms = best_ms(lambda: pk.round_chain(big, P4_ITERS), reps=1)
    big_bound = bound_ms(2 * P4_COLS * 200,
                         P4_COLS * P4_ITERS * KECCAK_OPS // 24, sm_mhz)
    phase("P4", iters=P4_ITERS, tile=P4_TILE, equal=True, ms=round(ms, 3),
          plain_ms=round(plain_ms, 1), bound_ms=round(rows["P4"][3][0], 4),
          serial_floor_ms=round(serial_ms, 4),
          share_of_serial_floor=round(serial_ms / ms, 4),
          perm_equiv_per_sec=P4_TILE * P4_ITERS / 24 / (ms / 1e3),
          states_full=P4_COLS, ms_full=round(big_ms, 3),
          bound_ms_full=round(big_bound[0], 3),
          perm_equiv_per_sec_full=P4_COLS * P4_ITERS / 24 / (big_ms / 1e3))
    del x, big, box

    # -- P6 ----------------------------------------------------------------
    # the tool's batch-last arena [8, W, TB], K1's lane-major [TB, 8, W] and
    # K1's word reads, each case against its plain version and beside its
    # floor: its warp loads' sectors through the card's L1s at 128 bytes a
    # clock an SM, or its compulsory bytes over device memory's rate
    # (k1_times.p6_sectors, p6_floor_ms); the kernels line's row is the
    # batch-last arena at the largest TB, the tool's index, mode 1
    fields, err = {}, 0
    for tb in P6_TBS:
        fields[f"tb{tb}_split"] = pu.card_split(tb, dev)
        fields[f"tb{tb}_words_split"] = pu.card_split(tb, dev, words=True)
        for random_index in (False, True):
            kind = "random" if random_index else "uniform"
            box = {}
            for layout in ("batch_last", "lane_major") + tuple(pu.WORD_LAYOUTS):
                words = layout in pu.WORD_LAYOUTS
                arena, idx = pu.tool_inputs(
                    P6_W, tb, dev, random_index, layout == "lane_major",
                    layout if words else None)
                floor = k1_times.p6_floor_ms(
                    k1_times.p6_sectors(idx, P6_W, tb, layout), P6_REPS, tb,
                    sm_mhz)
                if layout == "batch_last":
                    plain_ms = timed_ms(lambda: box.__setitem__(
                        "p", pu.uniform_gather_plain(arena, idx, P6_REPS)))
                if words:
                    runs = {"": lambda: pu.word_gather(arena, idx, P6_REPS,
                                                       layout)}
                else:
                    runs = {f"_mode{m}": lambda m=m: pu.uniform_gather(
                        arena, idx, P6_REPS, m, layout == "lane_major")
                        for m in (0, 1)}
                for suffix, run in runs.items():
                    ms = best_ms(lambda: box.__setitem__("k", run()))
                    dev_ms = min(k1_times.held_ms(run) for _ in range(3))
                    tag = f"tb{tb}_{layout}_{kind}{suffix}"
                    err = max(err, check(f"P6 {tag}", box["k"], box["p"]))
                    fields.update({f"{tag}_ms": ms,
                                   f"{tag}_device_ms": dev_ms,
                                   f"{tag}_floor_ms": floor,
                                   f"{tag}_share": floor / dev_ms})
                    if tb == P6_TBS[-1] and not random_index \
                            and layout == "batch_last" and suffix == "_mode1":
                        rows["P6"] = [err, dev_ms, plain_ms,
                                      (floor, "bytes")]
                del arena, idx
            del box
    # the tool's own shape, whose work is shorter than a launch, beside an
    # empty kernel launched the same way (both timings)
    empty_ms = best_ms(lambda: pu.empty_launch(dev))
    empty_dev_ms = min(k1_times.held_ms(lambda: pu.empty_launch(dev))
                       for _ in range(3))
    tool = f"tb{P6_TBS[0]}_batch_last_uniform_mode1"
    fields.update(
        empty_launch_ms=empty_ms, empty_launch_device_ms=empty_dev_ms,
        tool_shape_over_empty=fields[f"{tool}_ms"] / empty_ms,
        tool_shape_device_over_empty=fields[f"{tool}_device_ms"]
        / empty_dev_ms)
    for name, fn in (("", "p6_kernel"), ("words_", "p6w_kernel")):
        loads = k1_times.load_overlap_sass(listing, fn)
        fields.update({f"{name}{k}": "not measured" if loads is None else
                       (",".join(loads[k]) if k == "load_opcodes" else loads[k])
                       for k in ("load_opcodes", "loads_a_trip", "in_flight",
                                 "instructions_a_trip")})
    # the earlier design's latency floor, which explains it and bounds
    # nothing now: its loads were strong (served by L2), 16 issued before
    # the first was read, so a lane waited at least REPS / 16 times for one
    # load's latency, from one warp's chain of dependent strong loads (2
    # REPS less REPS loads, over REPS); line_sum, those loads each to
    # another line than the 15 before it
    box = {}
    # the chain held against its plain version where each step reads
    # another word, before it is timed on the identity arena
    perm_arena = torch.randperm(1024, generator=gen).to(torch.int32).to(dev)
    perm_start = torch.randint(0, 1024, (32,), generator=gen,
                               dtype=torch.int32).to(dev)
    for reps in (1, 7, 64):
        err = max(err, check(
            f"P6 chain x{reps} permuted",
            pu.chain_gather(perm_arena, perm_start, reps),
            pu.chain_gather_plain(perm_arena, perm_start, reps)))
    chain_arena = torch.arange(1024, dtype=torch.int32, device=dev)
    chain_start = torch.arange(32, dtype=torch.int32, device=dev)
    chain_ms = {}
    for reps in (P6_REPS, 2 * P6_REPS):
        chain_ms[reps] = best_ms(lambda: box.__setitem__(
            "k", pu.chain_gather(chain_arena, chain_start, reps)))
        err = max(err, check(f"P6 chain x{reps}", box["k"], chain_start))
    latency_ns = (chain_ms[2 * P6_REPS] - chain_ms[P6_REPS]) / P6_REPS * 1e6
    lines = rand(16 * 8 * P6_W)
    lines_ms = best_ms(lambda: box.__setitem__(
        "k", pu.line_sum(lines, P6_W, 8, P6_REPS)))
    err = max(err, check("P6 lines", box["k"],
                         pu.line_sum_plain(lines, P6_W, 8, P6_REPS)))
    fields.update(
        strong_latency_ns=round(latency_ns, 2),
        chain_ms=round(chain_ms[P6_REPS], 5),
        old_latency_floor_ms=round(math.ceil(P6_REPS / 16) * latency_ns / 1e6,
                                   5),
        lines_ms=round(lines_ms, 5))
    del box, lines, chain_arena, chain_start, perm_arena, perm_start
    rows["P6"][0] = err
    phase("P6", w=P6_W, reps=P6_REPS, equal=True, **fields)

    # -- P7 ----------------------------------------------------------------
    flags, st = bf.tool_inputs(bf.B, dev)
    rflags = torch.randint(0, 8, (bf.KQ, bf.B), generator=gen,
                           dtype=torch.int32).to(dev)
    rst = rand(51, bf.B)
    rst[50] = torch.randint(0, 4, (bf.B,), generator=gen,
                            dtype=torch.int32).to(dev)
    fields, err = {}, 0
    for v in ("old", "wrapb", "sel", "two"):
        err = max(err, check(f"P7 {v} random", bf.fold(rflags, rst, v),
                             bf.fold_plain(rflags, rst, v)))
        box = {}
        ms = best_ms(lambda: box.__setitem__("k", bf.fold(flags, st, v)))
        plain_ms = timed_ms(lambda: box.__setitem__(
            "p", bf.fold_plain(flags, st, v)))
        err = max(err, check(f"P7 {v}", box["k"], box["p"]))
        perms = p7_permutations(flags, st[50], v)
        bound = bound_ms(4 * bf.B * (bf.KQ + 2 * 51), perms * KECCAK_OPS,
                         sm_mhz)
        fields[f"{v}_ms"] = round(ms, 4)
        fields[f"{v}_bound_ms"] = round(bound[0], 4)
        fields[f"{v}_permutations"] = perms
        if v == "two":
            rows["P7"] = [err, ms, plain_ms, bound]
    rows["P7"][0] = err
    phase("P7", batch=bf.B, slots=bf.KQ, equal=True,
          plain_two_ms=round(rows["P7"][2], 3), **fields)
    del flags, st, rflags, rst

    # -- the probes' main path: the tools' entry points -----------------------
    for mod, name in PROBE_COUNTS.values():
        setattr(mod, name, 0)
    t0 = time.time()
    rates = pk.main(["base", "rows2d", "rows2d_t512_u2", "roundrate",
                     "vpu_xor", "vpu_mix", "vpu_andnot", "bitslice",
                     "bitslice_fused"])
    gathers = [pu.main([]), pu.main(["--tb", str(P6_TBS[1]), "--random"]),
               pu.main(["--tb", str(P6_TBS[1]), "--lane-major"])]
    folds = bf.main([])
    launches = {p: getattr(mod, name) for p, (mod, name) in
                PROBE_COUNTS.items()}
    values = list(rates.values()) + [v for g in gathers for v in g.values()] \
        + list(folds.values())
    if any(n == 0 for n in launches.values()) or len(rates) != 9 \
            or not all(math.isfinite(v) and v > 0 for v in values):
        raise AssertionError(f"probe tools: launches {launches}, rates "
                             f"{rates}, gathers {gathers}, folds {folds}")
    phase("probe-tools", seconds=round(time.time() - t0, 1),
          **{f"launches_{p}": n for p, n in launches.items()},
          **{f"{v}_per_sec": r for v, r in rates.items()})
    return {p: [launches[p]] + rows[p] for p in PROBE_COUNTS}


def fold_tools_phase() -> None:
    """The fold tools (era_zk_evm_tpu_torch/tools/probe_rolling.py,
    probe_foldparts.py, probe_bsparts.py, probe_fold_split.py,
    probe_bsfold.py) at their default shapes, through their entry points:
    each raises when its own checks fail (mode (a)'s counts against mode
    (b)'s, K2 on the compacted capture queue against mode (b)'s sponges,
    every K2 run against rolling_absorb_rows on the card).  Raises unless
    K2 and P2 launched, every timed value is finite and > 0 and every line
    without a counterpart says why."""
    k2_0, p2_0 = fused_cycle.K2_LAUNCHES, probe_keccak.P2_LAUNCHES
    t0 = time.time()
    out = {"rolling": probe_rolling.main([]),
           "foldparts": probe_foldparts.main([]),
           "bsparts": probe_bsparts.main([]),
           "fold_split": probe_fold_split.main([]),
           "fold_split_pieces": probe_fold_split.main(["pieces"]),
           "bsfold": probe_bsfold.main([])}
    seconds = time.time() - t0
    launches = {"K2": fused_cycle.K2_LAUNCHES - k2_0,
                "P2": probe_keccak.P2_LAUNCHES - p2_0}
    bad = [f"{tool}: {label}" for tool, rows in out.items()
           for label, row in rows.items()
           if any(v is None for v in row.values()) and not row.get("reason")
           or not all(math.isfinite(v) and v > 0 for v in row.values()
                      if isinstance(v, float))]
    rolling = out["rolling"]
    checks = (rolling["profile"]["counts_equal"]
              and rolling["fold[u32pair]"]["equal_to_mode_b"]
              and all(row.get("equal_to_plain", True)
                      for rows in out.values() for row in rows.values()))
    if bad or not checks or not all(launches.values()):
        raise AssertionError(f"fold tools: launches {launches}, rows {bad}, "
                             f"checks {checks}")
    parts = out["foldparts"]
    phase("fold-tools", seconds=round(seconds, 1),
          **{f"launches_{k}": v for k, v in launches.items()},
          **{f"k2_{v}_ms": round(parts[v]["ms"], 4)
             for v in probe_foldparts.VARIANTS},
          **{f"k2_{v}_device_ms": round(parts[v]["device_ms"], 4)
             for v in probe_foldparts.VARIANTS},
          **{f"k2_{v}_bound_ms": round(parts[v]["bound_ms"], 4)
             for v in probe_foldparts.VARIANTS},
          k2_fold_ms=round(rolling["fold[u32pair]"]["ms"], 4),
          k2_fold_device_ms=round(rolling["fold[u32pair]"]["device_ms"], 4),
          k2_fold_bound_ms=round(rolling["fold[u32pair]"]["bound_ms"], 4),
          records_lane=rolling["profile"]["mean_lane_records"],
          **{f"{m}_{k}": rolling[m][k] for m in probe_rolling.MODES
             for k in ("piped_cycles_per_sec", "sync_cycles_per_sec",
                       "k1_device_ms", "k2_device_ms", "other_device_ms")})


def ablate_phase(config: VmConfig, entry, flags: list, build_s: float):
    """K1-ablate: the default K1, the perfect-cache build (ABLATE_SKIP) and
    the stage cut (ABLATE_STAGE) on WORKLOAD, each the best of 3 calls on a
    fresh copy of the entry state after a warm one; then the checks."""
    t_phase = time.perf_counter()
    variants = {"default": {}, "skip_stack_heap": {"skip": ABLATE_SKIP},
                f"stage{ABLATE_STAGE}": {"stage": ABLATE_STAGE}}
    fields, states = {}, {}
    for (name, kw), f in zip(variants.items(), [()] + flags):
        with fused_cycle.k1_hooks(**kw):
            warm = clone_state(entry)
            fused_cycle.cycle_chunk(warm, config, K)          # loads
            del warm
            times = []
            for _ in range(3):
                st = clone_state(entry)
                times.append(timed_ms(
                    lambda: fused_cycle.cycle_chunk(st, config, K)))
                states[name] = st
        fields[f"ms_{name}"] = round(min(times), 4)
        fields[f"ptxas_{name}"] = repr(ablate_fused.ptxas_text(
            ablate_fused.ptxas_line(config, tuple(f))))
    # the cut leaves the lanes as they entered but for timestamp; the
    # chunk advances global_step, as the JAX body does on a cut
    want = state_tensors(entry)
    want["global_step"] = want["global_step"] + K
    got = state_tensors(states.pop(f"stage{ABLATE_STAGE}"))
    moved = [k for k in want if not torch.equal(got[k], want[k])]
    if moved not in ([], ["timestamp"]):
        raise AssertionError(f"K1-ablate: the stage-{ABLATE_STAGE} cut "
                             f"changed {moved}")
    del states, got, want
    # the perfect cache changes nothing where no arena is touched
    alu = make_entry_state(
        config, [assemble(ablate_fused.PROG_ALU)] * config.batch,
        ergs=FULL_ERGS, device=entry.done.device)
    default, skipped = clone_state(alu), clone_state(alu)
    fused_cycle.cycle_chunk(default, config, K)
    with fused_cycle.k1_hooks(skip=ABLATE_SKIP):
        fused_cycle.cycle_chunk(skipped, config, K)
    require_equal("K1-ablate skip build, PROG_ALU", state_tensors(skipped),
                  state_tensors(default))
    del alu, default, skipped
    # and the default K1 after both, against its plain version
    ks, ps = clone_state(entry), clone_state(entry)
    fused_cycle.cycle_chunk(ks, config, K)
    batched_vm.run_cycles(ps, config, K)
    require_equal("K1-ablate default after the hooks", state_tensors(ks),
                  state_tensors(ps))
    del ks, ps
    torch.cuda.empty_cache()
    phase("K1-ablate", **card_fields(t_phase), batch=config.batch, cycles=K,
          equal=True, skip=",".join(sorted(ABLATE_SKIP)), stage=ABLATE_STAGE,
          build_s=round(build_s, 1), **fields)


def main() -> int:
    t_start = time.time()
    # -- device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    card = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, sm_max_mhz=sm_mhz)

    # -- build ---------------------------------------------------------
    # the oracle's g++ build runs beside nvcc's
    oracle = {}

    def build_oracle():
        t = time.perf_counter()
        try:
            oracle["lib"] = native.build()
        except Exception as exc:       # raised on the main thread below
            oracle["error"] = exc
        oracle["seconds"] = time.perf_counter() - t

    oracle_thread = threading.Thread(target=build_oracle)
    oracle_thread.start()
    # K1-ablate's two hooked builds, beside the main build: no timed phase
    # runs while they compile
    ablate_flags = [ablate_fused.hook_flags(ABLATE_SKIP),
                    ablate_fused.hook_flags(stage=ABLATE_STAGE)]
    ablate_build = {}

    def build_ablate():
        t = time.perf_counter()
        try:
            _build.build_hooked([list(f) for f in ablate_flags])
        except Exception as exc:       # raised on the main thread below
            ablate_build["error"] = exc
        ablate_build["seconds"] = time.perf_counter() - t

    ablate_thread = threading.Thread(target=build_ablate)
    ablate_thread.start()
    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    log = (lib_path.parent / "build.log").read_text()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    threads = {b: fused_cycle.k1_threads(b) for b in (B_BLOCK, B_FULL)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if -(-B_BLOCK // threads[B_BLOCK]) < min(sms, B_BLOCK // 32):
        raise AssertionError(f"K1 at B={B_BLOCK}: {threads[B_BLOCK]}-thread "
                             f"blocks leave SMs of {sms} idle")
    named = {name: "{registers} regs, {frame} B frame, {spill_stores}/"
             "{spill_loads} B spilled".format(**v)
             for name, v in k1_times.ptxas(log).items()}
    phase("build", seconds=round(time.time() - t0, 2),
          lib=lib_path.parent.name, ptxas=" | ".join(regs), sms=sms,
          k1_threads=threads, ptxas_kernels=json.dumps(named))
    ablate_thread.join()
    if "error" in ablate_build:
        raise ablate_build["error"]
    t0 = time.time()
    oracle_thread.join()
    if "error" in oracle:
        raise oracle["error"]
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    phase("native", gxx=repr(gxx), build_seconds=round(oracle["seconds"], 2),
          lib=oracle["lib"].parent.name, seconds=round(time.time() - t0, 2))

    # -- K1 against plain, memory-witness slice -------------------------
    progs = list(FAMILY_PROGRAMS.values())
    words = [assemble(p) for p in progs]
    for rolling in (False, True):
        cfg = small_config(len(words), rolling)
        ks = make_entry_state(cfg, words, ergs=1 << 20, device=dev)
        ps = clone_state(ks)
        fused_cycle.run_cycles(ks, cfg, 48, k_inner=20)
        batched_vm.run_cycles(ps, cfg, 48)
        torch.cuda.synchronize()
        require_equal(f"K1 family programs rolling={rolling}",
                      state_tensors(ks), state_tensors(ps))
        errs = ks.lane_error.cpu().tolist()
        expect = [name == "unsupported_log" for name in FAMILY_PROGRAMS]
        if errs != expect:
            raise AssertionError(f"lane_error {errs} != {expect}")
    phase("K1-small", programs=len(progs), cycles=48, modes="a,b", equal=True)
    units_off_phase(dev)

    cfg_a = bench_config(B_FULL, rolling=False)
    wl = assemble(WORKLOAD)
    entry_a = make_entry_state(cfg_a, [wl] * B_FULL, ergs=FULL_ERGS,
                               device=dev)
    warm = clone_state(entry_a)
    fused_cycle.cycle_chunk(warm, cfg_a, K)      # loads the module
    del warm
    ks = clone_state(entry_a)
    ps = clone_state(entry_a)
    k1_ms = timed_ms(lambda: fused_cycle.cycle_chunk(ks, cfg_a, K))
    k1_plain_ms = timed_ms(lambda: batched_vm.run_cycles(ps, cfg_a, K))
    k1_err = require_equal("K1 WORKLOAD B=32768", state_tensors(ks),
                           state_tensors(ps))
    k1_nbytes = k1_bytes(entry_a, ks, cfg_a)
    k1_bound = bound_ms(k1_nbytes, B_FULL * K * K1_MIN_OPS, sm_mhz)
    phase("K1", batch=B_FULL, cycles=K, equal=True, ms=round(k1_ms, 3),
          plain_ms=round(k1_plain_ms, 3), bound_ms=round(k1_bound[0], 3),
          bound_by=k1_bound[1], bound_bytes=k1_nbytes)
    del ks, ps
    ablate_phase(cfg_a, entry_a, ablate_flags, ablate_build["seconds"])

    # -- K1 in mode (b) and K2 against plain ----------------------------
    cfg_b = bench_config(B_FULL, rolling=True)
    entry_b = make_entry_state(cfg_b, [wl] * B_FULL, ergs=FULL_ERGS,
                               device=dev)
    st = clone_state(entry_b)
    block = fused_cycle.new_slot_block(cfg_b, K, dev)
    fused_cycle.cycle_chunk(st, cfg_b, K, K, block)
    fused_cycle.rolling_fold(st.wc_state, st.wc_count, block)
    # a second chunk's records: K1 alone, against the plain engine's dense
    # slot rows compacted, every field and the block's rows and counts
    ps = clone_state(st)
    k1b_ms = timed_ms(lambda: fused_cycle.cycle_chunk(st, cfg_b, K, K, block))
    k1b_nbytes = k1_bytes(ps, st, cfg_b)       # ps is still the state before
    dense = tuple(torch.empty(x.shape, dtype=torch.int32, device=dev)
                  for x in block[:3])

    def plain_chunk():
        for c in range(K):
            batched_vm.cycle_step(ps, cfg_b, tuple(x[c * 8:(c + 1) * 8]
                                                   for x in dense))

    k1b_plain_ms = timed_ms(plain_chunk)
    want = compact_slot_rows(*dense)
    live = torch.arange(K * 8, device=dev)[:, None] < want[3][None, :]
    got_rows = {"count": block[3]}
    want_rows = {"count": want[3]}
    for name, g, w, keep in (("meta", block[0], want[0], live[:, None]),
                             ("value", block[1], want[1], live[:, None]),
                             ("flags", block[2], want[2], live)):
        got_rows[name] = torch.where(keep, g, 0)
        want_rows[name] = torch.where(keep, w, 0)
    k1b_err = max(require_equal("K1 mode (b) B=32768", state_tensors(st),
                                state_tensors(ps)),
                  require_equal("K1 mode (b) records B=32768", got_rows,
                                want_rows))
    k1_err = max(k1_err, k1b_err)
    del ps, dense, want, got_rows, want_rows, live
    k2_all = []                 # the best of five launches, each on a copy
    for _ in range(5):
        wa, ca = st.wc_state.clone(), st.wc_count.clone()
        k2_all.append(timed_ms(
            lambda: fused_cycle.rolling_fold(wa, ca, block)))
    k2_ms = min(k2_all)
    wb, cb = st.wc_state.clone(), st.wc_count.clone()
    k2_plain_ms = timed_ms(lambda: rolling_absorb_rows(wb, cb, *block))
    k2_err = require_equal(
        "K2 B=32768",
        {"wc_state": wa, "wc_count": ca, "digest": finalize_rolling(wa, ca)},
        {"wc_state": wb, "wc_count": cb, "digest": finalize_rolling(wb, cb)})
    # the work the records need, whatever folds them (the count the fold
    # tools share)
    k2_work = k1_times.k2_bound(st.wc_count, block[3], sm_mhz)
    k2_bound = (k2_work["bound_ms"], k2_work["bound_by"])
    n_perms = k2_work["permutations"]
    n_rec = block[3]
    # K1 in mode (b): the state it changes (as for mode (a)), then the
    # records it writes (52 bytes each) and the counts
    k1b_nbytes += k2_work["records"] * 52 + block[3].nbytes
    k1b_bound = bound_ms(k1b_nbytes, B_FULL * K * K1_MIN_OPS, sm_mhz)
    phase("K1-b", batch=B_FULL, cycles=K, equal=True, ms=round(k1b_ms, 3),
          plain_ms=round(k1b_plain_ms, 3), bound_ms=round(k1b_bound[0], 3),
          bound_by=k1b_bound[1], bound_bytes=k1b_nbytes,
          records=int(n_rec.sum()), records_lane0=int(n_rec[0]),
          max_records=int(n_rec.max()), slots=K * 8)
    phase("K2", batch=B_FULL, rows=K * 8, equal=True, ms=round(k2_ms, 3),
          ms_all=",".join(f"{t:.3f}" for t in k2_all),
          plain_ms=round(k2_plain_ms, 3), bound_ms=round(k2_bound[0], 4),
          bound_by=k2_bound[1], permutations=n_perms, records=int(ca[0]))
    del st, block, wa, wb

    # -- the rolling commitment beside the memory queue (K1 + K2) ----------
    cfg_rq = dataclasses.replace(cfg_b, queue_capacity=K * 8)
    ks = make_entry_state(cfg_rq, [wl] * B_FULL, ergs=FULL_ERGS, device=dev)
    ps = clone_state(ks)
    fused_cycle.run_cycles(ks, cfg_rq, K, k_inner=K // 2)
    batched_vm.run_cycles(ps, cfg_rq, K)
    rq_err = require_equal(
        "K1 + K2 rolling with the queue B=32768",
        {**state_tensors(ks), "digest": finalize_rolling(ks.wc_state,
                                                         ks.wc_count)},
        {**state_tensors(ps), "digest": finalize_rolling(ps.wc_state,
                                                         ps.wc_count)})
    errors = int(ks.lane_error.sum())
    if errors or int(ks.wq_count.min()) == 0 or int(ks.wc_count.min()) == 0:
        raise AssertionError(f"rolling with the queue: {errors} lane_error "
                             "lanes, or no slots queued or absorbed")
    k2_err = max(k2_err, rq_err)
    phase("K1-rolling-queue", batch=B_FULL, cycles=K, k_inner=K // 2,
          equal=True, queued=int(ks.wq_count[0]),
          absorbed=int(ks.wc_count[0]), lane_errors=errors)
    del ks, ps

    # -- the memory-witness main path at full size ----------------------
    plain_rate = {}
    for mode, cfg, entry in (("a", cfg_a, entry_a), ("b", cfg_b, entry_b)):
        ps = clone_state(entry)
        ms = timed_ms(lambda: batched_vm.run_cycles(ps, cfg, PLAIN_CYCLES))
        plain_rate[mode] = B_FULL * PLAIN_CYCLES / (ms / 1e3)
        del ps

    fused_cycle.K1_LAUNCHES = 0
    fused_cycle.K2_LAUNCHES = 0
    results = {}
    for mode, cfg, entry in (("a", cfg_a, entry_a), ("b", cfg_b, entry_b)):
        st = clone_state(entry)

        def call():
            fused_cycle.run_cycles(st, cfg, K, k_inner=K)
            rewind_queues(st)

        call()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        piped_s = float("inf")
        for _ in range(SWEEPS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
            piped_s = min(piped_s, (time.perf_counter() - t0) / CALLS)
        results[mode] = (st, 2 + SWEEPS * CALLS, piped_s, sync_s)
    main_k1, main_k2 = fused_cycle.K1_LAUNCHES, fused_cycle.K2_LAUNCHES
    if main_k1 == 0 or main_k2 == 0:
        raise AssertionError(f"main path launches K1={main_k1} K2={main_k2}")

    n_ref = 8
    for mode, cfg in (("a", cfg_a), ("b", cfg_b)):
        st, n_calls, piped_s, sync_s = results[mode]
        errors = int(st.lane_error.sum())
        if errors:
            raise AssertionError(f"mode {mode}: {errors} lanes set lane_error")
        # lanes 0..7 against the plain version on the CPU, same calls
        ref_cfg = dataclasses.replace(cfg, batch=n_ref)
        ref = make_entry_state(ref_cfg, [wl] * n_ref, ergs=FULL_ERGS,
                               device="cpu")
        for _ in range(n_calls):
            batched_vm.run_cycles(ref, ref_cfg, K)
            rewind_queues(ref)
        got = {k: v.cpu() for k, v in lanes(state_tensors(st), n_ref).items()}
        require_equal(f"main path mode {mode} lanes 0..{n_ref - 1}", got,
                      state_tensors(ref))
        extra = {}
        if mode == "b":
            dig = finalize_rolling(st.wc_state, st.wc_count)
            if not bool((dig == dig[:1]).all()):
                raise AssertionError("mode b: lanes of one program disagree")
            extra["digest0"] = dig[0].cpu().numpy().view(np.uint32).tolist()
        phase(f"main-{mode}", batch=B_FULL, calls=n_calls, cycles_per_call=K,
              cycles_per_sec_pipelined=B_FULL * K / piped_s,
              cycles_per_sec_sync=B_FULL * K / sync_s,
              plain_cycles_per_sec=plain_rate[mode], lane_errors=errors,
              equal_to_plain_lanes=n_ref, **extra)

    # -- the native oracle's single-core baseline on the card's host -----
    t0 = time.time()
    base = native.run_oracle(wl, **BASELINE_RUN)
    if base["status"] != native.ST_DONE or base["run_seconds"] <= 0:
        raise AssertionError(f"native baseline: status {base['status']}")
    native_rate = base["cycles"] / base["run_seconds"]
    main_a_rate = B_FULL * K / results["a"][2]
    phase("native-baseline", cycles=base["cycles"],
          witness_records=base["witness_count"],
          run_seconds=base["run_seconds"], cycles_per_sec=native_rate,
          cpu=repr(cpu_model()), card=repr(card),
          main_a_cycles_per_sec=main_a_rate,
          vs_native=main_a_rate / native_rate,
          seconds=round(time.time() - t0, 2))
    del base
    mesh_k = mesh_phase(dev, results, {"a": entry_a, "b": entry_b})
    del results, entry_a, entry_b

    # -- K1's storage-enabled instance against plain --------------------
    for run in log_programs.RUNS:
        cfg, ks = staged_log_run(run, dev)
        ps = clone_state(ks)
        fused_cycle.run_cycles(ks, cfg, K, k_inner=40)
        batched_vm.run_cycles(ps, cfg, K)
        torch.cuda.synchronize()
        require_equal(f"K1 log/far-call run {run}", state_tensors(ks),
                      state_tensors(ps))
        # only the precompile call (its units are off) sets lane_error
        want_err = torch.zeros(log_programs.LANES, dtype=torch.bool)
        lo, hi = log_programs.lane_plan(run)[2].get("precompile_off", (0, 0))
        want_err[lo:hi] = True
        if int(ks.lq_count.sum()) == 0 \
                or not torch.equal(ks.lane_error.cpu(), want_err):
            raise AssertionError(f"run {run}: no log rows, or lane_error "
                                 f"{ks.lane_error.tolist()}")
        phase("K1-log-small", run=run, lanes=log_programs.LANES, cycles=K,
              sets=",".join(log_programs.RUNS[run]), equal=True,
              log_rows=int(ks.lq_count.sum()),
              decommits=int(ks.dq_count.sum()))

    cfg_s = storage_config(B_FULL)
    entry_s = make_entry_state(cfg_s, [assemble(STORAGE_WORKLOAD)] * B_FULL,
                               ergs=FULL_ERGS, device=dev)
    ks, ps = clone_state(entry_s), clone_state(entry_s)
    ks_ms = timed_ms(lambda: fused_cycle.cycle_chunk(ks, cfg_s, K))
    ks_plain_ms = timed_ms(lambda: batched_vm.run_cycles(ps, cfg_s, K))
    ks_err = require_equal("K1-storage B=32768", state_tensors(ks),
                           state_tensors(ps))
    del ps, entry_s
    # bench_storage times a second call on the warm state
    before = clone_state(ks)
    ks2_ms = timed_ms(lambda: fused_cycle.cycle_chunk(ks, cfg_s, K))
    errors = int(ks.lane_error.sum())
    if errors:
        raise AssertionError(f"K1-storage: {errors} lanes set lane_error")
    ks_nbytes = k1_bytes(before, ks, cfg_s)
    ks_bound = bound_ms(ks_nbytes, B_FULL * K * K1_MIN_OPS, sm_mhz)
    phase("K1-storage", batch=B_FULL, cycles=K, equal=True,
          ms_first=round(ks_ms, 3), ms=round(ks2_ms, 3),
          plain_ms=round(ks_plain_ms, 3), bound_ms=round(ks_bound[0], 3),
          bound_by=ks_bound[1], bound_bytes=ks_nbytes,
          cycles_per_sec=B_FULL * K / (ks2_ms / 1e3),
          lane_errors=errors, events=int(ks.ev_count[0]))
    del ks, before

    cfg_f, entry_f = farcall_entry(B_FARCALL, dev)
    ks, ps = clone_state(entry_f), clone_state(entry_f)
    kf_ms = timed_ms(lambda: fused_cycle.run_cycles(
        ks, cfg_f, FARCALL_CYCLES, k_inner=FARCALL_CYCLES))
    kf_plain_ms = timed_ms(lambda: batched_vm.run_cycles(ps, cfg_f,
                                                         FARCALL_CYCLES))
    kf_err = require_equal("K1-farcall B=16384", state_tensors(ks),
                           state_tensors(ps))
    # the same with the log and decommit queues on: their rows compared
    # over the whole batch
    cfg_q, entry_q = farcall_entry(B_FARCALL, dev, queues=True)
    kq, pq = entry_q, clone_state(entry_q)
    fused_cycle.run_cycles(kq, cfg_q, FARCALL_CYCLES, k_inner=FARCALL_CYCLES)
    batched_vm.run_cycles(pq, cfg_q, FARCALL_CYCLES)
    kf_err = max(kf_err, require_equal("K1-farcall with queues B=16384",
                                       state_tensors(kq), state_tensors(pq)))
    queue_rows = (int(kq.lq_count.sum()), int(kq.dq_count.sum()))
    if min(queue_rows) == 0:
        raise AssertionError(f"K1-farcall with queues: rows {queue_rows}")
    del ps, kq, pq, entry_q
    # bench_farcall times a fresh state after a warm run
    ks = clone_state(entry_f)
    kf2_ms = timed_ms(lambda: fused_cycle.run_cycles(
        ks, cfg_f, FARCALL_CYCLES, k_inner=FARCALL_CYCLES))
    errors = int(ks.lane_error.sum())
    calls = int(ks.frame_count[0]) - 1
    if errors or calls == 0:
        raise AssertionError(f"K1-farcall: {errors} lane_error lanes, "
                             f"{calls} far calls")
    # bench_farcall counts every lane-cycle; a lane that is done stops
    # counting its own cycles (monotonic_cycle_counter)
    live = int(ks.monotonic_cycle_counter.to(torch.int64).sum())
    kf_nbytes = k1_bytes(entry_f, ks, cfg_f)
    kf_bound = bound_ms(kf_nbytes, live * K1_MIN_OPS, sm_mhz)
    phase("K1-farcall", batch=B_FARCALL, cycles=FARCALL_CYCLES, equal=True,
          ms=round(kf2_ms, 3), plain_ms=round(kf_plain_ms, 3),
          bound_ms=round(kf_bound[0], 4), bound_by=kf_bound[1],
          bound_bytes=kf_nbytes,
          cycles_per_sec=B_FARCALL * FARCALL_CYCLES / (kf2_ms / 1e3),
          live_cycles_per_lane=live // B_FARCALL,
          live_cycles_per_sec=live / (kf2_ms / 1e3),
          far_calls_per_lane=calls, done_lanes=int(ks.done.sum()),
          lane_errors=errors, queued_log_decommit_rows=queue_rows)
    del ks, entry_f

    # -- the fuzz campaigns (tests/test_torch_fuzz.py's programs) ---------
    # kernel against plain, each campaign's programs cycled over B_BLOCK
    # lanes, and each distinct program's first lane against the native
    # oracle, as tests/test_torch_fuzz.py holds the plain engine
    fz_err, fz_fields = 0, {}
    fz_native, fz_native_s = 0, 0.0
    for name in ("random", "far_call"):
        cfg_z, ks = fuzz_programs.entry_state(name, B_BLOCK, dev)
        ps = clone_state(ks)
        fused_cycle.run_cycles(ks, cfg_z, fuzz_programs.MAX_CYCLES,
                               k_inner=40)
        batched_vm.run_cycles(ps, cfg_z, fuzz_programs.MAX_CYCLES)
        fz_err = max(fz_err, require_equal(f"K1 fuzz {name} B={B_BLOCK}",
                                           state_tensors(ks),
                                           state_tensors(ps)))
        errors, done = int(ks.lane_error.sum()), int(ks.done.sum())
        if errors or done != B_BLOCK:
            raise AssertionError(f"fuzz {name}: {errors} lane_error lanes, "
                                 f"{done} done")
        fz_fields[f"{name}_log_rows"] = int(ks.lq_count.sum())
        fz_fields[f"{name}_decommits"] = int(ks.dq_count.sum())
        t0 = time.perf_counter()
        _, words_z, bank, entries = fuzz_programs.campaign(name)
        want = [native.run_oracle(
            w, ergs=fuzz_programs.ERGS, max_cycles=fuzz_programs.MAX_CYCLES,
            witness_cap=fuzz_programs.MAX_CYCLES * 8, contracts=bank,
            storage_entries=list(entries)) for w in words_z]
        if any(w["status"] != native.ST_DONE for w in want):
            raise AssertionError(f"K1 fuzz {name}: oracle statuses "
                                 f"{[w['status'] for w in want]}")
        fz_native += require_oracle_equal(f"K1 fuzz {name}", ks, want,
                                          range(len(words_z)))
        fz_native_s += time.perf_counter() - t0
        del ks, ps
    kf_err = max(kf_err, fz_err)
    phase("K1-fuzz", batch=B_BLOCK, cycles=fuzz_programs.MAX_CYCLES,
          equal=True, native_equal_lanes=fz_native,
          native_seconds=round(fz_native_s, 3), **fz_fields)

    # -- K1's precompile instance against plain -------------------------
    pp_lanes = list(block_programs.PRECOMPILE_LANES) + [
        (e, src) for e, src, *_ in block_programs.precompile_mix(17, seed=3)]
    cfg_ps = precompile_small_config(len(pp_lanes))
    pp_words = [assemble(src) for _, src in pp_lanes]
    pp_entries = [e for e, _ in pp_lanes]
    ks = make_entry_state(cfg_ps, pp_words, ergs=1 << 20,
                          entry_address=pp_entries, device=dev)
    ps = clone_state(ks)
    fused_cycle.run_cycles(ks, cfg_ps, 96, k_inner=8)
    batched_vm.run_cycles(ps, cfg_ps, 96)
    torch.cuda.synchronize()
    kps_err = require_equal("K1 precompile programs", state_tensors(ks),
                            state_tensors(ps))
    want, pp_native_s = oracle_lanes(pp_words, pp_entries, cfg_ps, 96,
                                     range(len(pp_lanes)))
    pp_full = require_oracle_equal("K1 precompile programs", ks, want,
                                   range(len(pp_lanes)))
    if pp_full != len(pp_lanes):
        raise AssertionError(f"K1 precompile programs: {pp_full} of "
                             f"{len(pp_lanes)} lanes compared in full")
    phase("K1-precompile-small", lanes=len(pp_lanes), cycles=96, k_inner=8,
          equal=True, native_equal_lanes=pp_full,
          native_max_cycles_lanes=sum(
              w["status"] == native.ST_MAX_CYCLES for w in want),
          native_seconds=round(pp_native_s, 3),
          pq_rows=int(ks.pq_count.sum()),
          pq_blocks=int(ks.pq_blocks[0]),
          lane_errors=int(ks.lane_error.sum()))
    del ks, ps

    cfg_p = precompile_storage_config(B_FULL)
    mix = block_programs.precompile_mix(B_FULL)
    cache = {}
    entry_p = make_entry_state(
        cfg_p, [cache.setdefault(src, assemble(src)) for _, src, *_ in mix],
        ergs=FULL_ERGS, entry_address=[e for e, *_ in mix], device=dev)
    pq_block = fused_cycle.new_pq_block(cfg_p, K, dev)
    warm = clone_state(entry_p)      # the splice's temporaries allocated
    fused_cycle.cycle_chunk(warm, cfg_p, K, pq_block=pq_block)
    del warm
    ks, ps = clone_state(entry_p), clone_state(entry_p)
    kp_ms = timed_ms(lambda: fused_cycle.cycle_chunk(ks, cfg_p, K,
                                                     pq_block=pq_block))
    # the splice alone, again from the same scratch rows, against its
    # plain version (pq-splice)
    splices = {"precompile": splice_check(cfg_p, entry_p, pq_block, sm_mhz)}
    kp_plain_ms = timed_ms(lambda: batched_vm.run_cycles(ps, cfg_p, K))
    kp_err = require_equal("K1-precompile B=32768", state_tensors(ks),
                           state_tensors(ps))
    del ps
    errors = int(ks.lane_error.sum())
    if errors:
        raise AssertionError(f"K1-precompile: {errors} lanes set lane_error")
    # the units' work in this call: a keccak-f per keccak call (64-byte
    # input, one block), `rounds` compressions per sha256 call
    calls = (pq_block[3] != 0).sum(0).cpu().numpy()
    sha_rounds = np.array([r for *_, r in mix])
    n_perms = int(calls[sha_rounds == 0].sum())
    n_comps = int((calls * sha_rounds).sum())
    kp_nbytes = k1_bytes(entry_p, ks, cfg_p)
    kp_bound = bound_ms(kp_nbytes, B_FULL * K * K1_MIN_OPS
                        + n_perms * KECCAK_OPS + n_comps * SHA256_OPS, sm_mhz)
    units = units_check(cfg_p, ks, mix, sm_mhz)
    phase("K1-precompile", batch=B_FULL, cycles=K, equal=True,
          units_ms=round(units["ms"], 4), units_ms_events=units["ms_events"],
          units_bound_ms=round(units["bound_ms"], 4),
          units_plain_ms=round(units["plain_ms"], 3),
          units_plain_lanes=units["plain_lanes"],
          units_keccak_f=units["keccak_f"],
          units_sha256_compressions=units["sha256_compressions"],
          ms=round(kp_ms, 3), splice_ms=round(splices["precompile"]["ms"], 4),
          plain_ms=round(kp_plain_ms, 3),
          bound_ms=round(kp_bound[0], 4), bound_by=kp_bound[1],
          bound_bytes=kp_nbytes, keccak_calls=n_perms,
          sha256_compressions=n_comps, pq_rows=int(ks.pq_count.sum()),
          pq_blocks=int(ks.pq_blocks[0]), lane_errors=errors,
          cycles_per_sec=B_FULL * K / (kp_ms / 1e3))
    del ks, entry_p, pq_block

    # -- K1's ecrecover instance against plain --------------------------
    ec_lanes = ec_programs.EC_LANES + [
        (e, src) for e, src, *_ in ec_programs.ecrecover_mix(17, seed=3)]
    cfg_es = ecrecover_small_config(len(ec_lanes))
    ec_words = [assemble(src) for _, src in ec_lanes]
    ec_entries = [e for e, _ in ec_lanes]
    ks = make_entry_state(cfg_es, ec_words, ergs=1 << 20,
                          entry_address=ec_entries, device=dev)
    ps = clone_state(ks)
    fused_cycle.run_cycles(ks, cfg_es, 96, k_inner=8)
    batched_vm.run_cycles(ps, cfg_es, 96)
    torch.cuda.synchronize()
    kes_err = require_equal("K1 ecrecover programs", state_tensors(ks),
                            state_tensors(ps))
    # only the program whose output window passes the frame sets lane_error
    if int(ks.lane_error.sum()) != 1 or int(ks.pq_count.sum()) == 0:
        raise AssertionError(f"K1-ecrecover-small: lane_error "
                             f"{ks.lane_error.tolist()}")
    want, ec_native_s = oracle_lanes(ec_words, ec_entries, cfg_es, 96,
                                     EC_ORACLE_LANES)
    ec_full = require_oracle_equal("K1 ecrecover programs", ks, want,
                                   EC_ORACLE_LANES)
    phase("K1-ecrecover-small", lanes=len(ec_lanes), cycles=96, k_inner=8,
          equal=True, native_equal_lanes=ec_full,
          native_status_only_lanes=len(EC_ORACLE_LANES) - ec_full,
          native_seconds=round(ec_native_s, 3),
          pq_rows=int(ks.pq_count.sum()),
          pq_blocks=int(ks.pq_blocks[0]),
          lane_errors=int(ks.lane_error.sum()))
    del ks, ps

    # every lane a signed transfer of block-ecrecover's mix (its recovery in
    # cycle 9), the mix's programs cycled over the batch
    ec_mix = ec_programs.ecrecover_mix(2 * B_BLOCK)
    ec_txs = as_txs(ec_mix)
    cfg_e = precompile_storage_config(B_FULL, ecrecover=True)
    entry_e = make_entry_state(
        cfg_e, [ec_txs[i % len(ec_txs)].program for i in range(B_FULL)],
        ergs=FULL_ERGS, entry_address=ec_programs.EC, device=dev)
    pq_block = fused_cycle.new_pq_block(cfg_e, K, dev)
    warm = clone_state(entry_e)       # loads the module, warms the splice
    fused_cycle.cycle_chunk(warm, cfg_e, K, pq_block=pq_block)
    del warm
    ks, ps = clone_state(entry_e), clone_state(entry_e)
    ke_first_ms = timed_ms(lambda: fused_cycle.cycle_chunk(
        ks, cfg_e, K, pq_block=pq_block))
    ke_plain_ms = timed_ms(lambda: batched_vm.run_cycles(ps, cfg_e, K))
    ke_err = require_equal("K1-ecrecover B=32768", state_tensors(ks),
                           state_tensors(ps))
    del ps
    errors = int(ks.lane_error.sum())
    n_ec = int((ks.pq_count == 6).sum())   # lanes with one call's 4 + 2 rows
    if errors or n_ec != B_FULL:
        raise AssertionError(f"K1-ecrecover: {errors} lane_error lanes, "
                             f"{n_ec} recoveries")
    ke_nbytes = k1_bytes(entry_e, ks, cfg_e)
    del ks
    splices["ecrecover"] = splice_check(cfg_e, entry_e, pq_block, sm_mhz)
    splices["overflow"] = splice_check(cfg_e, entry_e, pq_block, sm_mhz,
                                       overflow=True)
    ke_times = []
    for _ in range(2):             # again from the entry state, timed
        kt = clone_state(entry_e)
        ke_times.append(timed_ms(lambda: fused_cycle.cycle_chunk(
            kt, cfg_e, K, pq_block=pq_block)))
        del kt
    ke_ms = min(ke_times)
    ec_sigs = [ec_mix[i % len(ec_mix)][4] for i in range(B_FULL)]
    ke_bound = bound_ms(ke_nbytes, B_FULL * K * K1_MIN_OPS
                        + ecrecover_ops(ec_sigs), sm_mhz)
    ke_ladder = bound_ms(ke_nbytes, B_FULL * K * K1_MIN_OPS
                         + ladder_ops(ec_sigs), sm_mhz)
    unit = unit_check(ec_sigs, dev)
    counts = ecrecover_counts(*ec_sigs[0])
    phase("K1-ecrecover", batch=B_FULL, cycles=K, equal=True,
          ms_first=round(ke_first_ms, 3),
          ms=";".join(f"{t:.3f}" for t in ke_times),
          plain_ms=round(ke_plain_ms, 3), bound_ms=round(ke_bound[0], 4),
          bound_by=ke_bound[1], bound_ms_ladder=round(ke_ladder[0], 4),
          field_ops_a_recovery=sum(counts[k] for k in ("mp", "sp", "mn",
                                                        "sn")),
          ladder_modmuls_a_recovery=ladder_modmuls(
              ec_sigs[0][0], ec_sigs[0][2], ec_sigs[0][3]),
          **unit, bound_bytes=ke_nbytes, recoveries=n_ec,
          ecrecovers_per_sec=n_ec / (ke_ms / 1e3), lane_errors=errors,
          cycles_per_sec=B_FULL * K / (ke_ms / 1e3))
    del entry_e, pq_block
    phase("pq-splice", equal=True, card=json.dumps(card), **{
        f"{tag}_{k}": v for tag, fields in splices.items()
        for k, v in fields.items()})
    splice = splices["precompile"]

    # -- K3 against plain ------------------------------------------------
    gen = torch.Generator().manual_seed(3)
    k3_err, k3_ms, k3_plain_ms = 0, None, None

    def k3_in_place(states, iters):
        """K3 in place on a copy of `states`: the mean of K3_REPS launches
        back to back (one launch's event time also holds the host's launch
        work, as long as the kernel at 131072 x 1; the copying entry point
        a clone), and the copy after one launch."""
        work = states.clone()
        keccak.keccak_f1600_(work, iters)                    # warm
        ms = timed_ms(lambda: [keccak.keccak_f1600_(work, iters)
                               for _ in range(K3_REPS)]) / K3_REPS
        work.copy_(states)
        keccak.keccak_f1600_(work, iters)
        return ms, work

    for n, iters in K3_CHECKS:
        states = torch.randint(-2**31, 2**31 - 1, (n, 25, 2), generator=gen,
                               dtype=torch.int32).to(dev)
        ms, got = k3_in_place(states, iters)
        box = {}
        plain_ms = timed_ms(lambda: box.setdefault(
            "p", keccak.keccak_f1600_plain(states, iters)))
        k3_err = max(k3_err, require_equal(
            f"K3 N={n} iters={iters}", {"states": got},
            {"states": box["p"]}))
        if iters == 1:
            k3_n, k3_ms, k3_plain_ms = n, ms, plain_ms
    k3_bound = bound_ms(2 * k3_n * 200, k3_n * KECCAK_OPS, sm_mhz)
    rates, bench_plain_ms = {}, None
    for name, n, iters in K3_BENCH:
        states = torch.ones((n, 25, 2), dtype=torch.int32, device=dev)
        ms, got = k3_in_place(states, iters)
        box = {}
        if name == K3_PLAIN_BENCH:
            bench_plain_ms = timed_ms(lambda: box.setdefault(
                "p", keccak.keccak_f1600_plain(states, iters)))
            k3_err = max(k3_err, require_equal(
                f"K3 {name}", {"states": got}, {"states": box["p"]}))
        rates[name] = (ms, n * iters / (ms / 1e3),
                       bound_ms(2 * n * 200, n * iters * KECCAK_OPS,
                                sm_mhz)[0])
        del box, got
    # one permutation's latency on one thread (N = 1, chained), beside its
    # bound: the permutation's SASS at one instruction a cycle; and the
    # SASS a keccak round of K3, K2 and the sponge (cuobjdump)
    listing = k1_times.read_sass(lib_path)
    sass_round = k1_times.keccak_round_sass(listing)
    one = torch.zeros((1, 25, 2), dtype=torch.int32, device=dev)
    keccak.keccak_f1600_(one, 16)
    n1_us = timed_ms(lambda: keccak.keccak_f1600_(one, SERIAL_ITERS)) \
        * 1e3 / SERIAL_ITERS
    k3_sass = sass_round["k3_kernel"]
    sass_fields = {f"sass_round_{name[:-7]}": (
        "not measured" if v is None else
        f"{v[0]:.1f} all, {v[1]:.1f} logic ({v[2]} a loop)")
        for name, v in sass_round.items()}
    phase("K3", equal=True, checked=K3_CHECKS, n_x1=k3_n,
          ms_x1=round(k3_ms, 4), plain_ms_x1=round(k3_plain_ms, 3),
          bound_ms_x1=round(k3_bound[0], 4), bound_by=k3_bound[1],
          n1_latency_us=round(n1_us, 4),
          n1_bound_us=("not measured" if k3_sass is None
                       else round(k3_sass[0] * 24 / sm_mhz, 4)),
          **sass_fields,
          **{f"{k}_ms": round(v[0], 3) for k, v in rates.items()},
          **{f"{k}_perms_per_sec": v[1] for k, v in rates.items()},
          **{f"{k}_bound_ms": round(v[2], 3) for k, v in rates.items()},
          **{f"{K3_PLAIN_BENCH}_plain_ms": round(bench_plain_ms, 3)})

    # -- the tool probes P1-P7 ------------------------------------------
    probes = probe_phases(dev, sm_mhz, listing, rates["bench_keccak"][0],
                          n1_us)
    fold_tools_phase()

    # -- the witness wave at full size: the log family's main path ------
    cfg_w = wave_config(B_WAVE)
    wave_words = wave_programs(B_WAVE)
    # its first segment, K1 against plain over the whole batch: the memory
    # and log queue rows the wave drains, every field
    ks = make_entry_state(cfg_w, wave_words, ergs=FULL_ERGS, device=dev)
    ps = clone_state(ks)
    kw_ms = timed_ms(lambda: fused_cycle.run_cycles(
        ks, cfg_w, WAVE_SEGMENT, k_inner=WAVE_SEGMENT))
    kw_plain_ms = timed_ms(lambda: batched_vm.run_cycles(ps, cfg_w,
                                                         WAVE_SEGMENT))
    kw_err = require_equal("K1 wave segment B=4096", state_tensors(ks),
                           state_tensors(ps))
    if int(ks.lq_count.sum()) == 0:
        raise AssertionError("K1 wave segment: no log rows")
    phase("K1-wave-segment", batch=B_WAVE, cycles=WAVE_SEGMENT, equal=True,
          ms=round(kw_ms, 3), plain_ms=round(kw_plain_ms, 3),
          log_rows=int(ks.lq_count.sum()), memory_rows=int(ks.wq_count.sum()),
          done_lanes=int(ks.done.sum()))
    del ks, ps

    st = make_entry_state(cfg_w, wave_words, ergs=FULL_ERGS, device=dev)
    torch.cuda.synchronize()
    fused_cycle.K1_LAUNCHES = 0
    keccak.K3_LAUNCHES = 0
    times = {}
    t0 = time.perf_counter()
    streams = run_wave(st, cfg_w, WAVE_SEGMENT, WAVE_FRACS, times=times)
    out = wave_commitments(streams, dev, times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wave_k1, wave_k3 = fused_cycle.K1_LAUNCHES, keccak.K3_LAUNCHES
    if wave_k1 == 0 or wave_k3 == 0:
        raise AssertionError(f"wave launches K1={wave_k1} K3={wave_k3}")
    done, errors = int(st.done.sum()), int(st.lane_error.sum())
    if done != B_WAVE or errors:
        raise AssertionError(f"wave: {done} lanes done, {errors} lane_error")
    # lanes 0..7 against the plain versions on the CPU
    ref_cfg = wave_config(n_ref)
    ref = make_entry_state(ref_cfg, wave_words[:n_ref], ergs=FULL_ERGS,
                           device="cpu")
    ref_out = wave_commitments(run_wave(ref, ref_cfg, WAVE_SEGMENT,
                                        WAVE_FRACS), "cpu")
    for name in ("memory", "log"):
        if out["digests"][name][:n_ref] != ref_out["digests"][name]:
            raise AssertionError(f"wave: {name} digests of lanes 0..7 differ")
    if out["products"][:n_ref] != ref_out["products"]:
        raise AssertionError("wave: grand products of lanes 0..7 differ")
    log_records = sum(s.shape[0] for s in streams["log"])
    phase("witness-wave", batch=B_WAVE, txs=B_WAVE, segment=WAVE_SEGMENT,
          equal_to_plain_lanes=n_ref, lane_errors=errors,
          txs_per_sec=B_WAVE / wall, wall_s=round(wall, 4),
          log_records=log_records,
          memory_records=sum(s.shape[0] for s in streams["memory"]),
          k1_launches=wave_k1, k3_launches=wave_k3,
          **{f"{k}_s": round(v, 4) for k, v in times.items()},
          log_fold=out["folds"]["log"].hex()[:16],
          block_product=out["block_product"])

    # the same wave again under torch.profiler: the device's busy share
    st = make_entry_state(cfg_w, wave_words, ergs=FULL_ERGS, device=dev)
    phase("wave-profile", **profiled(lambda: wave_commitments(
        run_wave(st, cfg_w, WAVE_SEGMENT, WAVE_FRACS), dev)))

    # -- the block pipeline: execute_block, the product path ------------
    blocks, commits = {}, {}
    for tag, mix, unit in (("block-tiny", "tiny", None),
                           ("block-precompile", "precompile",
                            "K1_precompile"),
                           ("block-ecrecover", "ecrecover", "K1_ecrecover")):
        cfg_k = block_config(B_BLOCK, precompile=unit is not None,
                             ecrecover=mix == "ecrecover")
        knobs = dict(BLOCK_KNOBS)
        if unit:
            knobs["drain_compact_frac"] = dict(knobs["drain_compact_frac"],
                                               precompile=0.25)
        txs = ec_txs if mix == "ecrecover" else mix_txs(mix, 2 * B_BLOCK)
        blk, wall, launches, prof = block_phase(tag, cfg_k, txs, knobs, dev)
        need = ("K1", "K3", "sponge") + ((unit, "splice") if unit else ())
        if any(launches[k] == 0 for k in need):
            raise AssertionError(f"{tag}: launches {launches}")
        n_check = EC_CHECK_TXS if mix == "ecrecover" else CHECK_TXS
        check_on_cpu(tag, cfg_k, txs, knobs, blk, n_check)
        blocks[tag] = launches
        commits[tag] = commit_phase(cfg_k, blk, dev)
        extra = {}
        if unit:
            extra["precompile_records"] = sum(
                r.streams["precompile"].shape[0] for r in blk.txs)
        if mix == "ecrecover":
            extra["rejected_txs"] = sum(
                not r.net_states["final_storage"] for r in blk.txs)
        phase(tag, batch=B_BLOCK, equal_to_cpu_txs=n_check,
              **block_fields(blk, wall, len(txs)),
              **{f"launches_{k}": v for k, v in launches.items()},
              **prof, **extra, log_fold=blk.commitments["log"].hex()[:16],
              block_product=blk.block_log_product)
        del blk

    cfg_r = block_config(B_BLOCK, chunk=REALISTIC_CHUNK)
    knobs_r = dict(BLOCK_KNOBS, chunk=REALISTIC_CHUNK)
    txs = mix_txs("realistic", REALISTIC_TXS)
    blk, wall, launches_r, prof = block_phase("block-realistic", cfg_r, txs,
                                              knobs_r, dev, warm=False)
    mean_cycles = float(np.mean([r.cycles for r in blk.txs]))
    # engine-ideal (bench.py:675-708): the same config, one long tx per
    # lane, pipelined chunk * tail_mult-cycle calls with a queue rewind
    st = make_entry_state(
        cfg_r, [assemble(block_programs.realistic_program(1 << 20))] * B_BLOCK,
        ergs=FULL_ERGS, device=dev)
    n_call = REALISTIC_CHUNK * TAIL_MULT

    def estep():
        fused_cycle.run_cycles(st, cfg_r, n_call,
                               k_inner=knobs_r["k_inner"])
        rewind_queues(st)

    estep()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(4):
            estep()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 4)
    engine_rate = B_BLOCK * n_call / best
    phase("block-realistic", batch=B_BLOCK, chunk=REALISTIC_CHUNK,
          **block_fields(blk, wall, len(txs)),
          **{f"launches_{k}": v for k, v in launches_r.items()}, **prof,
          engine_cycles_per_sec=engine_rate,
          vs_engine_ideal=round((len(txs) / wall)
                                / (engine_rate / mean_cycles), 4))
    commits["block-realistic"] = commit_phase(cfg_r, blk, dev)
    memory_streams = [r.streams["memory"] for r in blk.txs]
    log_records = np.concatenate([r.streams["log"] for r in blk.txs])
    del blk, st
    phase("block-commit", **{f"{tag[6:]}_{k}": v for tag, fields
                             in commits.items() for k, v in fields.items()})
    objects = objects_phase(dev)
    sq_k3 = sorted_queue_phase(dev, wave_words)
    boot_k1 = net_states_phase(dev)
    seg_k1, seg_err, resume = segmented_phase(dev)
    checkpoint_phase(dev, resume)
    del resume
    trace_k1 = trace_phase(dev)
    dryrun_phase(dev)
    diff_k1 = differential_phase(dev)
    hash_k3 = batched_hashes_phase(dev)
    sponge = sponge_phase(dev, sm_mhz, memory_streams, log_records)
    del memory_streams, log_records
    # block-tiny's commitments: one sponge launch for every family's
    # digests, one for the folds, one K3 launch for the fingerprints
    tiny = blocks["block-tiny"]
    n_families = len(packed.queue_families(block_config(B_BLOCK)))
    if tiny["sponge"] + tiny["K3"] > 2 * n_families + 1:
        raise AssertionError(f"block-tiny: sponge and K3 launches {tiny}")

    phase("launches", K1=main_k1 + wave_k1, K1_main=main_k1,
          K1_wave=wave_k1, K2=main_k2, K3=wave_k3,
          K1_block_tiny=blocks["block-tiny"]["K1"],
          K3_block_tiny=blocks["block-tiny"]["K3"],
          K1_precompile_block=blocks["block-precompile"]["K1_precompile"],
          K3_block_precompile=blocks["block-precompile"]["K3"],
          K1_ecrecover=blocks["block-ecrecover"]["K1_ecrecover"],
          splice_block_precompile=blocks["block-precompile"]["splice"],
          splice_block_ecrecover=blocks["block-ecrecover"]["splice"],
          K3_block_ecrecover=blocks["block-ecrecover"]["K3"],
          K3_block_realistic=launches_r["K3"],
          K3_sorted_queue=sq_k3, K1_block_objects=objects["K1"],
          K3_block_objects=objects["K3"],
          sponge_block_objects=objects["sponge"], K1_bootloader=boot_k1,
          K1_segmented_block=seg_k1, K1_debug_trace=trace_k1,
          K1_mesh=mesh_k["K1"], K2_mesh=mesh_k["K2"],
          sponge_mesh=mesh_k["sponge"], K1_differential=diff_k1,
          K3_batched_hashes=hash_k3,
          **{f"sponge_{tag.replace('-', '_')}": v["sponge"]
             for tag, v in list(blocks.items())
             + [("block-realistic", launches_r)]})
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "era_zk_evm_tpu" or m.startswith("era_zk_evm_tpu.")]
    if bad:
        raise AssertionError(f"the port imported {bad}")
    phase("total", seconds=round(time.time() - t_start, 1))

    def kernel(name, source, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda",
                "source": ", ".join(f"era_zk_evm_tpu_torch/csrc/{f}"
                                    for f in source.split()),
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    k1_src = "era_zk_evm_tpu/models/fused_cycle.py:2794"
    print(card)
    print(json.dumps({"kernels": [
        kernel("K1 cycle_kernel, slice (a)", "cycle_kernel.cu", k1_src,
               main_k1 + mesh_k["K1"], k1_err, k1_ms, k1_plain_ms, k1_bound),
        kernel("K1 cycle_kernel, slices (b) LOG and (c) FAR_CALL",
               "cycle_kernel.cu", k1_src, blocks["block-tiny"]["K1"],
               max(ks_err, kf_err, kw_err, seg_err),
               ks2_ms, ks_plain_ms, ks_bound),
        kernel("K1 cycle_kernel, slice (d) keccak256/sha256 precompiles",
               "cycle_kernel.cu", "era_zk_evm_tpu/models/fused_cycle.py:2794"
               " (precompile unit :1395-1600)",
               blocks["block-precompile"]["K1_precompile"],
               max(kps_err, kp_err), kp_ms, kp_plain_ms, kp_bound),
        kernel("K1 cycle_kernel, slice (e) ecrecover",
               "cycle_kernel_ec.cu cycle_kernel.cu secp256k1.cuh",
               "era_zk_evm_tpu/models/fused_cycle.py:2794 (ec_first_blk "
               ":2863-2894, detour _run_cycles_fused_ec :3752)",
               blocks["block-ecrecover"]["K1_ecrecover"],
               max(kes_err, ke_err), ke_ms, ke_plain_ms, ke_bound),
        kernel("K1 precompile units alone (keccak256/sha256)",
               "cycle_kernel_ec.cu cycle_kernel.cu keccak.cuh sha256.cuh",
               "era_zk_evm_tpu/models/fused_cycle.py:1395-1600 (the "
               "precompile unit of _build_kernel :2794)", units["launches"],
               units["err"], units["ms"], units["plain_ms"],
               (units["bound_ms"], units["bound_by"])),
        kernel("pq_splice round-witness splice", "pq_splice.cu common.cuh",
               "era_zk_evm_tpu/models/fused_cycle.py:3529-3588 (the "
               "round-witness splice in _run_chunk, after K1's launch)",
               blocks["block-precompile"]["splice"]
               + blocks["block-ecrecover"]["splice"],
               max(s["err"] for s in splices.values()), splice["ms"],
               splice["plain_ms"], (splice["bound_ms"], splice["bound_by"])),
        kernel("K2 rolling_fold", "rolling_fold.cu",
               "era_zk_evm_tpu/models/fused_cycle.py:3205",
               main_k2 + mesh_k["K2"], k2_err, k2_ms, k2_plain_ms, k2_bound),
        kernel("K3/K4 keccak_f", "keccak_f.cu",
               "era_zk_evm_tpu/ops/keccak.py:292, era_zk_evm_tpu/ops/"
               "keccak.py:371", blocks["block-tiny"]["K3"] + sq_k3 + hash_k3,
               k3_err,
               k3_ms,
               k3_plain_ms,
               k3_bound),
        kernel("K3S keccak256 ragged sponge", "keccak_sponge.cu keccak.cuh",
               "era_zk_evm_tpu/ops/keccak.py:292, :371 (K3/K4) as driven by "
               "era_zk_evm_tpu/witness/packed.py:304 _absorb_ragged",
               blocks["block-tiny"]["sponge"] + mesh_k["sponge"], *sponge),
    ] + [kernel(f"{p} {name}", source, replaces, *probes[p])
         for p, name, source, replaces in (
        ("P1", "keccak_rows2d", "probe_keccak.cu keccak.cuh",
         "tools/probe_keccak.py:68"),
        ("P2", "keccak_bitslice", "probe_keccak.cu",
         "tools/probe_keccak.py:200"),
        ("P3", "alu_chain (andnot)", "probe_rate.cu",
         "tools/probe_keccak.py:274"),
        ("P4", "round_chain", "probe_rate.cu keccak.cuh",
         "tools/probe_keccak.py:324"),
        ("P5", "keccak_bitslice_fused", "probe_keccak.cu",
         "tools/probe_keccak.py:361"),
        ("P6", "uniform_gather", "probe_uniform.cu",
         "tools/probe_mosaic_uniform.py:59 (kernel :32)"),
        ("P7", "fold (variant two)", "bisect_fold.cu",
         "tools/bisect_fold.py:30"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
