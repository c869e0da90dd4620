#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`era_zk_evm_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:
  device        a CUDA card is required; prints its name and power limit;
  build         compiles K1, K2 and K3 from the sources in this tree;
  K1-small      K1 against its plain torch version on the family programs
                (both memory-witness modes), every state field equal;
  K1            WORKLOAD at B = 32768, one 128-cycle call, kernel vs plain;
  K2            the rolling fold at B = 32768, kernel vs plain;
  main-a/main-b the memory-witness main path at full size (bench geometry,
                B = 32768, WORKLOAD): 8 chained 128-cycle calls with a queue
                rewind between them, both modes; lanes 0..7 equal to a plain
                CPU run of the same calls;
  K1-log-small  K1's storage-enabled instance (LOG family, FAR_CALL, log
                and decommit queues) against plain on the LOG and far-call
                program sets, 2 x 16 lanes, with their contracts;
  K1-storage    bench_storage's geometry, B = 32768, STORAGE_WORKLOAD: one
                128-cycle call kernel vs plain over the whole batch, then a
                second call timed;
  K1-farcall    bench_farcall's geometry, B = 16384, caller and callee with
                storage and code bank populated: 144 cycles kernel vs plain,
                again with the log and decommit queues on;
  K3            chained keccak-f against plain at N = 131072 x 1 and
                65536 x 4; times at bench_keccak's and
                bench_keccak_u32pair's shapes;
  P1 ... P7     the tool probes (era_zk_evm_tpu_torch/tools/): each kernel
                against its plain version on the card, small and at the
                tools' shapes where the plain version is quick; then the
                tools' entry points (`main`) with the launch counts, and
                CUDA-event times at the JAX tools' default shapes (P1
                131072 x 128, tile 2048; P2 / P5 G8 = 128 and 4096; P3 8
                rows, inner 512, iters 65536 on 132 x 2048 columns, with
                its loop's SASS instructions a step; P4 4096 rounds; P6 W =
                TB = 256 and TB = 32768, REPS 512, the tool's index and a
                random one, in the tool's batch-last arena and in K1's
                lane-major one; P7 B = 32768, 16 slots, every variant);
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
                chunks of 8 cycles, every field;
  K1-precompile bench_storage's geometry with the units on, B = 32768, the
                precompile mix: one 128-cycle call kernel vs plain over the
                whole batch, timed, with its bound;
  K1-ecrecover-small  K1's ecrecover instance (the secp256k1 unit in the
                cycle, two round-witness out rows) against plain on the
                ecrecover test programs and the signed-transfer mix, chunks
                of 8 cycles, every field;
  K1-ecrecover  the same geometry with ecrecover on, B = 32768, every lane a
                signed transfer whose recovery falls in cycle 9: one
                128-cycle call kernel vs plain over the whole batch, then
                two more from the same entry state timed, with its bound;
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
  launches      K1 (each instance), K2 and K3 launched on their main paths.
The card's name and power limit come on a line of their own, the kernels'
JSON record on the line before the last, and the last line is the device
record.  The script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.block import TxSpec, execute_block
from era_zk_evm_tpu_torch.config import (
    BATCH_LAST_FIELDS, VmConfig, precompile_queue_slots,
)
from era_zk_evm_tpu_torch.isa import params
from era_zk_evm_tpu_torch.isa.abi import code_hash_for_bytecode
from era_zk_evm_tpu_torch.models import batched_vm, fused_cycle
from era_zk_evm_tpu_torch.models.spill import rewind_queues
from era_zk_evm_tpu_torch.models.state import (
    FIELD_NAMES, clone_state, make_entry_state, populate_code_bank,
    populate_storage,
)
from era_zk_evm_tpu_torch.ops import keccak, secp256k1
from era_zk_evm_tpu_torch.testing import (
    block_programs, ec_programs, log_programs,
)
from era_zk_evm_tpu_torch.testing.programs import (
    FAMILY_PROGRAMS, FARCALL_CALLEE_ADDRESS, STORAGE_WORKLOAD, WORKLOAD,
    assemble, farcall_callee, farcall_caller, tiny_mix_program,
)
from era_zk_evm_tpu_torch.testing.wave import run_wave, wave_commitments
from era_zk_evm_tpu_torch.tools import bisect_fold, probe_keccak, probe_uniform
from era_zk_evm_tpu_torch.witness.rolling import (
    finalize_rolling, rolling_absorb,
)

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
#: K3 against plain at (states, iters); K3 timed at bench.py's keccak shapes
K3_CHECKS = ((131072, 1), (65536, 4))
K3_BENCH = (("bench_keccak", 65536, 2048),
            ("bench_keccak_u32pair", 131072, 128))
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
INT32_LANES = 132 * 64                        # SMs x int32 lanes per SM
#: a lower count of the int32 operations of one lane-cycle of K1: fetching
#: and decoding an instruction and the 256-bit add and sub every cycle
#: computes take more than this
K1_MIN_OPS = 64
#: int32 operations of one keccak-f[1600], counting 3-input logic ops as
#: one: per round theta 80 (column parities 20, their rotations 10, the
#: update folded into one 3-input XOR per word 50), rho 48, chi 50, iota 2
#: (24 rounds)
KECCAK_OPS = 24 * 180
#: int32 operations of one sha256 compression (csrc/sha256.cuh), counting a
#: rotate and a 3-input logic op as one: per round 17 (two Sigma at 4, ch
#: and maj at 1, 7 adds), per scheduled word 11, and the 8 final adds
SHA256_OPS = 64 * 17 + 48 * 11 + 8
#: int32 operations of one 256-bit modular multiplication, a lower count:
#: 64 limb products at 4 each (multiply low and high, two carry-adds), the
#: fold of the high half by 2**32 + 977 (16 products) and a final compare
#: and subtraction (16)
MODMUL_OPS = 64 * 4 + 16 * 4 + 16
B_BLOCK, TAIL_MULT, CHECK_TXS, CHECK_BATCH = 4096, 4, 256, 64
EC_CHECK_TXS = 64                 # block-ecrecover's CPU check: one wave
#: bench_block's knobs (bench.py:653-660) at its tiny-mix chunk
BLOCK_KNOBS = dict(chunk=64, k_inner=64, refill_frac=0.25, order="cost_desc",
                   tail_chunk_mult=TAIL_MULT, adaptive_chunk=True,
                   drain_compact_frac={"memory": 0.125, "log": 0.5})
#: bench_block's realistic mix runs 4 * 4096 txs; cut to half so that the
#: phase (a timed and a profiled run) stays near a minute on the card
REALISTIC_CHUNK, REALISTIC_TXS = 128, 2 * 4096
SECTOR = 32                                   # bytes of one DRAM sector
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
P6_W, P6_TBS, P6_REPS = 256, (256, 32768), 512
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
    """The first n lanes of every field (batch-last fields on their last
    axis)."""
    return {k: (v[..., :n] if k in BATCH_LAST_FIELDS else v[:n])
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


def pow_modmuls(e: int) -> int:
    """Multiplications of x ** e by square-and-multiply from x."""
    return e.bit_length() - 1 + e.bit_count() - 1


def ecrecover_modmuls(digest: int, r: int, s: int) -> int:
    """Modular multiplications that one recovery of a valid signature needs
    in the kernel's own algorithm (csrc/secp256k1.cuh), at its least: r^3
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


def ecrecover_ops(signatures) -> int:
    """int32 operations of the recoveries of `signatures` ((digest, v, r,
    s) each): their multiplications and the keccak-f of each public key."""
    muls = {}
    total = 0
    for digest, _, r, s in signatures:
        key = (digest, r, s)
        if key not in muls:
            muls[key] = ecrecover_modmuls(digest, r, s)
        total += muls[key] * MODMUL_OPS + KECCAK_OPS
    return total


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
    is not counted, so every kernel moves at least this much."""
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
    ops = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t in ops) / 1e6
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(ops, key=lambda kv: -kv[1])[:5]
    return {"profiled_wall_s": round(wall, 4),
            "device_busy_s": round(busy, 4),
            "idle_share": round(1 - busy / wall, 4),
            "top": ";".join(f"{k[:40]}:{t / 1e3:.2f}ms" for k, t in top)}


def block_phase(tag: str, config: VmConfig, txs: list, knobs: dict, dev,
                warm: bool = True) -> tuple:
    """execute_block on the card: a warm run (if asked), a timed run with
    the launch counts set to 0 just before it, and a profiled run.  Returns
    (result, wall seconds, launches, profile)."""
    if warm:
        execute_block(config, txs, device=dev, **knobs)
    torch.cuda.synchronize()
    fused_cycle.K1_LAUNCHES = fused_cycle.K1_PRECOMPILE_LAUNCHES = 0
    fused_cycle.K1_ECRECOVER_LAUNCHES = keccak.K3_LAUNCHES = 0
    t0 = time.perf_counter()
    blk = execute_block(config, txs, device=dev, **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": fused_cycle.K1_LAUNCHES,
                "K1_precompile": fused_cycle.K1_PRECOMPILE_LAUNCHES,
                "K1_ecrecover": fused_cycle.K1_ECRECOVER_LAUNCHES,
                "K3": keccak.K3_LAUNCHES}
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


def p3_sass_per_step(lib_path) -> dict:
    """SASS instructions a step of P3's main loop at 8 rows, by op, read
    with cuobjdump from the built library: (all, the logic ones: LOP3 and
    the funnel shift SHF) in the first loop, the unrolled one, over the
    steps a trip (eravm_p3_unroll); {} where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    unroll = _build.load().eravm_p3_unroll()
    out = {}
    for op, code in (("xor", 0), ("mix", 1), ("andnot", 2)):
        m = re.search(rf"Function : \S*p3_kernelILi{code}ELi8E\S*\n(.*?)"
                      r"(?=\n\s*Function :|\Z)", sass, re.S)
        if not m:
            continue
        offsets, logic, labels, branches, pending = [], [], {}, [], []
        for line in m.group(1).splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not ins:
                continue
            off = int(ins.group(1), 16)
            labels.update((name, off) for name in pending)
            pending = []
            offsets.append(off)
            words = ins.group(2).split()          # [@predicate] opcode ...
            opcode = words[1] if words[0].startswith("@") else words[0]
            if opcode.split(".")[0] in ("LOP3", "LOP", "SHF"):
                logic.append(off)
            br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)",
                           ins.group(2))
            if br:
                branches.append((off, br.group(1)))
        loops = []
        for off, target in branches:
            t = int(target, 16) if target.startswith("0x") \
                else labels.get(target)
            if t is not None and t < off:
                loops.append((sum(t <= o <= off for o in offsets),
                               sum(t <= o <= off for o in logic)))
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


def probe_phases(dev, sm_mhz: float, lib_path) -> dict:
    """The tool probes P1-P7: each kernel against its plain version on the
    card; times at the tools' shapes; then the tools' entry points, the
    probes' main path, with the launch counts zeroed just before.  Returns
    {probe: (launches, max abs err, ms, plain ms, bound)} for the kernels
    line."""
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
    # plain version and, through planes_to_states, against K3
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
                ms = best_ms(lambda: box.__setitem__("k", f(planes, P_ITERS)),
                             reps=1)
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
                ms = timed_ms(lambda: f(planes, P_ITERS))
                rows[name][0] = err
            times[(name, g8)] = (ms, bound[0])
        del planes, states, k3
    phase("P2-P5", iters=P_ITERS, equal=True, **{
        f"{n}_g{g}_ms": round(t[0], 3) for (n, g), t in times.items()}, **{
        f"{n}_g{g}_perms_per_sec": 256 * g * P_ITERS / (t[0] / 1e3)
        for (n, g), t in times.items()}, **{
        f"g{g}_bound_ms": round(t[1], 4) for (n, g), t in times.items()},
        plain_g128_ms=round(rows["P2"][2], 1))

    # -- P3 ----------------------------------------------------------------
    sass = p3_sass_per_step(lib_path)
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
    big = rand(P4_COLS, 25, 2)
    big_ms = best_ms(lambda: pk.round_chain(big, P4_ITERS), reps=1)
    big_bound = bound_ms(2 * P4_COLS * 200,
                         P4_COLS * P4_ITERS * KECCAK_OPS // 24, sm_mhz)
    phase("P4", iters=P4_ITERS, tile=P4_TILE, equal=True, ms=round(ms, 3),
          plain_ms=round(plain_ms, 1), bound_ms=round(rows["P4"][3][0], 4),
          perm_equiv_per_sec=P4_TILE * P4_ITERS / 24 / (ms / 1e3),
          states_full=P4_COLS, ms_full=round(big_ms, 3),
          bound_ms_full=round(big_bound[0], 3),
          perm_equiv_per_sec_full=P4_COLS * P4_ITERS / 24 / (big_ms / 1e3))
    del x, big, box

    # -- P6 ----------------------------------------------------------------
    # the tool's batch-last arena [8, W, TB] and K1's lane-major [TB, 8, W];
    # bound: the gathered elements, the index and the output once, and one
    # operation an output (REPS a power of two: the sum is a shift)
    fields, err = {}, 0
    for tb in P6_TBS:
        bound = bound_ms(4 * 17 * tb, 8 * tb, sm_mhz)
        fields[f"tb{tb}_bound_ms"] = bound[0]
        for random_index in (False, True):
            box = {}
            for lane_major in (False, True):
                arena, idx = pu.tool_inputs(P6_W, tb, dev, random_index,
                                            lane_major)
                if not lane_major:
                    plain_ms = timed_ms(lambda: box.__setitem__(
                        "p", pu.uniform_gather_plain(arena, idx, P6_REPS)))
                for mode in (0, 1):
                    ms = best_ms(lambda: box.__setitem__(
                        "k", pu.uniform_gather(arena, idx, P6_REPS, mode,
                                               lane_major)))
                    tag = (f"tb{tb}_{'lane_major' if lane_major else 'batch_last'}"
                           f"_{'random' if random_index else 'uniform'}")
                    err = max(err, check(f"P6 {tag} mode={mode}", box["k"],
                                         box["p"]))
                    fields[f"{tag}_mode{mode}_ms"] = ms
                    if tb == P6_TBS[0] and not random_index \
                            and not lane_major and mode == 1:
                        rows["P6"] = [err, ms, plain_ms, bound]
                del arena, idx
            del box
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
    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    log = (lib_path.parent / "build.log").read_text()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    phase("build", seconds=round(time.time() - t0, 2),
          lib=lib_path.parent.name, ptxas=" | ".join(regs))

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

    # -- K2 against plain ----------------------------------------------
    cfg_b = bench_config(B_FULL, rolling=True)
    entry_b = make_entry_state(cfg_b, [wl] * B_FULL, ergs=FULL_ERGS,
                               device=dev)
    st = clone_state(entry_b)
    block = fused_cycle.new_slot_block(cfg_b, K, dev)
    fused_cycle.cycle_chunk(st, cfg_b, K, K, block)
    fused_cycle.rolling_fold(st.wc_state, st.wc_count, block, K * 8)
    fused_cycle.cycle_chunk(st, cfg_b, K, K, block)   # a second chunk's slots
    wa, ca = st.wc_state.clone(), st.wc_count.clone()
    wb, cb = st.wc_state.clone(), st.wc_count.clone()
    k2_ms = timed_ms(lambda: fused_cycle.rolling_fold(wa, ca, block, K * 8))
    k2_plain_ms = timed_ms(lambda: rolling_absorb(wb, cb, *block))
    k2_err = require_equal(
        "K2 B=32768",
        {"wc_state": wa, "wc_count": ca, "digest": finalize_rolling(wa, ca)},
        {"wc_state": wb, "wc_count": cb, "digest": finalize_rolling(wb, cb)})
    n_perms = int(((block[2] >> 2) & 1).sum()) // 2    # one per record pair
    k2_bound = bound_ms(sum(x.nbytes for x in block) + 2 * wa.nbytes
                        + 2 * ca.nbytes, n_perms * KECCAK_OPS, sm_mhz)
    phase("K2", batch=B_FULL, rows=K * 8, equal=True, ms=round(k2_ms, 3),
          plain_ms=round(k2_plain_ms, 3), bound_ms=round(k2_bound[0], 3),
          bound_by=k2_bound[1], records=int(ca[0]))
    del st, block, wa, wb

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

    # -- K1's precompile instance against plain -------------------------
    pp_lanes = list(block_programs.PRECOMPILE_LANES) + [
        (e, src) for e, src, *_ in block_programs.precompile_mix(17, seed=3)]
    cfg_ps = precompile_small_config(len(pp_lanes))
    ks = make_entry_state(cfg_ps, [assemble(src) for _, src in pp_lanes],
                          ergs=1 << 20,
                          entry_address=[e for e, _ in pp_lanes], device=dev)
    ps = clone_state(ks)
    fused_cycle.run_cycles(ks, cfg_ps, 96, k_inner=8)
    batched_vm.run_cycles(ps, cfg_ps, 96)
    torch.cuda.synchronize()
    kps_err = require_equal("K1 precompile programs", state_tensors(ks),
                            state_tensors(ps))
    phase("K1-precompile-small", lanes=len(pp_lanes), cycles=96, k_inner=8,
          equal=True, pq_rows=int(ks.pq_count.sum()),
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
    # the splice alone, again from the same scratch rows
    sp = clone_state(entry_p)
    splice_ms = timed_ms(lambda: fused_cycle.splice_precompile_rows(
        sp, cfg_p, pq_block, K))
    del sp
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
    phase("K1-precompile", batch=B_FULL, cycles=K, equal=True,
          ms=round(kp_ms, 3), splice_ms=round(splice_ms, 3),
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
    ks = make_entry_state(cfg_es, [assemble(src) for _, src in ec_lanes],
                          ergs=1 << 20,
                          entry_address=[e for e, _ in ec_lanes], device=dev)
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
    phase("K1-ecrecover-small", lanes=len(ec_lanes), cycles=96, k_inner=8,
          equal=True, pq_rows=int(ks.pq_count.sum()),
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
    ke_times = []
    for _ in range(2):             # again from the entry state, timed
        kt = clone_state(entry_e)
        ke_times.append(timed_ms(lambda: fused_cycle.cycle_chunk(
            kt, cfg_e, K, pq_block=pq_block)))
        del kt
    ke_ms = min(ke_times)
    ke_bound = bound_ms(ke_nbytes, B_FULL * K * K1_MIN_OPS + ecrecover_ops(
        ec_mix[i % len(ec_mix)][4] for i in range(B_FULL)), sm_mhz)
    phase("K1-ecrecover", batch=B_FULL, cycles=K, equal=True,
          ms_first=round(ke_first_ms, 3),
          ms=";".join(f"{t:.3f}" for t in ke_times),
          plain_ms=round(ke_plain_ms, 3), bound_ms=round(ke_bound[0], 4),
          bound_by=ke_bound[1], bound_bytes=ke_nbytes, recoveries=n_ec,
          ecrecovers_per_sec=n_ec / (ke_ms / 1e3), lane_errors=errors,
          cycles_per_sec=B_FULL * K / (ke_ms / 1e3))
    del entry_e, pq_block

    # -- K3 against plain ------------------------------------------------
    gen = torch.Generator().manual_seed(3)
    k3_err, k3_ms, k3_plain_ms = 0, None, None
    for n, iters in K3_CHECKS:
        states = torch.randint(-2**31, 2**31 - 1, (n, 25, 2), generator=gen,
                               dtype=torch.int32).to(dev)
        keccak.keccak_f1600(states, iters)                   # warm
        box = {}
        ms = timed_ms(lambda: box.setdefault(
            "k", keccak.keccak_f1600(states, iters)))
        plain_ms = timed_ms(lambda: box.setdefault(
            "p", keccak.keccak_f1600_plain(states, iters)))
        k3_err = max(k3_err, require_equal(
            f"K3 N={n} iters={iters}", {"states": box["k"]},
            {"states": box["p"]}))
        if iters == 1:
            k3_n, k3_ms, k3_plain_ms = n, ms, plain_ms
    k3_bound = bound_ms(2 * k3_n * 200, k3_n * KECCAK_OPS, sm_mhz)
    rates = {}
    for name, n, iters in K3_BENCH:
        states = torch.ones((n, 25, 2), dtype=torch.int32, device=dev)
        keccak.keccak_f1600(states, iters)
        ms = timed_ms(lambda: keccak.keccak_f1600(states, iters))
        rates[name] = (ms, n * iters / (ms / 1e3),
                       bound_ms(2 * n * 200, n * iters * KECCAK_OPS,
                                sm_mhz)[0])
    phase("K3", equal=True, checked=K3_CHECKS, n_x1=k3_n,
          ms_x1=round(k3_ms, 4), plain_ms_x1=round(k3_plain_ms, 3),
          bound_ms_x1=round(k3_bound[0], 4), bound_by=k3_bound[1],
          **{f"{k}_ms": round(v[0], 3) for k, v in rates.items()},
          **{f"{k}_perms_per_sec": v[1] for k, v in rates.items()},
          **{f"{k}_bound_ms": round(v[2], 3) for k, v in rates.items()})

    # -- the tool probes P1-P7 ------------------------------------------
    probes = probe_phases(dev, sm_mhz, lib_path)

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
    blocks = {}
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
        need = ("K1", "K3") + ((unit,) if unit else ())
        if any(launches[k] == 0 for k in need):
            raise AssertionError(f"{tag}: launches {launches}")
        n_check = EC_CHECK_TXS if mix == "ecrecover" else CHECK_TXS
        check_on_cpu(tag, cfg_k, txs, knobs, blk, n_check)
        blocks[tag] = launches
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
    del blk, st

    phase("launches", K1=main_k1 + wave_k1, K1_main=main_k1,
          K1_wave=wave_k1, K2=main_k2, K3=wave_k3,
          K1_block_tiny=blocks["block-tiny"]["K1"],
          K3_block_tiny=blocks["block-tiny"]["K3"],
          K1_precompile_block=blocks["block-precompile"]["K1_precompile"],
          K3_block_precompile=blocks["block-precompile"]["K3"],
          K1_ecrecover=blocks["block-ecrecover"]["K1_ecrecover"],
          K3_block_ecrecover=blocks["block-ecrecover"]["K3"])
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
               main_k1, k1_err, k1_ms, k1_plain_ms, k1_bound),
        kernel("K1 cycle_kernel, slices (b) LOG and (c) FAR_CALL",
               "cycle_kernel.cu", k1_src, blocks["block-tiny"]["K1"],
               max(ks_err, kf_err, kw_err),
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
        kernel("K2 rolling_fold", "rolling_fold.cu",
               "era_zk_evm_tpu/models/fused_cycle.py:3205", main_k2, k2_err,
               k2_ms, k2_plain_ms, k2_bound),
        kernel("K3/K4 keccak_f", "keccak_f.cu",
               "era_zk_evm_tpu/ops/keccak.py:292, era_zk_evm_tpu/ops/"
               "keccak.py:371", blocks["block-tiny"]["K3"], k3_err, k3_ms,
               k3_plain_ms,
               k3_bound),
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
