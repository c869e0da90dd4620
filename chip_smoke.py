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
  K1-wave-segment  the witness wave's first 256-cycle segment, B = 4096,
                kernel vs plain over the whole batch;
  witness-wave  the log family's witness path at bench_block's tiny-mix
                geometry, B = 4096: every lane runs one tx to its end in
                256-cycle segments with compacted packed drains, then the
                per-lane digests, block folds, grand products (K3) and the
                block product; lanes 0..7 equal to a plain CPU run;
  wave-profile  the same wave under torch.profiler: the device's busy
                time and idle share, and its largest device ops;
  launches      K1, K2 and K3 launched on their main paths.
The card's name and power limit come on a line of their own, the kernels'
JSON record on the line before the last, and the last line is the device
record.  The script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.config import BATCH_LAST_FIELDS, VmConfig
from era_zk_evm_tpu_torch.isa import params
from era_zk_evm_tpu_torch.isa.abi import code_hash_for_bytecode
from era_zk_evm_tpu_torch.models import batched_vm, fused_cycle
from era_zk_evm_tpu_torch.models.spill import rewind_queues
from era_zk_evm_tpu_torch.models.state import (
    clone_state, make_entry_state, populate_code_bank, populate_storage,
    state_to_numpy,
)
from era_zk_evm_tpu_torch.ops import keccak
from era_zk_evm_tpu_torch.testing import log_programs
from era_zk_evm_tpu_torch.testing.programs import (
    FAMILY_PROGRAMS, FARCALL_CALLEE_ADDRESS, STORAGE_WORKLOAD, WORKLOAD,
    assemble, farcall_callee, farcall_caller, tiny_mix_program,
)
from era_zk_evm_tpu_torch.testing.wave import run_wave, wave_commitments
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
SECTOR = 32                                   # bytes of one DRAM sector


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


def wave_config(batch: int) -> VmConfig:
    """bench.py bench_block's tiny-mix geometry (bench.py:574-579: chunk
    64, tail_mult 4)."""
    return VmConfig(batch=batch, code_words=16, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=32, aux_heap_words=16, max_depth=8,
                    queue_capacity=64 * 8 * 4, storage_slots=8,
                    journal_slots=64, event_slots=64,
                    log_queue_capacity=64 * 4)


def compare(a: dict, b: dict) -> tuple[list[str], int]:
    """Fields that differ, and the largest absolute difference."""
    bad, err = [], 0
    for name in a:
        x, y = a[name].astype(np.int64), b[name].astype(np.int64)
        if x.shape != y.shape:
            bad.append(name)
            continue
        d = int(np.abs(x - y).max()) if x.size else 0
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


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
                  "dq_hash", "dq_meta", "wq_meta", "wq_value", "wq_flags"}


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
                      state_to_numpy(ks), state_to_numpy(ps))
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
    k1_err = require_equal("K1 WORKLOAD B=32768", state_to_numpy(ks),
                           state_to_numpy(ps))
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
        {"wc_state": wa.cpu().numpy(), "wc_count": ca.cpu().numpy(),
         "digest": finalize_rolling(wa, ca).cpu().numpy()},
        {"wc_state": wb.cpu().numpy(), "wc_count": cb.cpu().numpy(),
         "digest": finalize_rolling(wb, cb).cpu().numpy()})
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
        got = lanes(state_to_numpy(st), n_ref)
        require_equal(f"main path mode {mode} lanes 0..{n_ref - 1}", got,
                      state_to_numpy(ref))
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
        require_equal(f"K1 log/far-call run {run}", state_to_numpy(ks),
                      state_to_numpy(ps))
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
    ks_err = require_equal("K1-storage B=32768", state_to_numpy(ks),
                           state_to_numpy(ps))
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
    kf_err = require_equal("K1-farcall B=16384", state_to_numpy(ks),
                           state_to_numpy(ps))
    # the same with the log and decommit queues on: their rows compared
    # over the whole batch
    cfg_q, entry_q = farcall_entry(B_FARCALL, dev, queues=True)
    kq, pq = entry_q, clone_state(entry_q)
    fused_cycle.run_cycles(kq, cfg_q, FARCALL_CYCLES, k_inner=FARCALL_CYCLES)
    batched_vm.run_cycles(pq, cfg_q, FARCALL_CYCLES)
    kf_err = max(kf_err, require_equal("K1-farcall with queues B=16384",
                                       state_to_numpy(kq), state_to_numpy(pq)))
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
            f"K3 N={n} iters={iters}", {"states": box["k"].cpu().numpy()},
            {"states": box["p"].cpu().numpy()}))
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
    kw_err = require_equal("K1 wave segment B=4096", state_to_numpy(ks),
                           state_to_numpy(ps))
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
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wave_commitments(run_wave(st, cfg_w, WAVE_SEGMENT, WAVE_FRACS), dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # the device-side events only (kernels, copies, fills): the host ops
    # that launched them report the same time again
    ops = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(t for _, t in ops) / 1e6
    top = sorted(ops, key=lambda kv: -kv[1])[:4]
    phase("wave-profile", wall_s=round(prof_wall, 4),
          device_busy_s=round(busy_s, 4),
          idle_share=round(1 - busy_s / prof_wall, 4),
          top=";".join(f"{k[:40]}:{t / 1e3:.2f}ms" for k, t in top))

    phase("launches", K1=main_k1 + wave_k1, K1_main=main_k1,
          K1_wave=wave_k1, K2=main_k2, K3=wave_k3)
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "era_zk_evm_tpu" or m.startswith("era_zk_evm_tpu.")]
    if bad:
        raise AssertionError(f"the port imported {bad}")
    phase("total", seconds=round(time.time() - t_start, 1))

    def kernel(name, source, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda",
                "source": f"era_zk_evm_tpu_torch/csrc/{source}",
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
               "cycle_kernel.cu", k1_src, wave_k1,
               max(ks_err, kf_err, kw_err),
               ks2_ms, ks_plain_ms, ks_bound),
        kernel("K2 rolling_fold", "rolling_fold.cu",
               "era_zk_evm_tpu/models/fused_cycle.py:3205", main_k2, k2_err,
               k2_ms, k2_plain_ms, k2_bound),
        kernel("K3/K4 keccak_f", "keccak_f.cu",
               "era_zk_evm_tpu/ops/keccak.py:292, era_zk_evm_tpu/ops/"
               "keccak.py:371", wave_k3, k3_err, k3_ms, k3_plain_ms,
               k3_bound),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
