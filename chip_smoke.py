#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`era_zk_evm_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles the K1 and K2 kernels from the sources in this tree;
  3. K1 against its plain torch version on the card: the family programs
     at a small batch (both modes), and WORKLOAD at B = 32768 for one
     128-cycle call; every state field must be equal;
  4. K2 against its plain version at B = 32768: sponge state, record count
     and finalized digests must be equal;
  5. the main path at full size (bench geometry, B = 32768, WORKLOAD):
     mode (a) with the memory queue and mode (b) with the rolling
     commitment, 8 chained 128-cycle calls with a queue rewind between
     them; prints cycles/s pipelined and per synced call, the plain
     version's rate at the same shape, and the kernel launch counts; lanes
     0..7 must equal a plain run of the same calls.
The line before the last holds the kernels' JSON record; the last line is
the device record.  The script imports no JAX.
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
from era_zk_evm_tpu_torch.models import batched_vm, fused_cycle
from era_zk_evm_tpu_torch.models.spill import rewind_queues
from era_zk_evm_tpu_torch.models.state import (
    clone_state, make_entry_state, state_to_numpy,
)
from era_zk_evm_tpu_torch.testing.programs import (
    FAMILY_PROGRAMS, WORKLOAD, assemble,
)
from era_zk_evm_tpu_torch.witness.rolling import (
    finalize_rolling, rolling_absorb,
)

B_FULL = 32768
K = 128            # cycles per call
CALLS = 8          # chained calls per pipelined sweep
SWEEPS = 2         # pipelined sweeps; the fastest is kept
PLAIN_CYCLES = 16  # cycles of the plain version timed at full size
FULL_ERGS = (1 << 31) - 1


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


def main() -> int:
    # -- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # -- 2. build ------------------------------------------------------
    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    log = (lib_path.parent / "build.log").read_text()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    phase("build", seconds=round(time.time() - t0, 2),
          lib=lib_path.parent.name, ptxas=" | ".join(regs))

    # -- 3. K1 against plain -------------------------------------------
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
    phase("K1", batch=B_FULL, cycles=K, equal=True, ms=round(k1_ms, 3),
          plain_ms=round(k1_plain_ms, 3))
    del ks, ps

    # -- 4. K2 against plain -------------------------------------------
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
    phase("K2", batch=B_FULL, rows=K * 8, equal=True, ms=round(k2_ms, 3),
          plain_ms=round(k2_plain_ms, 3),
          records=int(ca[0]))
    del st, block, wa, wb

    # -- 5. the main path at full size ---------------------------------
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
    k1_launches, k2_launches = fused_cycle.K1_LAUNCHES, fused_cycle.K2_LAUNCHES
    if k1_launches == 0 or k2_launches == 0:
        raise AssertionError(f"main path launches K1={k1_launches} "
                             f"K2={k2_launches}")

    n_ref = 8
    for mode, cfg in (("a", cfg_a), ("b", cfg_b)):
        st, n_calls, piped_s, sync_s = results[mode]
        errors = int(st.lane_error.sum())
        if errors:
            raise AssertionError(f"mode {mode}: {errors} lanes set lane_error")
        # lanes 0..7 against the plain version on the CPU, same calls
        ref_cfg = dataclasses.replace(cfg, batch=n_ref)
        ref = make_entry_state(ref_cfg, [wl] * n_ref, ergs=FULL_ERGS)
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
    phase("launches", K1=k1_launches, K2=k2_launches)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(card)
    print(json.dumps({"kernels": [
        {"name": "K1 cycle_kernel", "route": "cuda",
         "source": "era_zk_evm_tpu_torch/csrc/cycle_kernel.cu",
         "replaces": "era_zk_evm_tpu/models/fused_cycle.py:2794",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "K2 rolling_fold", "route": "cuda",
         "source": "era_zk_evm_tpu_torch/csrc/rolling_fold.cu",
         "replaces": "era_zk_evm_tpu/models/fused_cycle.py:3205",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
