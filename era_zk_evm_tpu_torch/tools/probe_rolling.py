"""The rolling commitment's cost on the card: the counterpart of
`tools/probe_rolling.py`.

Two modes run WORKLOAD at the JAX tool's geometry (`make_cfg`): "capture",
mode (a), where K1 queues every cycle's 8 memory-query slots (`wq_*`), and
"rolling", mode (b), where K1 writes each lane's valid slots compacted into
a record block (`fused_cycle.new_slot_block`) and K2
(`fused_cycle.rolling_fold`) folds them into the lane's sponge.  Groups:

  profile  mode (a) once: the queue's slots, those valid in some lane and
           in every lane, the mean records a lane (`wq_flags & 4`), beside
           mode (b)'s records a lane (`wc_count` after `run_cycles` in mode
           (b) over the same cycles from the same entry state and zero
           sponges: the sum of the counts K1 wrote into its blocks); raises
           unless every lane's two counts agree;
  fold     K2 alone on mode (a)'s queue compacted
           (`witness/rolling.compact_slot_rows`, untimed), from a zero
           sponge: the best of 3 CUDA-event times, each on a fresh copy,
           beside its bound (`k1_times.fold_row`).  The JAX tool's two
           folds, `u32pair` and `bitsliced`, are one kernel here, so one
           line serves both labels.  Raises unless the sponge equals
           `rolling_absorb_rows` on the same block and mode (b)'s sponge
           (K1 (b) + K2) after the same cycles;
  rates    each mode's cycles/s, one synchronised call and pipelined (depth
           4, best of 3; mode (a) rewinds its queues after every call,
           `models/spill.rewind_queues`), with K1's and K2's device time a
           call from `torch.profiler`, split by kernel name, and the rest
           of the device's work a call (mode (a)'s rewind), from a profile
           that holds every launch of the calls it profiled (a warm-up step
           first; a profile that misses one is measured again, at most
           three times, then the tool raises).  The JAX tool
           read "rolling - capture" as the fold's cost; the device times
           split that difference into K1's two modes, K2 and the rewind.

    python -m era_zk_evm_tpu_torch.tools.probe_rolling [batch] [n_cycles] \
        [profile fold rates]

It runs on the card unless `--cpu` is given (the plain versions: pass a
small batch and cycle count).  It prints the card's name and power limit
first and every row as one JSON line last; `main(argv)` returns the rows.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from ..config import VmConfig
from ..models import fused_cycle
from ..models.spill import rewind_queues
from ..models.state import make_entry_state
from ..testing.programs import WORKLOAD, assemble
from ..witness.rolling import compact_slot_rows
from .k1_times import card, device_for, fold_line, fold_row, report

BATCH, N_CYCLES = 32768, 128
GROUPS = ("profile", "fold", "rates")
#: the JAX tool's two fold kernels, one K2 here
FOLD_LABELS = ("u32pair", "bitsliced")
MODES = ("capture", "rolling")
ERGS = (1 << 31) - 1
#: profiles of `rates` taken before one that holds every launch
PROFILE_TRIES = 3


def make_cfg(batch: int, n_cycles: int, mode: str) -> VmConfig:
    """The JAX tool's geometry (`tools/probe_rolling.py::make_cfg`; its
    `tile` is K1's own block size here, `fused_cycle.k1_threads`)."""
    q = n_cycles * 8 if mode == "capture" else 0
    return VmConfig(batch=batch, code_words=16, stack_words=256,
                    sweep_gating=False,
                    stack_abs_words=64, stack_sp_base=960,
                    heap_words=64, aux_heap_words=16, max_depth=8,
                    queue_capacity=q,
                    rolling_commitment=(mode == "rolling"))


def entry(batch: int, n_cycles: int, mode: str, device) -> tuple:
    cfg = make_cfg(batch, n_cycles, mode)
    return cfg, make_entry_state(cfg, [assemble(WORKLOAD)] * batch,
                                 ergs=ERGS, device=device)


def capture_run(batch: int, n_cycles: int, device):
    """Mode (a) once from the entry state: the state, its queue filled."""
    cfg, st = entry(batch, n_cycles, "capture", device)
    fused_cycle.run_cycles(st, cfg, n_cycles, k_inner=min(128, n_cycles))
    return st


def rolling_run(batch: int, n_cycles: int, device) -> tuple:
    """Mode (b) once from the entry state (K1 (b) + K2 a chunk, as main-b
    runs it): (state, the records a lane, its `wc_count`: from zero sponges,
    the sum of the counts K1 wrote into its blocks)."""
    cfg, st = entry(batch, n_cycles, "rolling", device)
    fused_cycle.run_cycles(st, cfg, n_cycles, k_inner=min(128, n_cycles))
    return st, st.wc_count.clone()


def profile_row(capture, counts: torch.Tensor) -> dict:
    """The capture queue's validity profile beside mode (b)'s counts."""
    valid = (capture.wq_flags & 4) != 0
    per_lane = valid.sum(0, dtype=torch.int32)
    if not torch.equal(per_lane, counts):
        bad = int((per_lane != counts).sum())
        raise AssertionError(f"{bad} lanes: mode (a)'s valid slots differ "
                             "from mode (b)'s records")
    return {"slots": valid.shape[0], "any_valid": int(valid.any(1).sum()),
            "all_valid": int(valid.all(1).sum()),
            "mean_lane_records": float(per_lane.double().mean()),
            "mode_b_mean_records": float(counts.double().mean()),
            "counts_equal": True}


def capture_fold(capture, rolling) -> dict:
    """K2 on mode (a)'s queue, compacted, from zero sponges; raises unless
    it gives mode (b)'s sponges."""
    block = compact_slot_rows(capture.wq_meta, capture.wq_value,
                              capture.wq_flags)
    row, (wc, cnt) = fold_row(block)
    if not (torch.equal(wc, rolling.wc_state)
            and torch.equal(cnt, rolling.wc_count)):
        raise AssertionError("K2 on the compacted capture queue differs "
                             "from mode (b)'s sponges")
    row.update(active_slots=int(((capture.wq_flags & 4) != 0).any(1).sum()),
               kq=block[0].shape[0], cnt=int(cnt[0]),
               equal_to_mode_b=True)
    return row


def profile_calls(step, calls: int) -> tuple:
    """One torch.profiler pass over `calls` calls of step, after a warm-up
    step of as many calls that the profiler throws away (the schedule's
    warm-up; the recorded step ends with the pass): ({"k1", "k2"}:
    (launches, device ms), the other device ops' ms)."""
    kernels = {"k1": [0, 0.0], "k2": [0, 0.0]}
    other = 0.0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=1)) as prof:
        for recorded in (False, True):
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            if not recorded:
                prof.step()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key.startswith("ProfilerStep"):
            continue
        k = next((k for k in kernels if f"{k}_kernel" in e.key), None)
        if k is None:
            other += e.self_device_time_total / 1e3
        else:
            kernels[k][0] += e.count
            kernels[k][1] += e.self_device_time_total / 1e3
    return kernels, other


def device_ms(step, calls: int, chunks: int, mode: str, device) -> dict:
    """K1's and K2's device time a call (`chunks` launches of each; mode
    (a) launches no K2) and every other device op's time a call (mode (a)'s
    queue rewind: the queue zeroed), from a `profile_calls` pass over
    `calls` calls of step that holds every launch of K1 and K2 they made;
    a pass that misses one is taken again, PROFILE_TRIES in all, then this
    raises."""
    if device.type != "cuda":
        return {"k1_device_ms": None, "k2_device_ms": None,
                "other_device_ms": None, "reason": "--cpu: no device time"}
    want = {"k1": calls * chunks,
            "k2": calls * chunks if mode == "rolling" else 0}
    for tries in range(1, PROFILE_TRIES + 1):
        kernels, other = profile_calls(step, calls)
        got = {k: n for k, (n, _) in kernels.items()}
        if got == want:
            break
    else:
        raise AssertionError(f"{mode}: {PROFILE_TRIES} profiles held "
                             f"{got} launches, not {want}")
    row = {"k1_device_ms": kernels["k1"][1] / calls,
           "k2_device_ms": kernels["k2"][1] / calls,
           "other_device_ms": other / calls, "launches": want,
           "profile_tries": tries}
    if mode == "capture":
        row.update(k2_device_ms=None, reason="mode (a) launches no K2")
    return row


def timed_rates(batch: int, n_cycles: int, mode: str, device,
                depth: int = 4, repeats: int = 3) -> dict:
    """The JAX tool's `timed_rates`: a synchronised call and pipelined
    calls, mode (a) rewinding its queues after each call."""
    cfg, st = entry(batch, n_cycles, mode, device)

    def step():
        fused_cycle.run_cycles(st, cfg, n_cycles, k_inner=min(128, n_cycles))

    def rewind():
        if mode == "capture":
            rewind_queues(st)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    step()
    sync()
    compile_s = time.perf_counter() - t0
    rewind()
    best_call = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        step()
        sync()
        best_call = min(best_call, time.perf_counter() - t0)
        rewind()
    best_pipe = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(depth):
            step()
            rewind()
        sync()
        best_pipe = min(best_pipe, (time.perf_counter() - t0) / depth)

    def piped_step():
        step()
        rewind()

    cyc = batch * n_cycles
    chunks = -(-n_cycles // min(128, n_cycles))
    return {"ms": best_pipe * 1e3, "call_ms": best_call * 1e3,
            "compile_s": compile_s, "sync_cycles_per_sec": cyc / best_call,
            "piped_cycles_per_sec": cyc / best_pipe,
            "lane_errors": int(st.lane_error.sum()),
            **device_ms(piped_step, depth, chunks, mode, device)}


def rates_line(mode: str, batch: int, n_cycles: int, r: dict) -> str:
    dev = "" if r["k1_device_ms"] is None else (
        f"; device a call K1 {r['k1_device_ms']:.4f} ms"
        + ("" if r["k2_device_ms"] is None
           else f", K2 {r['k2_device_ms']:.4f} ms")
        + f", other {r['other_device_ms']:.4f} ms")
    return (f"{mode:8s} B={batch} K={n_cycles} "
            f"compile={r['compile_s']:.1f}s  "
            f"sync={r['sync_cycles_per_sec'] / 1e6:.1f}M  "
            f"piped={r['piped_cycles_per_sec'] / 1e6:.1f}M "
            f"(call {r['call_ms']:.3f}ms piped {r['ms']:.3f}ms{dev})")


def main(argv=None) -> dict:
    """Run the groups; return {label: row} (the JAX tool's labels)."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.probe_rolling",
        description="the rolling commitment's cost (K1 modes (a) and (b), "
                    "K2) on the card")
    ap.add_argument("args", nargs="*",
                    help="[batch] [n_cycles] [profile fold rates]")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    nums = [int(a) for a in args.args if a.isdigit()]
    groups = [a for a in args.args if not a.isdigit()] or list(GROUPS)
    if set(groups) - set(GROUPS):
        raise SystemExit(f"probe_rolling: groups are {GROUPS}")
    batch = nums[0] if nums else BATCH
    n_cycles = nums[1] if len(nums) > 1 else N_CYCLES
    device = device_for(args.cpu)
    card_line = card(device)
    print(f"card: {card_line}", flush=True)
    rows = {}
    if "profile" in groups or "fold" in groups:
        capture = capture_run(batch, n_cycles, device)
        rolling, counts = rolling_run(batch, n_cycles, device)
        if "profile" in groups:
            p = rows["profile"] = profile_row(capture, counts)
            print(f"profile B={batch} K={n_cycles}: slots={p['slots']} "
                  f"any_valid={p['any_valid']} all_valid={p['all_valid']} "
                  f"mean_lane_records={p['mean_lane_records']:.1f} (mode "
                  f"(b): {p['mode_b_mean_records']:.1f} records a lane, "
                  "every lane's count equal)", flush=True)
        if "fold" in groups:
            f = capture_fold(capture, rolling)
            for label in FOLD_LABELS:
                rows[f"fold[{label}]"] = f
            print(fold_line(
                " = ".join(f"fold[{x}]" for x in FOLD_LABELS)
                + f" B={batch} KQ={f['kq']}", f)
                + f", {f['active_slots']} active slots, cnt={f['cnt']}, "
                f"first call {f['first_ms']:.3f} ms; equal to the plain fold "
                "and to mode (b)'s sponges", flush=True)
        del capture, rolling, counts
        torch.cuda.empty_cache()
    if "rates" in groups:
        for mode in MODES:
            rows[mode] = timed_rates(batch, n_cycles, mode, device)
            print(rates_line(mode, batch, n_cycles, rows[mode]), flush=True)
            torch.cuda.empty_cache()
    return report("probe_rolling", device, card_line, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
