"""K1's four instances timed on the card at the smoke run's shapes, for
comparing two trees of the port in one process each on one card.

    python era_zk_evm_tpu_torch/tools/k1_times.py [--tree DIR] [--reps 3]

`--tree DIR` imports `era_zk_evm_tpu_torch` from DIR (another checkout of
the repository, e.g. the parent commit unpacked with `git archive`) in
place of this one, so one command can time parent, change, change, parent
on the same card.  The script uses only entry points that every tree of
the port since ecrecover has (`make_entry_state`, `clone_state`,
`fused_cycle.cycle_chunk`, `new_pq_block`, `splice_precompile_rows`, the
bench programs), builds that tree's kernels, and prints one JSON line:
the card's name and power limit and, per case, the best of `--reps`
CUDA-event times of one 128-cycle `cycle_chunk` call (with the round-witness
splice for kPrecomp and kEc, as `chip_smoke.py` times them), the splice
alone, and the launch's block size.  The cases are `chip_smoke.py`'s K1
(WORKLOAD, B = 32768, memory queue), K1-storage (STORAGE_WORKLOAD, B =
32768, a second call on the warm state), K1-precompile (the precompile
mix, B = 32768) and K1-ecrecover (signed transfers, a recovery in every
lane, B = 32768), and K1 and K1-storage again at the block phases' B =
4096.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]),
                    help="import the port from this checkout (default: "
                         "the one holding this script)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_times: no CUDA card")
    from era_zk_evm_tpu_torch import _build
    from era_zk_evm_tpu_torch.config import VmConfig, precompile_queue_slots
    from era_zk_evm_tpu_torch.models import fused_cycle
    from era_zk_evm_tpu_torch.models.state import (
        clone_state, make_entry_state,
    )
    from era_zk_evm_tpu_torch.testing import block_programs, ec_programs
    from era_zk_evm_tpu_torch.testing.programs import (
        STORAGE_WORKLOAD, WORKLOAD, assemble,
    )

    dev = torch.device("cuda:0")
    K, ERGS = 128, (1 << 31) - 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.time()
    _build.load()
    build_s = time.time() - t0

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def base(batch, **kw):
        return VmConfig(batch=batch, code_words=16, stack_words=256,
                        sweep_gating=False, stack_abs_words=64,
                        stack_sp_base=960, aux_heap_words=16, max_depth=8,
                        **kw)

    def storage(batch):
        return base(batch, heap_words=16, storage_slots=8, journal_slots=64,
                    event_slots=64)

    def units(cfg, ecrecover=False):
        cfg = dataclasses.replace(cfg, precompile_keccak_blocks=2,
                                  precompile_sha_rounds=2,
                                  precompile_ecrecover=ecrecover)
        return dataclasses.replace(cfg, precompile_queue_capacity=K * sum(
            precompile_queue_slots(cfg)))

    def case(name):
        """(config, entry state, warm calls before the timed one)"""
        batch = 4096 if name.endswith("4096") else 32768
        if name.startswith("a"):
            cfg = base(batch, heap_words=64, queue_capacity=K * 8)
            return cfg, make_entry_state(cfg, [assemble(WORKLOAD)] * batch,
                                         ergs=ERGS, device=dev), 0
        if name.startswith("log"):
            cfg = storage(batch)
            return cfg, make_entry_state(
                cfg, [assemble(STORAGE_WORKLOAD)] * batch, ergs=ERGS,
                device=dev), 1
        if name == "precompile":
            cfg = units(storage(batch))
            mix = block_programs.precompile_mix(batch)
            cache = {}
            return cfg, make_entry_state(
                cfg, [cache.setdefault(s, assemble(s)) for _, s, *_ in mix],
                ergs=ERGS, entry_address=[e for e, *_ in mix],
                device=dev), 0
        cfg = units(storage(batch), ecrecover=True)
        mix = ec_programs.ecrecover_mix(8192)
        cache = {}
        progs = [cache.setdefault(s, assemble(s)) for _, s, *_ in mix]
        return cfg, make_entry_state(
            cfg, [progs[i % len(progs)] for i in range(batch)], ergs=ERGS,
            entry_address=ec_programs.EC, device=dev), 0

    out = {"card": card, "tree": args.tree, "build_s": build_s,
           "torch": torch.__version__}
    for name in ("a", "log", "precompile", "ec", "a4096", "log4096"):
        cfg, entry, warm_calls = case(name)
        pq = fused_cycle.new_pq_block(cfg, K, dev)
        warm = clone_state(entry)
        fused_cycle.cycle_chunk(warm, cfg, K, pq_block=pq)   # loads, warms
        del warm
        times, splice = [], None
        for _ in range(args.reps):
            st = clone_state(entry)
            for _ in range(warm_calls):
                fused_cycle.cycle_chunk(st, cfg, K, pq_block=pq)
            times.append(timed(lambda: fused_cycle.cycle_chunk(
                st, cfg, K, pq_block=pq)))
            if pq is not None:
                sp = clone_state(entry)
                splice = timed(lambda: fused_cycle.splice_precompile_rows(
                    sp, cfg, pq, K))
                del sp
            errors = int(st.lane_error.sum())
            del st
        out[name] = {"batch": cfg.batch, "ms": min(times), "ms_all": times,
                     "splice_ms": splice, "lane_errors": errors,
                     "threads": getattr(fused_cycle, "k1_threads",
                                        lambda b: 128)(cfg.batch)}
        del entry, pq
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
