"""The block pipeline's commitment phase on the card, apart from the
scheduler, for comparing two trees of the port on one card.

    python era_zk_evm_tpu_torch/tools/commit_times.py [--tree DIR]
        [--phases tiny,precompile,ecrecover,realistic] [--out FILE]

`--tree DIR` imports `era_zk_evm_tpu_torch` and `chip_smoke.py` from DIR
(another checkout of the repository, e.g. the parent commit unpacked with
`git archive`) in place of this one.  For each phase it builds that tree's
block as `chip_smoke.py` does (bench_block's geometry and knobs, B = 4096,
8192 txs of the tiny, precompile, signed-transfer or realistic mix), runs
`execute_block` once to warm up and to get the txs' results, then:

  * the whole block again, synchronised: its wall, and under
    `torch.profiler` (device activity only) its device busy time and
    items;
  * the commitment phase alone on those results: the tree's
    `block.commit_block` where it has one, else the three calls that
    `execute_block` made before it (per-family digests, per-family folds,
    the sorted-log grand products) — its host wall (best of 3,
    synchronised), and under the profiler its device busy time, the
    keccak kernels' time and launches, the `cat` / `where` / compare
    kernels, the host-to-device copies and every device item;
  * the grand products alone (the same code in every tree), timed;
  * the sponge's block counts per family: the real blocks (a stream of n
    words absorbs n // 34 + 1), the blocks once each stream is padded to a
    power of two (the bucketed sponge), the longest stream's, and the
    fold's.

One JSON line per phase, with the card's name and power limit; `--out`
also writes them to FILE.  A block item's name is cut to 90 characters.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

#: device items by kind: (kind, substrings of the kernel's name)
KINDS = (("k3", ("k3_kernel",)), ("sponge", ("k3s_kernel",)),
         ("cat", ("CatArray",)), ("where", ("where",)),
         ("compare", ("ompare",)), ("h2d", ("Memcpy HtoD",)),
         ("d2h", ("Memcpy DtoH",)))


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]),
                    help="import the port and chip_smoke.py from this "
                         "checkout (default: the one holding this script)")
    ap.add_argument("--phases", default="tiny,realistic")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("commit_times: no CUDA card")
    import chip_smoke as cs
    from era_zk_evm_tpu_torch import _build, block
    from era_zk_evm_tpu_torch.ops import keccak
    from era_zk_evm_tpu_torch.testing import ec_programs
    from era_zk_evm_tpu_torch.witness import packed

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.load()

    def launches() -> dict:
        return {"K3": keccak.K3_LAUNCHES,
                "sponge": getattr(keccak, "K3S_LAUNCHES", 0)}

    def commit(config, results):
        if hasattr(block, "commit_block"):
            return block.commit_block(config, results, dev)
        # the parent's commitment phase, as its execute_block ran it
        families = block._families(config)
        tx_commitments = [dict() for _ in results]
        for name in families:
            w = packed.RECORD_WORDS[name]
            per_tx = [r.streams.get(name, np.zeros((0, w), np.uint32))
                      for r in results]
            for c, d in zip(tx_commitments,
                            packed.commit_packed_streams(per_tx, dev)):
                c[name] = d
        commitments = {name: packed.fold_digests_device(
            [c[name] for c in tx_commitments], dev) for name in families}
        logs = [r.streams.get("log", np.zeros((0, 32), np.uint32))
                for r in results]
        return (tx_commitments, commitments,
                packed.packed_grand_products(logs, device=dev))

    def profile(fn) -> dict:
        torch.cuda.synchronize()
        before = launches()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = launches()
        items = [(e.key, e.self_device_time_total, e.count)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(t for _, t, _ in items)
        kinds = {}
        for kind, subs in KINDS:
            sel = [(t, c) for k, t, c in items if any(s in k for s in subs)]
            kinds[kind] = {"ms": round(sum(t for t, _ in sel) / 1e3, 3),
                           "count": sum(c for _, c in sel)}
        return {"profiled_wall_s": round(wall, 4),
                "device_busy_ms": round(busy / 1e3, 3),
                "device_items": sum(c for _, _, c in items),
                "launches": {k: after[k] - before[k] for k in after},
                "kinds": kinds,
                "top": [[k[:90], round(t / 1e3, 3), c] for k, t, c in
                        sorted(items, key=lambda x: -x[1])[:14]]}

    def block_counts(config, results) -> dict:
        out = {}
        for name in block._families(config):
            nbs = [int(r.streams[name].size) * 4 // 136 + 1
                   if name in r.streams else 1 for r in results]
            fold = (32 * len(results)) // 136 + 1
            out[name] = {"streams": len(nbs), "blocks": sum(nbs),
                         "bucketed_blocks": sum(_bucket(n) for n in nbs),
                         "longest": max(nbs), "fold_blocks": fold,
                         "fold_bucketed": _bucket(fold)}
        return out

    lines = []
    for name in args.phases.split(","):
        if name == "realistic":
            config = cs.block_config(cs.B_BLOCK, chunk=cs.REALISTIC_CHUNK)
            knobs = dict(cs.BLOCK_KNOBS, chunk=cs.REALISTIC_CHUNK)
            txs = cs.mix_txs("realistic", cs.REALISTIC_TXS)
        else:
            unit = name in ("precompile", "ecrecover")
            config = cs.block_config(cs.B_BLOCK, precompile=unit,
                                     ecrecover=name == "ecrecover")
            knobs = dict(cs.BLOCK_KNOBS)
            if unit:
                knobs["drain_compact_frac"] = dict(
                    knobs["drain_compact_frac"], precompile=0.25)
            txs = (cs.as_txs(ec_programs.ecrecover_mix(2 * cs.B_BLOCK))
                   if name == "ecrecover"
                   else cs.mix_txs(name, 2 * cs.B_BLOCK))
        blk = block.execute_block(config, txs, device=dev, **knobs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blk = block.execute_block(config, txs, device=dev, **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        whole = profile(lambda: block.execute_block(config, txs, device=dev,
                                                    **knobs))
        results = blk.txs
        got = commit(config, results)
        if (got[0], got[1], got[2]) != (blk.tx_commitments, blk.commitments,
                                        blk.sorted_log_products):
            raise AssertionError(f"{name}: the commitment phase alone "
                                 f"differs from execute_block's")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            commit(config, results)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        phase = profile(lambda: commit(config, results))
        logs = [r.streams.get("log", np.zeros((0, 32), np.uint32))
                for r in results]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed.packed_grand_products(logs, device=dev)
        torch.cuda.synchronize()
        products_s = time.perf_counter() - t0
        line = {"card": card, "tree": args.tree, "phase": f"block-{name}",
                "txs": len(txs), "block_wall_s": round(wall, 4),
                "block": whole, "commit_wall_s": [round(w, 4) for w in walls],
                "commit": phase, "products_wall_s": round(products_s, 4),
                "sponge_blocks": block_counts(config, results)}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del blk, results
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return lines


if __name__ == "__main__":
    main()
