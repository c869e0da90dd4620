"""A wave of transactions, one per lane, run to its end with packed drains.

The witness path of the log family end to end, as the smoke run drives it on
the card and the tests drive it on the CPU: every lane runs its own program
in `segment`-cycle calls of `fused_cycle.run_cycles`, each call followed by a
packed drain of the witness queues (`witness/packed.py`), until every lane is
done.  `wave_commitments` then computes what a block reports: each lane's
keccak256 digest per queue family, the block folds over them, each lane's
sorted-log grand product and the block's product.  The scheduler that refills
lanes with further transactions is not part of this module.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import fused_cycle
from ..witness import packed

#: segments after which a lane still running is an error
MAX_SEGMENTS = 64


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_wave(state, config, segment: int, compact_frac=None,
             times: dict | None = None) -> dict:
    """Run every lane to its end; returns {family: per-lane uint32[n, W]
    record arrays in emission order}.  Raises if a lane is still running
    after MAX_SEGMENTS calls.  With `times` given, the seconds spent in
    the engine and in the drains are added to times["engine"] and
    times["drains"] (the device is synchronised at each boundary)."""
    device = state.done.device
    families = packed.queue_families(config)
    parts = {name: [[] for _ in range(config.batch)] for name in families}
    for _ in range(MAX_SEGMENTS):
        t0 = time.perf_counter()
        fused_cycle.run_cycles(state, config, segment, k_inner=segment)
        if times is not None:
            _sync(device)
            times["engine"] = times.get("engine", 0.0) \
                + time.perf_counter() - t0
        t0 = time.perf_counter()
        _, drained = packed.drain_witness_queues_packed(state, config,
                                                        compact_frac)
        if compact_frac is None:
            per_family = {name: packed.split_records_by_lane(*rec)
                          for name, rec in
                          packed.fetch_dense_records(drained).items()}
        else:
            per_family = {name: packed.split_compacted_by_lane(
                              rows, counts, int(count))
                          for name, (rows, counts, count) in
                          packed.fetch_compacted_rows(drained).items()}
        for name, lanes in per_family.items():
            for b, rows in enumerate(lanes):
                if rows.shape[0]:
                    parts[name][b].append(rows)
        all_done = bool(state.done.all())
        if times is not None:
            times["drains"] = times.get("drains", 0.0) \
                + time.perf_counter() - t0
        if all_done:
            return {name: [np.concatenate(p) if p else
                           np.zeros((0, packed.RECORD_WORDS[name]), np.uint32)
                           for p in lanes] for name, lanes in parts.items()}
    raise RuntimeError(f"lanes still running after {MAX_SEGMENTS} segments")


def wave_commitments(streams: dict, device, times: dict | None = None
                     ) -> dict:
    """Per-lane digests per family, the block folds, per-lane log grand
    products and the block product.  With `times` given, the seconds of the
    digests, the fingerprints (on `device`) and the host mulmods are added
    under those names."""
    out = {}
    t0 = time.perf_counter()
    out["digests"] = {name: packed.commit_packed_streams(lanes, device)
                      for name, lanes in streams.items()}
    out["folds"] = {name: packed.fold_digests_device(d, device)
                    for name, d in out["digests"].items()}
    t1 = time.perf_counter()
    logs = streams.get("log", [])
    fp = packed.log_fingerprints(logs, device)
    t2 = time.perf_counter()
    out["products"] = packed.grand_products_from_fingerprints(
        fp, [s.shape[0] for s in logs])
    out["block_product"] = packed.block_grand_product(out["products"])
    t3 = time.perf_counter()
    if times is not None:
        for name, dt in (("digests", t1 - t0), ("fingerprints", t2 - t1),
                         ("mulmods", t3 - t2)):
            times[name] = times.get(name, 0.0) + dt
    return out
