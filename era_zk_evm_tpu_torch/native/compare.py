"""Lanes of an engine's state held against the native oracle's results.

One comparison for every engine of the port (the plain engine, K1's g++
host build, K1 on the card): `compare_lanes(state, oracle_results, lanes)`
reads only the named lanes off the state's device and returns the list of
differences, empty when the lanes agree, and the number of lanes compared
in full.  The observables are the oracle's result dict: status, cycles,
registers and pointer tags, flags, the entry frame's heap, and the memory,
log and decommit witness streams byte for byte (each where the state's
config queues it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.state import (
    FIELD_NAMES, LANE_AXIS, BatchedVmState, state_to_numpy,
)
from ..utils import from_limbs
from ..witness import packed
from . import ST_DONE, ST_MAX_CYCLES, ST_OOB, ST_UNSUPPORTED


def lane_subset(state: BatchedVmState, lanes) -> BatchedVmState:
    """The named lanes of `state`, in that order, as a state on the CPU."""
    dev = state.regs.device
    idx = torch.as_tensor(list(lanes), dtype=torch.int64, device=dev)
    return BatchedVmState(**{
        name: getattr(state, name).index_select(
            LANE_AXIS[name] % getattr(state, name).dim(), idx).cpu()
        for name in FIELD_NAMES})


def device_status(done: bool, lane_error: bool) -> tuple[int, ...]:
    """The oracle statuses a lane's `done` and `lane_error` stand for: an
    engine flags an out-of-bounds access and an unsupported opcode alike."""
    if lane_error:
        return (ST_UNSUPPORTED, ST_OOB)
    return (ST_DONE,) if done else (ST_MAX_CYCLES,)


def _records(words: np.ndarray, valid: np.ndarray, b: int) -> list[bytes]:
    """Lane b's valid record rows as serialized bytes."""
    return [r.astype("<u4").tobytes() for r in words[b][valid[b]]]


def compare_lanes(state: BatchedVmState, oracle_results: list[dict],
                  lanes) -> tuple[list[str], int]:
    """Differences between lane `lanes[i]` of `state` and
    `oracle_results[i]` (a `run_oracle` result), as readable strings, and
    the number of lanes compared on every observable.  A lane that finished
    or ran out of cycles as the oracle's did is compared in full (the
    engine run for the oracle's `max_cycles`, both stop at one cycle); a
    lane whose status differs, or that stopped on an error as the oracle's
    did, on its status alone."""
    lanes = list(lanes)
    if len(lanes) != len(oracle_results):
        raise ValueError(f"{len(lanes)} lanes for {len(oracle_results)} "
                         f"oracle results")
    sub = lane_subset(state, lanes)
    got = state_to_numpy(sub)
    mem = log = None
    if got["wq_flags"].shape[0]:
        mem = [x.numpy() for x in packed.memory_record_words(sub)]
        mem[0] = mem[0].view(np.uint32)
    if got["lq_meta"].shape[1]:
        log = [x.numpy() for x in packed.log_record_words(sub)]
        log[0] = log[0].view(np.uint32)
    diffs, full = [], 0
    for b, (lane, want) in enumerate(zip(lanes, oracle_results)):
        def differ(what, mine, theirs):
            diffs.append(f"lane {lane}: {what}: engine {mine!r} != oracle "
                         f"{theirs!r}")

        statuses = device_status(bool(got["done"][b]),
                                 bool(got["lane_error"][b]))
        if want["status"] not in statuses:
            differ("status", statuses, want["status"])
            continue
        if want["status"] in (ST_UNSUPPORTED, ST_OOB):
            continue
        full += 1
        cycles = int(got["monotonic_cycle_counter"][b])
        if cycles != want["cycles"]:
            differ("cycles", cycles, want["cycles"])
        for i in range(15):
            value = from_limbs(got["regs"][b, i])
            if value != want["registers"][i]:
                differ(f"r{i + 1}", value, want["registers"][i])
            tag = bool(got["reg_ptr"][b, i])
            if tag != want["reg_ptr"][i]:
                differ(f"r{i + 1} pointer tag", tag, want["reg_ptr"][i])
        flags = tuple(bool(x) for x in got["flags"][b])
        if flags != want["flags"]:
            differ("flags", flags, want["flags"])
        heap = [from_limbs(got["heap"][b, i])
                for i in range(len(want["heap"]))]
        if heap != want["heap"]:
            bad = [i for i, (x, y) in enumerate(zip(heap, want["heap"]))
                   if x != y]
            differ(f"heap words {bad}", [heap[i] for i in bad],
                   [want["heap"][i] for i in bad])
        for what, rows, key in (("memory", mem, "witness_records"),
                                ("log", log, "log_records")):
            if rows is None:
                continue
            mine, theirs = _records(*rows, b), want[key]
            if mine != theirs:
                first = next((i for i, (x, y) in enumerate(zip(mine, theirs))
                              if x != y), min(len(mine), len(theirs)))
                differ(f"{what} records from row {first} (rows)", len(mine),
                       len(theirs))
        if got["dq_meta"].shape[1]:
            # one decommit row a cycle, valid ones flagged by bit 0
            meta, h = got["dq_meta"][b], got["dq_hash"][b]
            rows = np.flatnonzero(meta[:, 3] & 1)
            mine = [(from_limbs(h[i]), int(meta[i, 0]), int(meta[i, 1]),
                     int(meta[i, 2]), bool(meta[i, 3] & 2)) for i in rows]
            theirs = [(d["hash"], d["timestamp"], d["page"], d["length"],
                       d["is_fresh"]) for d in want["decommit_records"]]
            if len(rows) != int(got["dq_count"][b]):
                differ("decommit count", int(got["dq_count"][b]), len(rows))
            if mine != theirs:
                differ("decommit records", mine, theirs)
    return diffs, full
