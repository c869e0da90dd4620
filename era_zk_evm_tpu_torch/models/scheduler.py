"""Continuous lane refill: block-scale transaction scheduling on the port.

The port of `era_zk_evm_tpu/models/scheduler.py`.  A block is a list of
transactions with very different cycle counts; the batched engine freezes a
lane when its transaction ends, so between chunks the lanes that finished
are refilled with the next pending transactions.  Per-transaction semantics
do not change: each transaction runs in a fresh VM context, exactly as if
it had its own lane from the start (`tests/test_torch_scheduler.py` holds
every `TxResult` equal to the JAX scheduler's).

The round protocol keeps the host off the device's critical path:
  1. launch one chunk (`run_cycles_fn`), then the round's status, one
     fixed-shape int32[2, B] tensor (done | lane_error << 1, cycle
     counters) whose copy to pinned memory starts at once;
  2. `spec_depth` chunks ride ahead of the status being read, so reading
     it waits only for an older chunk;
  3. rounds that want no refill end there;
  4. action rounds drain the witness queues (`drain_witness_queues_packed_
     async`: serialization, compaction and rewind queued on the device, the
     copies started) and queue a bucketed gather of the finished lanes'
     registers and net-state rows (copies started); both resolve once, after
     the last round.  The refilled lanes' fresh rows are built on the host
     for those lanes only, uploaded without a stream sync, and merged in
     place;
  5. queue-capacity pressure forces a drain before a launch that would not
     fit, from a host-side cycle count.

Only the packed stream form (`collect="packed"`) is ported.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..config import CS, VmConfig, precompile_queue_slots
from ..isa import params
from ..isa.assembler import assemble_to_code_words
from ..witness.packed import (
    RECORD_WORDS, HostCopy, drain_witness_queues_packed_async,
    log_join_columns,
)
from .net_states import event_entries_of, messages_from_join, storage_map_of
from .spill import QUEUE_FIELDS
from .state import (
    BOOL_FIELDS, DEFAULT_DEVICE, FIELD_NAMES, BatchedVmState, _empty_numpy,
    entry_arrays, populate_code_bank, populate_storage, state_from_numpy,
    to_device,
)

#: a transaction whose program is this sentinel finishes on its first cycle
#: (entry-frame ret with no returndata); used to pad lanes past the block
_NOOP_PROGRAM_ASM = "ret r0"


@dataclasses.dataclass
class TxSpec:
    """One transaction: an entry program plus its per-lane environment."""

    program: list[int]                      # code words (assembled)
    ergs: int = 1 << 27
    entry_address: int = 0x8001
    calldata: list[int] | None = None
    storage: tuple = ()                     # [(shard, address, key, value)]
    contracts: tuple = ()                   # [(stored_hash, code_words)]
    context_u128: int = 0                   # entry frame's context_u128_value
    #: optional relative cost estimate (any unit) consumed by the
    #: scheduler's order="cost_desc" policy; 0 = unknown
    cost_hint: int = 0


@dataclasses.dataclass
class TxResult:
    tx: int                                 # index into the block's tx list
    status: str                             # "ok" | "error"
    cycles: int                             # cycles this tx executed
    registers: np.ndarray                   # u32[15, 8] final register file
    streams: dict                           # {family: uint32[n, W] records}
    #: net outcomes at tx finish (get_final_net_states shape; None when the
    #: config has neither storage_slots nor event_slots)
    net_states: dict | None = None


def merge_lanes(state: BatchedVmState, fresh: BatchedVmState,
                lanes: torch.Tensor) -> BatchedVmState:
    """Replace the lanes `lanes` (an index tensor on the state's device) of
    `state` with the rows of `fresh`, a state of len(lanes) lanes, in
    place, field by field.  The witness queues and their clocks are not
    touched: the scheduler merges right after a drain, whose rewind has
    just left them as a fresh lane's (all zero), so `fresh` may be built
    with queue capacities of 0."""
    for name in FIELD_NAMES:
        if name not in QUEUE_FIELDS:
            getattr(state, name).index_copy_(0, lanes, getattr(fresh, name))
    return state


def _with_queues(config: VmConfig, lanes: BatchedVmState) -> BatchedVmState:
    """A full state from one built without queues: zero queue tensors of
    the config's shapes allocated on the device."""
    one = _empty_numpy(dataclasses.replace(config, batch=1))
    out = {}
    for name in FIELD_NAMES:
        t = getattr(lanes, name)
        if name in QUEUE_FIELDS:
            shape = one[name].shape
            shape = (shape[:-1] + (config.batch,) if name.startswith("wq_")
                     else (config.batch,) + shape[1:])
            t = torch.zeros(shape, device=t.device,
                            dtype=torch.bool if name in BOOL_FIELDS
                            else torch.int32)
        out[name] = t
    return BatchedVmState(**out)


def _round_status(state: BatchedVmState) -> HostCopy:
    """The whole per-round readback, one fixed-shape int32[2, B] tensor:
    row 0 = done | lane_error << 1, row 1 = monotonic_cycle_counter; its
    copy to the host starts at once."""
    return HostCopy({"status": (torch.stack([
        state.done.to(torch.int32) | (state.lane_error.to(torch.int32) << 1),
        state.monotonic_cycle_counter]),)})


#: pad sizes for the finished-lane gather: a handful of shapes instead of
#: one per finished-lane count
_FINALIZE_BUCKETS = (64, 256, 1024, 4096, 16384)


def _bucket(n: int, batch: int) -> int:
    for p in _FINALIZE_BUCKETS:
        if n <= p < batch:
            return p
    return batch


def _finalize_gather(state: BatchedVmState, idx: torch.Tensor, want_st: bool,
                     want_ev: bool) -> HostCopy:
    """A fixed-shape row gather of everything finalization needs for the
    `idx` lanes (padded to a bucket size; extra rows are ignored), its copy
    to the host started."""
    names = ["regs"]
    if want_st:
        names += ["st_key", "st_val", "st_used"]
    if want_ev:
        names += ["ev_meta", "ev_key", "ev_val", "ev_cancelled", "ev_count"]
    return HostCopy({name: (getattr(state, name).index_select(0, idx),)
                     for name in names})


def _drain_budget_cycles(config: VmConfig) -> int | None:
    """Cycles the enabled queue families can absorb between drains (None =
    no family enabled, never force a drain)."""
    budgets = []
    if config.queue_capacity:
        budgets.append(config.queue_capacity // 8)
    if config.log_queue_capacity:
        budgets.append(config.log_queue_capacity)
    if config.decommit_queue_capacity:
        budgets.append(config.decommit_queue_capacity)
    if config.precompile_queue_capacity:
        ps_in, ps_out = precompile_queue_slots(config)
        budgets.append(config.precompile_queue_capacity // (ps_in + ps_out))
    return min(budgets) if budgets else None


def _noop_program() -> list[int]:
    return assemble_to_code_words(_NOOP_PROGRAM_ASM)


def _build_entries(config: VmConfig, specs: list[TxSpec | None],
                   device: torch.device | str = DEFAULT_DEVICE
                   ) -> BatchedVmState:
    """The entry rows of len(specs) lanes, without witness queues (the
    config's queue capacities set to 0); `None` slots get the noop program.

    Per-lane ergs are patched in after the entry arrays are built (which
    take one scalar): both the entry frame's budget and the root frame's
    remainder.
    """
    for s in specs:
        if s is not None and not 0 <= s.ergs <= params.VM_INITIAL_FRAME_ERGS:
            raise ValueError(
                f"TxSpec.ergs {s.ergs} outside [0, VM_INITIAL_FRAME_ERGS="
                f"{params.VM_INITIAL_FRAME_ERGS}] — the root-frame carve "
                "would wrap")
    rows = dataclasses.replace(
        config, batch=len(specs), queue_capacity=0, log_queue_capacity=0,
        decommit_queue_capacity=0, precompile_queue_capacity=0)
    noop = _noop_program()
    progs = [s.program if s else noop for s in specs]
    any_calldata = any(s and s.calldata is not None for s in specs)
    calldata = ([(s.calldata if s else None) for s in specs]
                if any_calldata else None)
    entries = [s.entry_address if s else 0x8001 for s in specs]
    contexts = [s.context_u128 if s else 0 for s in specs]
    arrays = entry_arrays(rows, progs, ergs=0, entry_address=entries,
                          calldata=calldata, context_u128=contexts)
    ergs = np.array([s.ergs if s else 1 for s in specs], dtype=np.uint64)
    arrays["cs_scalars"][:, 1, CS["ergs_remaining"]] = ergs
    arrays["cs_scalars"][:, 0, CS["ergs_remaining"]] = \
        np.uint64(params.VM_INITIAL_FRAME_ERGS) - ergs
    fresh = state_from_numpy(arrays, device)
    if config.storage_slots > 0 and any(s and s.storage for s in specs):
        populate_storage(fresh, rows,
                         [list(s.storage) if s else [] for s in specs])
    if config.code_pages > 1 and any(s and s.contracts for s in specs):
        populate_code_bank(fresh, rows,
                           [list(s.contracts) if s else [] for s in specs])
    return fresh


def run_block_refill(config: VmConfig, txs: list[TxSpec], run_cycles_fn,
                     chunk: int, max_rounds: int = 100_000,
                     refill: bool = True, fresh_builder=None,
                     refill_frac: float = 0.125,
                     collect: str = "packed",
                     spec_depth: int = 2,
                     tail_chunk_mult: int = 1,
                     order: str = "arrival",
                     drain_compact_frac: float | dict | None = None,
                     adaptive_chunk: bool = False,
                     run_dyn_fn=None,
                     min_chunk: int = 8,
                     device: torch.device | str = DEFAULT_DEVICE,
                     ) -> tuple[list[TxResult], dict]:
    """Run a block of transactions over `config.batch` lanes with
    continuous refill, on `device`; the policy knobs, results and stats of
    `era_zk_evm_tpu.models.scheduler.run_block_refill`.

    `run_cycles_fn(state, config, n)` advances the state n cycles in place
    (`fused_cycle.run_cycles`).  `refill=False` runs batch-sized waves.
    `fresh_builder(specs)` maps a list of TxSpec (or None) to the entry
    rows of that many lanes, built without queues (default
    `_build_entries`); unlike the JAX builder it is given only the lanes
    being refilled.  `refill_frac`, `spec_depth`, `tail_chunk_mult`,
    `order` ("arrival" or "cost_desc"), `drain_compact_frac` (a float or a
    {family: fraction} dict) and `adaptive_chunk` with `run_dyn_fn` and
    `min_chunk` are pure policies: the `TxResult`s do not depend on them.
    `run_dyn_fn(state, config, n)` runs any n <= chunk without a new
    compile (`fused_cycle.run_cycles`: one kernel for every length).  Only
    `collect="packed"` is ported: TxResult.streams holds uint32 record
    arrays per family (`witness/packed.py`).

    Returns (results, stats); stats["lane_cycles"] counts every launched
    lane-cycle, so utilization = useful_cycles / lane_cycles, and
    stats["profile"] splits the host's time by step."""
    if collect != "packed":
        raise NotImplementedError(
            f"collect={collect!r}: only the packed streams are ported")
    B = config.batch
    if fresh_builder is None:
        def fresh_builder(sp):
            return _build_entries(config, sp, device)
    results: list[TxResult | None] = [None] * len(txs)
    next_tx = 0
    lane_tx = np.full((B,), -1, dtype=np.int64)
    specs: list[TxSpec | None] = [None] * B
    if order == "cost_desc":
        dispatch = list(np.argsort(
            -np.asarray([t.cost_hint for t in txs], dtype=np.int64),
            kind="stable"))
    elif order == "arrival":
        dispatch = list(range(len(txs)))
    else:
        raise ValueError(f"unknown order {order!r}")
    if adaptive_chunk and run_dyn_fn is None:
        raise ValueError("adaptive_chunk needs run_dyn_fn")
    #: adaptive-chunk bookkeeping: per-lane dispatched cost hint, cycles
    #: run since dispatch, and the cycles/hint calibration accumulators
    lane_hint = np.zeros((B,), dtype=np.float64)
    lane_run = np.zeros((B,), dtype=np.float64)
    calib_num = 0.0
    calib_den = 0.0
    for lane in range(B):
        if next_tx < len(txs):
            lane_tx[lane] = dispatch[next_tx]
            specs[lane] = txs[dispatch[next_tx]]
            lane_hint[lane] = txs[dispatch[next_tx]].cost_hint
            next_tx += 1
    state = _with_queues(config, fresh_builder(specs))
    drain_budget = _drain_budget_cycles(config)
    if drain_budget is not None and drain_budget < chunk:
        raise ValueError(
            f"chunk {chunk} exceeds the smallest queue family's capacity "
            f"({drain_budget} cycles)")
    cycles_since_drain = 0
    want_st = config.storage_slots > 0
    want_ev = config.event_slots > 0
    refill_threshold = max(1, int(refill_frac * B))

    def _launch(st, n, dyn=False):
        """Queue one n-cycle chunk and its status; nothing blocks."""
        st = (run_dyn_fn if dyn else run_cycles_fn)(st, config, n)
        return st, _round_status(st)

    # Deferred resolve: nothing a TxResult needs feeds back into
    # scheduling, so drains and finalize gathers are queued during the
    # rounds and resolved after the last one.  Only the newest
    # _MAX_DEVICE_DRAINS compacted drains keep their device budget arrays;
    # older ones start copying their valid rows (their counts have long
    # arrived) and let the arrays go.
    pending_drains: list = []      # [AsyncDrain, lane_tx snapshot]
    drains_started = 0
    pending_final: list = []       # per action round finalize payloads
    _MAX_DEVICE_DRAINS = 4

    def _drain(st):
        nonlocal drains_started
        st, drain = drain_witness_queues_packed_async(
            st, config, compact_frac=drain_compact_frac)
        pending_drains.append([drain, lane_tx.copy()])
        while len(pending_drains) - drains_started > _MAX_DEVICE_DRAINS:
            pending_drains[drains_started][0].start_rows()
            drains_started += 1
        return st

    prof = {"status_read": 0.0, "drain": 0.0, "finalize_enqueue": 0.0,
            "refill_python": 0.0, "builder": 0.0, "merge": 0.0,
            "launch": 0.0, "resolve": 0.0, "action_rounds": 0}

    #: launch index of the last chunk that preceded each lane's refill: a
    #: status tagged <= last_refill[lane] describes the former occupant
    last_refill = np.zeros((B,), dtype=np.int64)
    statuses: deque = deque()       # (HostCopy of the status, launch tag)
    launched = 0
    lane_cycles_total = 0
    rounds = 0
    can_escalate = tail_chunk_mult > 1 and (
        drain_budget is None or chunk * tail_chunk_mult <= drain_budget)
    if tail_chunk_mult > 1 and not can_escalate:
        import warnings

        warnings.warn(
            f"tail_chunk_mult={tail_chunk_mult} requested but the smallest "
            f"queue family only holds {drain_budget} cycles (chunk={chunk})"
            " — tail escalation disabled; size queue capacities to "
            "chunk*tail_chunk_mult to engage it", stacklevel=2)
    adaptive_launches = 0
    while rounds <= max_rounds:
        # keep `spec_depth` chunks in flight ahead of the status we pop
        while len(statuses) < max(1, spec_depth):
            n_next = (chunk * tail_chunk_mult
                      if (can_escalate and next_tx >= len(txs)) else chunk)
            use_dyn = False
            if adaptive_chunk and next_tx < len(txs) and calib_den > 0:
                est = lane_hint * (calib_num / calib_den) - lane_run
                running = (lane_tx >= 0) & (est > 0)
                if running.any():
                    horizon = np.quantile(est[running],
                                          min(refill_frac, 0.5))
                    # quantized to min_chunk multiples
                    n_dyn = int(np.clip(
                        -(-np.ceil(horizon) // min_chunk) * min_chunk,
                        min_chunk, chunk))
                    if n_dyn < chunk:
                        n_next, use_dyn = n_dyn, True
            # capacity pressure: the chunk about to launch must fit the
            # smallest enabled queue family.  A dynamic chunk reserves
            # `chunk` cycles, as the JAX scheduler does (its fused dynamic
            # chunk splices the full compiled extent); the port's writes
            # only n_next cycles of rows, so the reservation is a bound.
            if (drain_budget is not None
                    and cycles_since_drain
                    + (chunk if use_dyn else n_next) > drain_budget):
                state = _drain(state)
                cycles_since_drain = 0
            t0 = time.perf_counter()
            state, sd = _launch(state, n_next, dyn=use_dyn)
            prof["launch"] += time.perf_counter() - t0
            launched += 1
            rounds += 1
            adaptive_launches += use_dyn
            cycles_since_drain += n_next
            lane_run[lane_tx >= 0] += n_next
            lane_cycles_total += n_next * B
            statuses.append((sd, launched))
        sready, tag = statuses.popleft()
        t1 = time.perf_counter()
        status_mono = sready.wait()["status"][0].numpy()
        prof["status_read"] += time.perf_counter() - t1
        status, mono = status_mono[0], status_mono[1].view(np.uint32)
        occupied = lane_tx >= 0
        fresh_lane = last_refill >= tag      # refilled after this snapshot
        fin_mask = (status != 0) & occupied & ~fresh_lane
        any_running = bool((occupied
                            & ((status == 0) | fresh_lane)).any())
        if refill:
            free_after = B - int(occupied.sum()) + int(fin_mask.sum())
            act = ((next_tx < len(txs) and free_after >= refill_threshold)
                   or not any_running)
        else:
            act = not any_running
        if not act:
            continue

        prof["action_rounds"] += 1
        t0 = time.perf_counter()
        state = _drain(state)
        cycles_since_drain = 0
        t1 = time.perf_counter()
        prof["drain"] += t1 - t0

        finished = np.nonzero(fin_mask)[0]
        if finished.size:
            pad = _bucket(finished.size, B)
            idx = np.zeros((pad,), dtype=np.int64)
            idx[:finished.size] = finished
            gather = _finalize_gather(state, to_device(idx, state.done.device),
                                      want_st, want_ev)
            fin_tx = lane_tx[finished].copy()   # before refill rewrites it
            # cycles/hint calibration for the adaptive-chunk policy (mono is
            # each finished tx's final cycle count)
            fin_hints = np.array([txs[t].cost_hint for t in fin_tx],
                                 dtype=np.float64)
            hinted = fin_hints > 0
            calib_num += float(mono[finished][hinted].sum())
            calib_den += float(fin_hints[hinted].sum())
            pending_final.append({"gather": gather, "finished": finished,
                                  "fin_tx": fin_tx, "status": status,
                                  "mono": mono})
            lane_tx[finished] = -1
        t2 = time.perf_counter()
        prof["finalize_enqueue"] += t2 - t1

        if next_tx < len(txs):
            lanes = (np.nonzero(lane_tx < 0)[0] if refill
                     else np.arange(B))[:len(txs) - next_tx]
            rspecs = []
            for lane in lanes:
                rspecs.append(txs[dispatch[next_tx]])
                lane_tx[lane] = dispatch[next_tx]
                lane_hint[lane] = txs[dispatch[next_tx]].cost_hint
                lane_run[lane] = 0.0
                next_tx += 1
            t3 = time.perf_counter()
            prof["refill_python"] += t3 - t2
            if rspecs:
                fresh = fresh_builder(rspecs)
                t4 = time.perf_counter()
                prof["builder"] += t4 - t3
                merge_lanes(state, fresh, to_device(lanes.astype(np.int64),
                                                    state.done.device))
                # every status still in flight (tag <= launched) predates
                # this merge; the tag guard keeps those snapshots from
                # being trusted for the refilled lanes
                last_refill[lanes] = launched
                prof["merge"] += time.perf_counter() - t4

        if next_tx >= len(txs) and not (lane_tx >= 0).any():
            break
    else:
        raise RuntimeError("run_block_refill: max_rounds exhausted")

    # ------------------------------------------------------------------
    # Resolve everything deferred: the only waits of the whole block
    # beyond the per-round status words.
    # ------------------------------------------------------------------
    t0 = time.perf_counter()
    # packed-stream attribution, vectorized: every drain's valid rows in
    # order (drain-major, lane-major, slot) with a per-row tx id from the
    # drain-time lane -> tx snapshot, one stable argsort by tx id per
    # family, one split
    tx_packed: dict[int, dict[str, np.ndarray]] = {}
    fam_rows: dict[str, list] = {}
    fam_txid: dict[str, list] = {}
    for drain, ltx in pending_drains:
        for name, fam in drain.result().items():
            if drain.compact:
                rows_b, counts, count = fam
                rows = rows_b[:int(count)]
            else:
                words, valid = fam
                counts = valid.sum(axis=1)
                rows = words[valid]          # (lane, slot) order
            if not rows.shape[0]:
                continue
            fam_rows.setdefault(name, []).append(rows)
            fam_txid.setdefault(name, []).append(np.repeat(ltx, counts))
    for name in fam_rows:
        rows = np.concatenate(fam_rows[name], axis=0)
        txid = np.concatenate(fam_txid[name])
        keep = txid >= 0
        rows, txid = rows[keep], txid[keep]
        perm = np.argsort(txid, kind="stable")
        rows, txid = rows[perm], txid[perm]
        uniq, starts = np.unique(txid, return_index=True)
        for t, arr in zip(uniq, np.split(rows, starts[1:])):
            tx_packed.setdefault(int(t), {})[name] = arr

    for ent in pending_final:
        g = {name: ts[0].numpy() for name, ts in ent["gather"].wait().items()}
        g = {name: (a if a.dtype == bool or name == "ev_count"
                    else a.view(np.uint32)) for name, a in g.items()}
        status, mono = ent["status"], ent["mono"]
        for i, lane in enumerate(ent["finished"]):
            tx_i = int(ent["fin_tx"][i])
            tx_streams = tx_packed.get(tx_i, {})
            net = None
            if want_st or want_ev:
                entries = (event_entries_of(
                    g["ev_meta"], g["ev_key"], g["ev_val"],
                    g["ev_cancelled"], g["ev_count"], i)
                    if want_ev else [])
                lw = tx_streams.get(
                    "log", np.zeros((0, RECORD_WORDS["log"]), np.uint32))
                ts_c, addr_c, shard_c = log_join_columns(lw)
                ev, l1 = messages_from_join(
                    entries, dict(zip(ts_c.tolist(),
                                      zip(addr_c.tolist(),
                                          shard_c.tolist()))))
                net = {"final_storage":
                       (storage_map_of(g["st_key"], g["st_val"],
                                       g["st_used"], i) if want_st else {}),
                       "events": ev, "l1_messages": l1}
            results[tx_i] = TxResult(
                tx=tx_i, status="error" if (status[lane] & 2) else "ok",
                cycles=int(mono[lane]), registers=g["regs"][i],
                streams=tx_streams, net_states=net)
    prof["resolve"] = time.perf_counter() - t0
    assert all(r is not None for r in results)
    useful = sum(r.cycles for r in results)
    return results, {"rounds": rounds,
                     "lane_cycles": lane_cycles_total,
                     "useful_cycles": useful,
                     "adaptive_launches": adaptive_launches,
                     "utilization": useful / max(1, lane_cycles_total),
                     "profile": {k: (round(v, 4) if isinstance(v, float)
                                     else v) for k, v in prof.items()}}
