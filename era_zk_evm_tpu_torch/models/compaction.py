"""Journal and event-queue compaction between calls.

The port of `era_zk_evm_tpu/models/compaction.py`.  The storage journal
(`j_slot`/`j_prev`) exists only to replay rollbacks when a frame panics;
entries below the lowest live frame's snapshot can never be replayed, and
cancelled events below it are in no observable.  `compact_log_state` drops
both, shifts the kept entries down in order and adjusts the counts and every
frame's snapshots, so a bounded `journal_slots` / `event_slots` serves a long
run when it is called between `run_cycles` segments.  It runs in plain torch
between calls; it is not a kernel.  It works on the reference-layout views
of the arrays (`state.reference_view`).
"""

from __future__ import annotations

import torch

from ..config import CS, VmConfig
from .state import BatchedVmState, reference_view


def _stable_filter(keep: torch.Tensor, arrs: list[torch.Tensor]) -> list:
    """Kept rows of each [B, N, ...] array moved to the front, order kept,
    the tail zeroed."""
    B, N = keep.shape
    newpos = torch.cumsum(keep, 1) - keep.to(torch.int64)
    dest = torch.where(keep, newpos, N)          # dropped rows -> row N
    lanes = torch.arange(B, device=keep.device)[:, None].expand(B, N)
    outs = []
    for arr in arrs:
        out = torch.zeros((B, N + 1) + arr.shape[2:], dtype=arr.dtype,
                          device=arr.device)
        out[lanes, dest] = arr
        outs.append(out[:, :N])
    return outs


def _dropped_below(keep: torch.Tensor, snaps: torch.Tensor) -> torch.Tensor:
    """The number of dropped entries strictly below each snapshot position:
    keep bool[B, N], snaps int64[B, D] -> int64[B, D]."""
    N = keep.shape[1]
    cum = torch.cumsum(~keep, 1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], 1)   # [B, N + 1]
    return torch.gather(cum, 1, snaps.clamp(0, N))


def compact_log_state(state: BatchedVmState, config: VmConfig,
                      base_depth: int = 1) -> BatchedVmState:
    """Drop dead journal entries and cancelled events; shift the rest down.

    Updates `state` in place and returns it.  Every future rollback is kept
    (entries at or above the lowest live snapshot stay, in order), and so is
    every final observable.  `base_depth` is the caller's promise that
    frames at depth <= base_depth never revert in part: the live minimum is
    taken over deeper frames only, so with only base frames live the whole
    journal goes.
    """
    if config.journal_slots == 0:
        return state
    stored, state = state, reference_view(state)   # writes land in stored
    dev = state.depth.device
    J, E, D = config.journal_slots, config.event_slots, config.max_depth
    pos_j = torch.arange(J, device=dev)[None, :]
    pos_e = torch.arange(E, device=dev)[None, :]
    d_pos = torch.arange(D, device=dev)[None, :]
    depth = state.depth.to(torch.int64)
    live = (d_pos > base_depth) & (d_pos <= depth[:, None])
    # the snapshots as the JAX engine reads them: u32 taken as int32
    j_snaps = state.cs_scalars[:, :, CS["journal_snapshot"]].to(torch.int64)
    ev_snaps = state.cs_scalars[:, :, CS["event_snapshot"]].to(torch.int64)
    j_count = state.j_count.to(torch.int64)
    ev_count = state.ev_count.to(torch.int64)
    big = 1 << 30
    j_min = torch.minimum(torch.where(live, j_snaps, big).min(1).values,
                          j_count)
    ev_min = torch.minimum(torch.where(live, ev_snaps, big).min(1).values,
                           ev_count)

    # journal: everything below the lowest live snapshot is unreachable
    j_keep = (pos_j >= j_min[:, None]) & (pos_j < j_count[:, None])
    new_j_slot, new_j_prev = _stable_filter(j_keep,
                                            [state.j_slot, state.j_prev])
    new_j_snaps = torch.minimum(j_snaps.clamp(min=0), j_count[:, None]) \
        - _dropped_below(j_keep, j_snaps)

    # events: cancelled entries below the lowest live snapshot are dead
    ev_keep = (pos_e < ev_count[:, None]) \
        & (~state.ev_cancelled | (pos_e >= ev_min[:, None]))
    new_ev_key, new_ev_val, new_ev_meta, new_ev_cancelled = _stable_filter(
        ev_keep, [state.ev_key, state.ev_val, state.ev_meta,
                  state.ev_cancelled])
    new_ev_snaps = torch.minimum(ev_snaps.clamp(min=0), ev_count[:, None]) \
        - _dropped_below(ev_keep, ev_snaps)

    state.j_slot.copy_(new_j_slot)
    state.j_prev.copy_(new_j_prev)
    state.j_count.copy_(j_keep.sum(1).to(torch.int32))
    state.ev_key.copy_(new_ev_key)
    state.ev_val.copy_(new_ev_val)
    state.ev_meta.copy_(new_ev_meta)
    state.ev_cancelled.copy_(new_ev_cancelled)
    state.ev_count.copy_(ev_keep.sum(1).to(torch.int32))
    # stored back as u32 bits, as the JAX engine's astype(U32)
    state.cs_scalars[:, :, CS["journal_snapshot"]] = new_j_snaps.to(
        torch.int32)
    state.cs_scalars[:, :, CS["event_snapshot"]] = new_ev_snaps.to(
        torch.int32)
    return stored
