"""The rolling memory-queue commitment (spec v2, rate-packed) in plain torch.

Each lane folds its valid memory-query slots, in cycle-then-slot order,
into its keccak sponge.  Record 2i of a lane is XORed into u64 lanes 0..7,
record 2i+1 into lanes 8..15 and then the lane permutes; `wc_count & 1`
says which half the next record takes.  The record layout is
`era_zk_evm_tpu/witness/commitment.py::serialize_memory_query`, as the JAX
engine builds it (`era_zk_evm_tpu/models/batched_vm.py`, rolling block).

Two block forms carry the slots.  The dense one holds every slot of a
cycle, valid (bit 2 of its flags word) or not: `rolling_absorb` folds it,
the plain engine's in-cycle absorb.  The compacted one holds each lane's
valid slots alone in rows 0 .. count - 1, the block K1 writes for K2
(`csrc/cycle_kernel.cu`, `emit_block_rows`): `compact_slot_rows` is the
plain version of that write and `rolling_absorb_rows` the plain version of
the K2 kernel (`csrc/rolling_fold.cu`).

`finalize_rolling` is the port of
`era_zk_evm_tpu/witness/device_fold.py::finalize_rolling_device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.keccak import from_lanes, keccak_f1600_array, keccak_f1600_lanes, \
    to_lanes
from ..ops.u256 import M32, narrow, wide


def _bswap(x: torch.Tensor) -> torch.Tensor:
    return ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) \
        | ((x >> 8) & 0xFF00) | (x >> 24)


def slot_records(meta: torch.Tensor, value: torch.Tensor,
                 flags: torch.Tensor) -> torch.Tensor:
    """Slot block ([S, 4, B], [S, 8, B], [S, B]) -> int64[S, 8, B]: each
    slot's 64-byte record as eight little-endian u64 lanes."""
    ts, mtype, page, idx = (wide(meta[:, i]) for i in range(4))
    v = wide(value)
    fl = wide(flags) & 3
    lo = [None] * 8
    hi = [None] * 8
    lo[0] = _bswap(ts)
    hi[0] = (mtype & 0xFF) | (((page >> 24) & 0xFF) << 8) \
        | (((page >> 16) & 0xFF) << 16) | (((page >> 8) & 0xFF) << 24)
    lo[1] = (page & 0xFF) | (((idx >> 24) & 0xFF) << 8) \
        | (((idx >> 16) & 0xFF) << 16) | (((idx >> 8) & 0xFF) << 24)
    hi[1] = (idx & 0xFF) | (fl << 8)
    lo[2] = hi[2] = lo[3] = hi[3] = torch.zeros_like(ts)
    for k in range(4):
        lo[4 + k] = _bswap(v[:, 7 - 2 * k])
        hi[4 + k] = _bswap(v[:, 6 - 2 * k])
    return torch.stack([lo[k] | (hi[k] << 32) for k in range(8)], dim=1)


def _fold(wc_state: torch.Tensor, wc_count: torch.Tensor,
          records: torch.Tensor, valid: torch.Tensor) -> None:
    """Fold row s of `records` (int64[S, 8, B]) into lane b's sponge where
    valid[s, b], rows in order, in place."""
    lanes = to_lanes(wc_state)
    count = wide(wc_count)
    for s in range(records.shape[0]):
        par1 = (count & 1) != 0
        rec = records[s]
        even = valid[s] & ~par1
        wrap = valid[s] & par1
        lanes[0:8] ^= torch.where(even, rec, 0)
        lanes[8:16] ^= torch.where(wrap, rec, 0)
        if bool(wrap.any()):
            lanes = torch.where(wrap, keccak_f1600_lanes(lanes), lanes)
        count = (count + valid[s].to(torch.int64)) & M32
    wc_state.copy_(from_lanes(lanes))
    wc_count.copy_(narrow(count, torch.int32))


def rolling_absorb(wc_state: torch.Tensor, wc_count: torch.Tensor,
                   meta: torch.Tensor, value: torch.Tensor,
                   flags: torch.Tensor) -> None:
    """Fold the valid slots of a dense slot block into the sponges, in
    place.

    wc_state int32[B, 25, 2], wc_count int32[B]; slot i of lane b is valid
    where bit 2 of flags[i, b] is set.
    """
    _fold(wc_state, wc_count, slot_records(meta, value, flags),
          ((flags >> 2) & 1) != 0)


def compact_slot_rows(meta: torch.Tensor, value: torch.Tensor,
                      flags: torch.Tensor) -> tuple:
    """A dense slot block ([S, 4, B], [S, 8, B], [S, B]) -> the compacted
    block (meta, value, flags, count): each lane's valid slots, in slot
    order, in rows 0 .. count - 1 (a stable compaction by bit 2 of the
    flags), count int32[B]; the rows past a lane's count are zero."""
    valid = ((flags >> 2) & 1) != 0
    order = torch.argsort((~valid).to(torch.int8), dim=0, stable=True)
    count = valid.sum(0, dtype=torch.int32)
    rows = torch.arange(flags.shape[0], device=flags.device)
    keep = rows[:, None] < count[None, :]

    def take(x):    # x [S, B] or [S, n, B]
        idx, k = (order, keep) if x.dim() == 2 else (order[:, None],
                                                     keep[:, None])
        return torch.where(k, torch.gather(x, 0, idx.expand_as(x)), 0)

    return take(meta), take(value), take(flags), count


def rolling_absorb_rows(wc_state: torch.Tensor, wc_count: torch.Tensor,
                        meta: torch.Tensor, value: torch.Tensor,
                        flags: torch.Tensor, count: torch.Tensor) -> None:
    """Fold a compacted block into the sponges, in place: rows 0 ..
    count[b] - 1 of lane b are its records, in order; no other row is
    read.

    wc_state int32[B, 25, 2], wc_count int32[B]; meta [R, 4, B], value
    [R, 8, B], flags [R, B], count int32[B] with count <= R.
    """
    n = int(count.max()) if count.numel() else 0
    rows = torch.arange(n, device=count.device)
    _fold(wc_state, wc_count, slot_records(meta[:n], value[:n], flags[:n]),
          rows[:, None] < count[None, :])


def finalize_rolling(wc_state: torch.Tensor,
                     wc_count: torch.Tensor) -> torch.Tensor:
    """Finalize per-lane sponges: int32[B, 25, 2], int32[B] -> int32[B, 8],
    the 32-byte digests as 8 little-endian u32 words."""
    st = wc_state.clone()
    st[:, 16, 0] ^= wc_count
    st[:, 16, 1] ^= -(1 << 31)      # 0x80 << 56 of the u64 lane
    st = keccak_f1600_array(st)
    return st[:, :4, :].reshape(st.shape[0], 8)


def digests_to_bytes(rows: torch.Tensor) -> list[bytes]:
    """Host helper: int32[B, 8] digest rows -> 32-byte digests."""
    a = rows.detach().cpu().numpy().astype(np.int32).view(np.uint32)
    return [b"".join(int(w).to_bytes(4, "little") for w in row) for row in a]
