"""The rolling memory-queue commitment (spec v2, rate-packed) in plain torch.

`rolling_absorb` is the plain version of the K2 kernel
(`csrc/rolling_fold.cu`): it folds a block of memory-query slots, in slot
order, into each lane's keccak sponge.  Record 2i of a lane is XORed into
u64 lanes 0..7, record 2i+1 into lanes 8..15 and then the lane permutes;
`wc_count & 1` says which half the next record takes.  The record layout is
`era_zk_evm_tpu/witness/commitment.py::serialize_memory_query`, as the JAX
engine builds it (`era_zk_evm_tpu/models/batched_vm.py`, rolling block).

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


def rolling_absorb(wc_state: torch.Tensor, wc_count: torch.Tensor,
                   meta: torch.Tensor, value: torch.Tensor,
                   flags: torch.Tensor) -> None:
    """Fold the valid slots of a slot block into the sponges, in place.

    wc_state int32[B, 25, 2], wc_count int32[B]; slot i of lane b is valid
    where bit 2 of flags[i, b] is set.
    """
    records = slot_records(meta, value, flags)
    valid = ((flags >> 2) & 1) != 0
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
