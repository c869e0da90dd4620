"""Device-side commitment finalization and the block fold.

The port of `era_zk_evm_tpu/witness/device_fold.py`:

  * `finalize_rolling_device` — per-lane finalization of the rolling
    memory-queue commitment (`wc_state` / `wc_count`) into u32[B, 8]
    digest rows, the batched form of `commitment.device_rolling_commitments`
    (`rolling.finalize_rolling`);
  * `keccak256_device_stream` — keccak256 over N concatenated 32-byte
    digest rows in lane order, the device form of
    `commitment.block_commitment`: one stream through the ragged sponge
    (`ops.keccak.keccak256_ragged`, `csrc/keccak_sponge.cu` on the card);
  * `digest_rows_to_bytes` — the rows as 32-byte digests on the host.
"""

from __future__ import annotations

import torch

from ..ops.keccak import keccak256_ragged
from .rolling import digests_to_bytes as digest_rows_to_bytes  # noqa: F401
from .rolling import finalize_rolling as finalize_rolling_device  # noqa: F401


def keccak256_device_stream(rows: torch.Tensor) -> torch.Tensor:
    """keccak256 over concatenated 32-byte rows -> digest int32[8].

    rows: int32[N, 8], each row one 32-byte record in little-endian u32
    words (the `finalize_rolling_device` form).  Equals
    `keccak256(b"".join(row bytes))`: one launch of the sponge over one
    stream of 8N words on the card, its plain version on the CPU."""
    n = rows.shape[0]
    offsets = torch.tensor([0, 8 * n], dtype=torch.int64).to(rows.device)
    return keccak256_ragged(rows.contiguous().reshape(-1), offsets)[0]
