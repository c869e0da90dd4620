"""Goldilocks field (p = 2^64 - 2^32 + 1) reduction on u32 halves.

The port of `era_zk_evm_tpu/ops/goldilocks.py` as far as the packed grand
products need it: the field's modulus and the reduction of a full u64 given
as (lo, hi) u32 halves, here int64 tensors holding values in [0, 2^32).
"""

from __future__ import annotations

import torch

from .u256 import M32

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1


def gl_reduce64(lo: torch.Tensor, hi: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A full u64 (lo, hi) mod p: at most one subtraction of p.

    p's halves are (1, 2^32 - 1), so x >= p exactly when hi is all ones and
    lo >= 1, and then x - p = (lo - 1, 0).
    """
    ge = (hi == M32) & (lo >= 1)
    return torch.where(ge, lo - 1, lo), torch.where(ge, 0, hi)
