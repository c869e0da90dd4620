"""Batched keccak-f[1600] in plain torch.

The counterpart of `era_zk_evm_tpu/ops/keccak.py::keccak_f1600_array`:
states are `int32[B, 25, 2]` (`[..., 0]` = low u32, `[..., 1]` = high u32 of
each u64 lane, flat index x + 5y).  Inside, each u64 lane is one int64 that
holds its bit pattern, and every round step runs over all 25 lanes at once.
"""

from __future__ import annotations

import torch

from era_zk_evm_tpu.golden.precompiles import KECCAK_RC, KECCAK_ROTATIONS

from .u256 import M32, narrow

_RC = [c - (1 << 64) if c >= 1 << 63 else c for c in KECCAK_RC]
# rho + pi: lane s moves to y + 5 * ((2x + 3y) % 5); gather form
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_ROT_SRC = [KECCAK_ROTATIONS[s] for s in _PI_SRC]


def _rotl(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rotate int64 bit patterns left by r (0 <= r < 64, per row)."""
    low_mask = (torch.ones_like(r) << r) - 1
    return (x << r) | ((x >> (64 - r)) & low_mask)


def to_lanes(state: torch.Tensor) -> torch.Tensor:
    """int32[B, 25, 2] -> int64[25, B] u64 bit patterns."""
    lo = state[..., 0].to(torch.int64) & M32
    hi = state[..., 1].to(torch.int64)
    return (lo | (hi << 32)).T.contiguous()


def from_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """int64[25, B] -> int32[B, 25, 2]."""
    lo = narrow(lanes & M32, torch.int32)
    hi = narrow((lanes >> 32) & M32, torch.int32)
    return torch.stack([lo.T, hi.T], dim=-1)


def keccak_f1600_lanes(a: torch.Tensor) -> torch.Tensor:
    """One permutation over int64[25, B] lanes."""
    dev = a.device
    one = torch.ones((5, 1), dtype=torch.int64, device=dev)
    rot = torch.tensor(_ROT_SRC, dtype=torch.int64, device=dev)[:, None]
    pi = torch.tensor(_PI_SRC, dtype=torch.int64, device=dev)
    for rc in _RC:
        # theta
        s = a.view(5, 5, -1)
        c = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4]                  # [5(x), B]
        d = c.roll(1, 0) ^ _rotl(c.roll(-1, 0), one)
        a = (s ^ d[None]).view(25, -1)
        # rho + pi
        b = _rotl(a[pi], rot).view(5, 5, -1)
        # chi
        a = (b ^ (~b.roll(-1, 1) & b.roll(-2, 1))).reshape(25, -1)
        # iota
        a[0] ^= rc
    return a


def keccak_f1600_array(state: torch.Tensor) -> torch.Tensor:
    """Permutation over packed states int32[B, 25, 2]."""
    return from_lanes(keccak_f1600_lanes(to_lanes(state)))
