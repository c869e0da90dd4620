"""Batched SHA-256 compression in plain torch, on int32 words.

The counterpart of `era_zk_evm_tpu/ops/sha256.py`: one compression of a
64-byte block per lane, for the sha256 round-function precompile.  u32
words are carried as `torch.int32` (add, xor, and, or, not and shift left
give the same bits); a logical shift right is an arithmetic `>>` followed
by a mask.  The round constants and the IV are the port's golden oracle's
(`golden/precompiles.py`: `SHA256_K`, `SHA256_IV`); the CUDA kernels read
the same values from the header `_build.py` generates (`csrc/sha256.cuh`).
"""

from __future__ import annotations

import torch

from ..golden.precompiles import SHA256_IV, SHA256_K


def _i32(v: int) -> int:
    """A u32 constant as the int32 with the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (32 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (32 - n))


def sha256_compress_batched(state: torch.Tensor,
                            block: torch.Tensor) -> torch.Tensor:
    """One compression per lane: state int32[B, 8], block int32[B, 16]
    (the big-endian words of the 64-byte block) -> int32[B, 8]."""
    w = [block[:, i] for i in range(16)]
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ _shr(w[i - 15], 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ _shr(w[i - 2], 10)
        w.append(w[i - 16] + s0 + w[i - 7] + s1)
    a, b, c, d, e, f, g, h = (state[:, i] for i in range(8))
    for i in range(64):
        s1r = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1r + ch + _i32(SHA256_K[i]) + w[i]
        s0r = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = t1 + s0r + maj, a, b, c, d + t1, e, f, g
    return state + torch.stack([a, b, c, d, e, f, g, h], dim=1)


def sha256_iv(batch: int, device: torch.device | str = torch.device("cuda")
              ) -> torch.Tensor:
    """The IV for `batch` lanes, int32[batch, 8]."""
    iv = torch.tensor([_i32(v) for v in SHA256_IV], dtype=torch.int32,
                      device=device)
    return iv.expand(batch, 8).clone()


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Hash n pre-padded blocks a lane: int32[B, n, 16] (big-endian words)
    -> states int32[B, 8], on the blocks' device."""
    B, n, _ = blocks.shape
    state = sha256_iv(B, device=blocks.device)
    for i in range(n):
        state = sha256_compress_batched(state, blocks[:, i])
    return state
