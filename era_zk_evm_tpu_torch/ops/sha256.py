"""Batched SHA-256 compression in plain torch, on int32 words.

The counterpart of `era_zk_evm_tpu/ops/sha256.py`: one compression of a
64-byte block per lane, for the sha256 round-function precompile.  u32
words are carried as `torch.int32` (add, xor, and, or, not and shift left
give the same bits); a logical shift right is an arithmetic `>>` followed
by a mask.  The round constants and the IV are copies of
`era_zk_evm_tpu/golden/precompiles.py` (`SHA256_K`, `SHA256_IV`), held
equal by `tests/test_torch_sha256.py`; the CUDA kernels read the same
values from the header `_build.py` generates (`csrc/sha256.cuh`).
"""

from __future__ import annotations

import torch

SHA256_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
SHA256_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


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
