"""Batched keccak-f[1600]: the K3 kernel's wrapper and its plain torch version.

The counterpart of `era_zk_evm_tpu/ops/keccak.py`: states are
`int32[N, 25, 2]` (`[..., 0]` = low u32, `[..., 1]` = high u32 of each u64
lane, flat index x + 5y).  `keccak_f1600(states, iters)` applies `iters`
chained permutations: on a CUDA tensor it launches K3
(`csrc/keccak_f.cu`), which replaces both TPU kernels
`keccak_f1600_bitsliced` (K3) and `keccak_f1600_pallas` (K4); on a CPU
tensor it runs the plain version `keccak_f1600_plain` (`keccak_f1600_array`
chained `iters` times).  `keccak_f1600_` does the same in place.
`K3_LAUNCHES` counts kernel launches.  Inside the plain version each u64
lane is one int64 that holds its bit pattern, and every round step runs over
all 25 lanes at once.
"""

from __future__ import annotations

import ctypes

import torch

from .u256 import M32, narrow

#: iota round constants (FIPS 202), a copy of
#: era_zk_evm_tpu/golden/precompiles.py KECCAK_RC
KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

#: rho rotation offsets, flat index x + 5 * y (KECCAK_ROTATIONS there)
KECCAK_ROTATIONS = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]

K3_LAUNCHES = 0

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


def keccak_rounds_lanes(a: torch.Tensor, rcs) -> torch.Tensor:
    """One round over int64[25, B] lanes for each round constant of `rcs`
    (int64 bit patterns), in order."""
    dev = a.device
    one = torch.ones((5, 1), dtype=torch.int64, device=dev)
    rot = torch.tensor(_ROT_SRC, dtype=torch.int64, device=dev)[:, None]
    pi = torch.tensor(_PI_SRC, dtype=torch.int64, device=dev)
    for rc in rcs:
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


def keccak_f1600_lanes(a: torch.Tensor) -> torch.Tensor:
    """One permutation over int64[25, B] lanes."""
    return keccak_rounds_lanes(a, _RC)


def keccak_f1600_array(state: torch.Tensor) -> torch.Tensor:
    """Permutation over packed states int32[B, 25, 2]."""
    return from_lanes(keccak_f1600_lanes(to_lanes(state)))


def keccak_f1600_plain(states: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """The plain version of K3: `iters` chained permutations of
    int32[N, 25, 2] in torch, on the states' device."""
    lanes = to_lanes(states)
    for _ in range(iters):
        lanes = keccak_f1600_lanes(lanes)
    return from_lanes(lanes)


def _check(states: torch.Tensor, iters: int) -> None:
    if states.dim() != 3 or tuple(states.shape[1:]) != (25, 2) \
            or states.dtype != torch.int32:
        raise ValueError(f"states: expected int32[N, 25, 2], got "
                         f"{states.dtype}{list(states.shape)}")
    if iters < 0:
        raise ValueError("iters must be >= 0")


def keccak_f1600_(states: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """`iters` chained permutations of every state in int32[N, 25, 2], in
    place; returns `states`.

    On a CUDA tensor (which must be contiguous) this is one K3 launch; on a
    CPU tensor, the plain version copied back.
    """
    global K3_LAUNCHES
    _check(states, iters)
    device = states.device
    if device.type == "cpu":
        return states.copy_(keccak_f1600_plain(states, iters))
    if device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {device}")
    if not states.is_contiguous():
        raise ValueError("states: K3 permutes a contiguous tensor in place")
    n = states.shape[0]
    if n == 0 or iters == 0:
        return states
    from .._build import load

    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load().eravm_k3_launch(ctypes.c_void_p(states.data_ptr()), n, iters,
                                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    K3_LAUNCHES += 1
    return states


def keccak_f1600(states: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """`iters` chained permutations of every state in int32[N, 25, 2].

    Returns a new tensor.  On a CUDA tensor this is one K3 launch on a
    copy; on a CPU tensor, the plain version.
    """
    _check(states, iters)
    if states.device.type == "cpu":
        return keccak_f1600_plain(states, iters)
    return keccak_f1600_(states.contiguous().clone(), iters)


def keccak256(data: bytes) -> bytes:
    """keccak256 of a byte string (the 0x01 padding of the original keccak,
    not SHA3), on the CPU with the plain permutation."""
    rate = 136
    padded = bytearray(data) + b"\x01" + bytes(-(len(data) + 1) % rate)
    padded[-1] |= 0x80
    lanes = torch.zeros((25, 1), dtype=torch.int64)
    for start in range(0, len(padded), rate):
        block = padded[start:start + rate]
        lanes[:17, 0] ^= torch.tensor(
            [int.from_bytes(block[8 * i:8 * i + 8], "little", signed=True)
             for i in range(17)], dtype=torch.int64)
        lanes = keccak_f1600_lanes(lanes)
    return b"".join(int(x).to_bytes(8, "little", signed=True)
                    for x in lanes[:4, 0])
