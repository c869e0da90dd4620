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

`keccak256_ragged(words, offsets)` is keccak256 over T ragged u32 word
streams concatenated in one buffer: on a CUDA tensor one launch of the
sponge kernel (`csrc/keccak_sponge.cu`, K3 as the witness commitments drive
it), counted in `K3S_LAUNCHES`; on a CPU tensor its plain version
`keccak256_ragged_plain`, a loop over the rate blocks.

The batched equal-length keccak256 of the JAX module: `pad_messages`
(host, numpy) pads byte messages into rate blocks, `absorb_blocks` /
`keccak256_batched` absorb them (the rate words XORed in with torch, then
one K3 launch a block on the card, the plain version on the CPU) and
`digest_from_state` reads the digests.

`keccak256(bytes)` is the host reference over one byte string, on Python
ints (`keccak_f1600_ints`, the golden permutation's formulation with its
index maps computed once).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# the iota round constants (FIPS 202) and the rho rotation offsets (flat
# index x + 5 * y) are the port's golden oracle's
from ..golden.precompiles import (
    KECCAK_RATE_BYTES, KECCAK_RC, KECCAK_ROTATIONS,
)
from .u256 import M32, narrow

K3_LAUNCHES = 0
K3S_LAUNCHES = 0
#: u32 words of keccak256's rate (136 bytes)
RATE_WORDS = 34

_RC = [c - (1 << 64) if c >= 1 << 63 else c for c in KECCAK_RC]
# rho + pi: lane s moves to y + 5 * ((2x + 3y) % 5); gather form
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_ROT_SRC = [KECCAK_ROTATIONS[s] for s in _PI_SRC]
#: chi's operands of lane i: (i, i + 1, i + 2 within its row)
_CHI = [(i, i - i % 5 + (i + 1) % 5, i - i % 5 + (i + 2) % 5)
        for i in range(25)]
_U64 = (1 << 64) - 1


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


@functools.lru_cache(maxsize=None)
def _round_tables(device: torch.device) -> tuple:
    """The round's constant tables on `device`, made once a device (a table
    made from a list on the card is a copy that waits for the stream)."""
    return (torch.ones((5, 1), dtype=torch.int64, device=device),
            torch.tensor(_ROT_SRC, dtype=torch.int64, device=device)[:, None],
            torch.tensor(_PI_SRC, dtype=torch.int64, device=device))


def keccak_rounds_lanes(a: torch.Tensor, rcs) -> torch.Tensor:
    """One round over int64[25, B] lanes for each round constant of `rcs`
    (int64 bit patterns), in order."""
    one, rot, pi = _round_tables(a.device)
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


def _check_ragged(words: torch.Tensor, offsets: torch.Tensor,
                  order: torch.Tensor | None) -> None:
    if words.dim() != 1 or words.dtype != torch.int32:
        raise ValueError(f"words: expected int32[W], got "
                         f"{words.dtype}{list(words.shape)}")
    if offsets.dim() != 1 or offsets.dtype != torch.int64 \
            or offsets.shape[0] < 1:
        raise ValueError(f"offsets: expected int64[T + 1], got "
                         f"{offsets.dtype}{list(offsets.shape)}")
    tensors = [words, offsets]
    if order is not None:
        if order.dtype != torch.int32 \
                or tuple(order.shape) != (offsets.shape[0] - 1,):
            raise ValueError(f"order: expected int32[{offsets.shape[0] - 1}]"
                             f", got {order.dtype}{list(order.shape)}")
        tensors.append(order)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("words, offsets and order must share a device")


def keccak256_ragged_plain(words: torch.Tensor, offsets: torch.Tensor
                           ) -> torch.Tensor:
    """The plain version of the sponge: keccak256 of each stream
    words[offsets[t]:offsets[t + 1]] (u32 words as int32, little-endian
    bytes) -> int32[T, 8] digest words, in torch on the words' device.  One
    step a rate block, every stream at once: a stream absorbs
    n // 34 + 1 blocks and keeps its state past its last; no bucketing."""
    dev = words.device
    off = offsets.to(device=dev, dtype=torch.int64)
    n = off[1:] - off[:-1]
    T = n.shape[0]
    nb = n // RATE_WORDS + 1
    j = n - RATE_WORDS * (nb - 1)
    # one word past the end, where every read past a stream's end lands
    w = torch.cat([words.to(torch.int64) & M32,
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    col = torch.arange(RATE_WORDS, device=dev)
    lanes = torch.zeros((25, T), dtype=torch.int64, device=dev)
    for b in range(int(nb.max()) if T else 0):
        pos = RATE_WORDS * b + col                            # [34]
        idx = (off[:-1, None] + pos).clamp(max=words.shape[0])
        blk = torch.where(pos < n[:, None], w[idx], 0)
        last = (nb - 1 == b)[:, None]
        blk = blk ^ torch.where(last & (col == j[:, None]), 1, 0)
        blk = blk ^ torch.where(last & (col == RATE_WORDS - 1), 1 << 31, 0)
        rate = (blk[:, 0::2] | (blk[:, 1::2] << 32)).T       # int64[17, T]
        nxt = keccak_f1600_lanes(torch.cat([lanes[:17] ^ rate, lanes[17:]]))
        lanes = torch.where(b < nb, nxt, lanes)
    return from_lanes(lanes[:4]).reshape(T, 8)


def keccak256_ragged(words: torch.Tensor, offsets: torch.Tensor,
                     order: torch.Tensor | None = None) -> torch.Tensor:
    """keccak256 of each of T streams, words[offsets[t]:offsets[t + 1]]
    (int32[W] holding u32 words, int64[T + 1] offsets) -> int32[T, 8]
    digest words (little-endian u32 of the 32 digest bytes).

    On CUDA tensors (contiguous, on one card) this is one launch of the
    sponge kernel, threads in `order` (int32[T], a permutation of the
    streams; longest first when not given, computed on the device); on CPU
    tensors, the plain version.  The order changes no digest."""
    global K3S_LAUNCHES
    _check_ragged(words, offsets, order)
    device = words.device
    if device.type == "cpu":
        return keccak256_ragged_plain(words, offsets)
    if device.type != "cuda":
        raise ValueError(f"no sponge kernel for device {device}")
    tensors = (words, offsets) + ((order,) if order is not None else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the sponge reads contiguous tensors")
    n = offsets.shape[0] - 1
    digests = torch.empty((n, 8), dtype=torch.int32, device=device)
    if n == 0:
        return digests
    if order is None:
        order = torch.argsort(offsets[1:] - offsets[:-1], descending=True,
                              stable=True).to(torch.int32)
    from .._build import load

    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load().eravm_k3s_launch(
        ctypes.c_void_p(words.data_ptr()), ctypes.c_void_p(offsets.data_ptr()),
        ctypes.c_void_p(order.data_ptr()), ctypes.c_void_p(digests.data_ptr()),
        n, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sponge launch failed: cudaError {rc}")
    K3S_LAUNCHES += 1
    return digests


def keccak_f1600_ints(state: list[int]) -> list[int]:
    """One permutation of 25 u64 lanes held as Python ints (flat x + 5y),
    golden's `keccak_f1600` with the rho + pi and chi index maps computed
    once (`tests/test_torch_golden.py` holds the two equal): the host
    reference's permutation, where a torch call a step costs more than the
    step."""
    a = list(state)
    for rc in KECCAK_RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[x - 1] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63))
                         & _U64) for x in range(5)]
        a = [v ^ d[i % 5] for i, v in enumerate(a)]
        b = [((a[s] << r) | (a[s] >> (64 - r))) & _U64
             for s, r in zip(_PI_SRC, _ROT_SRC)]
        a = [b[i] ^ (~b[j] & b[k]) for i, j, k in _CHI]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """keccak256 of a byte string (the 0x01 padding of the original keccak,
    not SHA3), on the host with `keccak_f1600_ints`."""
    rate = 136
    padded = bytearray(data) + b"\x01" + bytes(-(len(data) + 1) % rate)
    padded[-1] |= 0x80
    lanes = [0] * 25
    for start in range(0, len(padded), rate):
        for i in range(17):
            lanes[i] ^= int.from_bytes(
                padded[start + 8 * i:start + 8 * i + 8], "little")
        lanes = keccak_f1600_ints(lanes)
    return b"".join(x.to_bytes(8, "little") for x in lanes[:4])


def pad_messages(messages: bytes | list[bytes]) -> np.ndarray:
    """Host helper: pad byte messages (all the same length) into rate
    blocks, keccak256's 0x01 ... 0x80 padding.

    Returns uint32[B, n_blocks, 34] for `absorb_blocks`: each block is 17
    u64 lanes as (lo, hi) pairs (lane k -> columns 2k, 2k + 1)."""
    if isinstance(messages, (bytes, bytearray)):
        messages = [bytes(messages)]
    length = len(messages[0])
    if any(len(m) != length for m in messages):
        raise ValueError("pad_messages: uniform length required")
    pad_len = KECCAK_RATE_BYTES - (length % KECCAK_RATE_BYTES)
    if pad_len == 1:
        pad = b"\x81"
    else:
        pad = b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    n_blocks = (length + pad_len) // KECCAK_RATE_BYTES
    out = np.zeros((len(messages), n_blocks, 34), dtype=np.uint32)
    for b, m in enumerate(messages):
        padded = m + pad
        for blk in range(n_blocks):
            chunk = padded[blk * KECCAK_RATE_BYTES:
                           (blk + 1) * KECCAK_RATE_BYTES]
            for k in range(KECCAK_RATE_BYTES // 8):
                lane = int.from_bytes(chunk[8 * k:8 * k + 8], "little")
                out[b, blk, 2 * k] = lane & 0xFFFFFFFF
                out[b, blk, 2 * k + 1] = lane >> 32
    return out


def absorb_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Absorb padded rate blocks and return the final sponge states.

    blocks: int32[B, n_blocks, 34] (`pad_messages`' words, u32 as int32)
    -> int32[B, 25, 2].  Each block's rate words are XORed into the states
    with torch, then permuted by `keccak_f1600_`: one K3 launch a block on
    the card, the plain version on the CPU."""
    if blocks.dim() != 3 or blocks.shape[2] != 34 \
            or blocks.dtype != torch.int32:
        raise ValueError(f"blocks: expected int32[B, n_blocks, 34], got "
                         f"{blocks.dtype}{list(blocks.shape)}")
    B, n_blocks, _ = blocks.shape
    state = torch.zeros((B, 25, 2), dtype=torch.int32, device=blocks.device)
    for blk in range(n_blocks):
        state[:, :17] ^= blocks[:, blk].reshape(B, 17, 2)
        keccak_f1600_(state)
    return state


def keccak256_batched(blocks: torch.Tensor) -> torch.Tensor:
    """Full sponge over pre-padded blocks -> final states int32[B, 25, 2]."""
    return absorb_blocks(blocks)


def digest_from_state(state: torch.Tensor) -> list[bytes]:
    """int32[B, 25, 2] -> per-lane 32-byte keccak256 digests (on the
    host)."""
    words = np.ascontiguousarray(state[:, :4].detach().cpu().numpy())
    return [row.view(np.uint32).astype("<u4").tobytes() for row in words]
