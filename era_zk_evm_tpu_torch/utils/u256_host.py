"""Host-side conversions between Python ints and 8x-uint32 limb arrays.

A copy of `era_zk_evm_tpu/utils/u256_host.py` (held equal to it by
`tests/test_torch_spill.py`).  A U256 is `uint32[..., 8]`, little-endian
limb order (limb i = bits [32*i, 32*i+32)); the port's state carries the
same bits as `torch.int32`, so view a tensor's numpy copy as `np.uint32`
before it reaches these helpers.
"""

from __future__ import annotations

import numpy as np

NUM_LIMBS = 8
U32_MASK = (1 << 32) - 1


def to_limbs(value: int) -> np.ndarray:
    """Python int -> uint32[8] little-endian limbs."""
    assert 0 <= value < (1 << 256)
    return np.array([(value >> (32 * i)) & U32_MASK for i in range(NUM_LIMBS)],
                    dtype=np.uint32)


def from_limbs(limbs) -> int:
    """uint32[8] -> Python int."""
    arr = np.asarray(limbs, dtype=np.uint32)
    assert arr.shape[-1] == NUM_LIMBS
    return sum(int(arr[..., i]) << (32 * i) for i in range(NUM_LIMBS))


def batch_to_limbs(values: list[int]) -> np.ndarray:
    """[B] ints -> uint32[B, 8]."""
    return np.stack([to_limbs(v) for v in values], axis=0) if values \
        else np.zeros((0, NUM_LIMBS), dtype=np.uint32)


def batch_from_limbs(arr) -> list[int]:
    """uint32[B, 8] -> [B] ints."""
    arr = np.asarray(arr, dtype=np.uint32)
    return [from_limbs(arr[i]) for i in range(arr.shape[0])]


def contract_bytecode_to_words(code: bytes) -> list[int]:
    """32-byte BE chunks -> u256 word list (utils.rs:12-34 role); pads the
    tail chunk with zeros."""
    words = []
    for i in range(0, len(code), 32):
        chunk = code[i:i + 32].ljust(32, b"\x00")
        words.append(int.from_bytes(chunk, "big"))
    return words


def address_to_u256(address: int) -> int:
    """160-bit address -> u256 (utils.rs:36-41 role; addresses are ints
    throughout this framework, so this is a masked identity)."""
    return address & ((1 << 160) - 1)


def u256_to_address(value: int) -> int:
    """u256 -> 160-bit address, truncating high bits (utils.rs:43-48 role)."""
    return value & ((1 << 160) - 1)
