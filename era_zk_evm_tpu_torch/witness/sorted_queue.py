"""Sorted-queue simulation + grand-product commitments.

The port of `era_zk_evm_tpu/witness/sorted_queue.py`, whose module
docstring pins the prover-facing form of the log queue: a SORTED copy plus
a permutation argument binding it to the emission-ordered queue, both
multisets committing to the same grand product prod(gamma +
fingerprint(entry)) over Goldilocks (`ops/goldilocks.py`):

  * fingerprint — keccak256 of the 128-byte log record
    (`commitment.serialize_log_query`), its first 8 digest bytes as a
    little-endian u64, reduced mod p;
  * gamma — caller-supplied, `DEFAULT_GAMMA` for tests and benches;
  * sort order — (aux_byte, shard_id, address, key, timestamp), invalid
    slots last.

Every function reads the state's log queue in the reference layout
(`reference_view`) and works on the state's device.  The fingerprints take
all B x Q records through one K3 launch on the card (`packed.fingerprints`;
the plain permutation on the CPU); the products are a log-depth tree of
Goldilocks multiplies on the device, as in JAX; the sort is one stable
`torch.sort` pass a key, least significant first (JAX's `lax.sort`, not a
Pallas kernel).  Field elements are (lo, hi) int64 tensors holding u32
halves.
"""

from __future__ import annotations

import torch

from ..models.state import reference_view
from ..ops.goldilocks import GOLDILOCKS_P, gl_add, gl_mul
from ..ops.keccak import keccak256
from ..ops.u256 import wide
from .commitment import serialize_log_query
from .packed import fingerprints, log_record_words

#: the pinned test and bench gamma (a real prover derives gamma by
#: Fiat-Shamir)
DEFAULT_GAMMA = 0xA5A55A5A_DEADBEEF % GOLDILOCKS_P

Pair = tuple[torch.Tensor, torch.Tensor]


def log_queue_blocks(state) -> torch.Tensor:
    """The log queue as keccak rate blocks: int32[B, Q, 34], each row one
    padded 136-byte block holding the record of `serialize_log_query`."""
    words, _ = log_record_words(state)
    pad = torch.zeros(words.shape[:-1] + (2,), dtype=torch.int32,
                      device=words.device)
    pad[..., 0] = 0x01
    pad[..., 1] = -(1 << 31)                 # 0x80000000
    return torch.cat([words, pad], dim=-1)


def log_queue_fingerprints(state) -> tuple[Pair, torch.Tensor]:
    """((fp_lo, fp_hi) int64[B, Q], valid bool[B, Q]): the fingerprint of
    every queue slot, one K3 launch over all B x Q records on the card."""
    words, valid = log_record_words(state)
    B, Q = valid.shape
    lo, hi = fingerprints(words.reshape(B * Q, 32))
    return (lo.view(B, Q), hi.view(B, Q)), valid


def grand_product(fp_lo: torch.Tensor, fp_hi: torch.Tensor,
                  valid: torch.Tensor, gamma: int = DEFAULT_GAMMA) -> Pair:
    """Per-lane prod(gamma + fp) mod p over the valid entries -> (lo, hi)
    int64[B]: a log-depth tree over the last axis, invalid slots and the
    padding of an odd level contributing the factor 1."""
    t_lo, t_hi = gl_add(fp_lo, fp_hi,
                        torch.full_like(fp_lo, gamma & 0xFFFFFFFF),
                        torch.full_like(fp_hi, gamma >> 32))
    lo = torch.where(valid, t_lo, 1)
    hi = torch.where(valid, t_hi, 0)
    n = lo.shape[-1]
    while n > 1:
        half = (n + 1) // 2
        if half * 2 > n:
            pad = lo.shape[:-1] + (1,)
            lo = torch.cat([lo, lo.new_ones(pad)], dim=-1)
            hi = torch.cat([hi, hi.new_zeros(pad)], dim=-1)
        lo, hi = gl_mul(lo[..., :half], hi[..., :half],
                        lo[..., half:], hi[..., half:])
        n = half
    return lo[..., 0], hi[..., 0]


def block_grand_product(lane_lo: torch.Tensor, lane_hi: torch.Tensor) -> Pair:
    """Fold per-lane products over the batch axis."""
    return grand_product(lane_lo, lane_hi,
                         torch.ones_like(lane_lo, dtype=torch.bool), gamma=0)


def sort_log_queue(state) -> tuple:
    """The sorted-queue simulation: a copy of the log-queue arrays ordered
    by (aux_byte, shard, address, key, timestamp), invalid slots last, in
    the reference layout.

    Returns (lq_meta, lq_addr, lq_key, lq_read, lq_written), int32[B, Q,
    .] each.  One stable sort over the queue axis a key, the least
    significant first, the keys widened to int64 so that u32 order holds.
    """
    ref = reference_view(state)
    arrays = (ref.lq_meta, ref.lq_addr, ref.lq_key, ref.lq_read,
              ref.lq_written)
    meta, addr, key = wide(ref.lq_meta), wide(ref.lq_addr), wide(ref.lq_key)
    packed = meta[..., 1]
    keys = [(meta[..., 3] == 0).to(torch.int64), packed & 0xFF,
            (packed >> 16) & 0xFF]
    keys += [addr[..., 4 - i] for i in range(5)]
    keys += [key[..., 7 - i] for i in range(8)]
    keys.append(meta[..., 0])
    B, Q = packed.shape
    perm = torch.arange(Q, device=packed.device).expand(B, Q)
    for k in reversed(keys):
        order = torch.sort(k.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return tuple(a.gather(1, perm[..., None].expand(a.shape))
                 for a in arrays)


# ---------------------------------------------------------------------------
# Host references
# ---------------------------------------------------------------------------

def host_fingerprint(q) -> int:
    d = keccak256(serialize_log_query(q))
    return int.from_bytes(d[:8], "little") % GOLDILOCKS_P


def host_grand_product(queries, gamma: int = DEFAULT_GAMMA) -> int:
    acc = 1
    for q in queries:
        acc = acc * ((gamma + host_fingerprint(q)) % GOLDILOCKS_P) \
            % GOLDILOCKS_P
    return acc


def host_sort_key(q):
    return (q.aux_byte, q.shard_id, q.address, q.key, q.timestamp)
