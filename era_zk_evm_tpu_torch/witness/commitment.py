"""Witness-queue commitments over the reference-shaped query structs.

The port of `era_zk_evm_tpu/witness/commitment.py`, whose module docstring
pins the record serializations (memory 64 bytes, log 128, decommitment 64)
and the commitments:

  lane commitment  = keccak256(concat(records in emission order))
  block commitment = keccak256(concat(lane commitments in lane order))

and the rolling (streaming) commitment of the memory queue, spec v2: two
64-byte records a keccak-f permutation, finalized by XORing
`count | 0x80 << 56` into rate lane 16 and permuting once.

The `commit_*` functions and `rolling_commit` hash on the host
(`ops.keccak.keccak256`, `keccak_f1600_ints`).  The `device_*_streams`
readers build each lane's query structs from the device-serialized packed
records (`packed.serialize_all`: one copy to the host a family, the valid
rows only), the same bytes the packed path commits, so they hold for any
storage layout of the state.
"""

from __future__ import annotations

import numpy as np

from ..config import precompile_queue_slots
from ..ops.keccak import keccak256, keccak_f1600_ints
from .packed import queries_from_packed, serialize_all
from .queries import MemoryQuery


def serialize_memory_query(q: MemoryQuery) -> bytes:
    flags = int(q.rw_flag) | (int(q.value_is_pointer) << 1)
    return (q.timestamp.to_bytes(4, "big")
            + bytes([int(q.memory_type)])
            + q.page.to_bytes(4, "big")
            + q.index.to_bytes(4, "big")
            + bytes([flags])
            + bytes(18)
            + q.value.to_bytes(32, "big"))


def commit_memory_queue(queries: list[MemoryQuery]) -> bytes:
    """Per-lane commitment over the dense, ordered query stream."""
    return keccak256(b"".join(serialize_memory_query(q) for q in queries))


def block_commitment(lane_commitments: list[bytes]) -> bytes:
    return keccak256(b"".join(lane_commitments))


def serialize_log_query(q) -> bytes:
    """Log-query record (128 bytes): header + address + key/read/written."""
    flags = int(q.rw_flag) | (int(q.rollback) << 1) | (int(q.is_service) << 2)
    return (q.timestamp.to_bytes(4, "big")
            + bytes([q.aux_byte, q.shard_id, flags])
            + q.tx_number_in_block.to_bytes(2, "big")
            + bytes(3)
            + q.address.to_bytes(20, "big")
            + q.key.to_bytes(32, "big")
            + q.read_value.to_bytes(32, "big")
            + q.written_value.to_bytes(32, "big"))


def commit_log_queue(queries) -> bytes:
    return keccak256(b"".join(serialize_log_query(q) for q in queries))


def serialize_decommittment(q) -> bytes:
    """Decommitment record (64 bytes): hash + page/length/timestamp/fresh."""
    return (q.hash.to_bytes(32, "big")
            + q.timestamp.to_bytes(4, "big")
            + q.memory_page.to_bytes(4, "big")
            + q.decommitted_length.to_bytes(4, "big")
            + bytes([int(q.is_fresh)])
            + bytes(19))


def commit_decommitter_queue(queries) -> bytes:
    return keccak256(b"".join(serialize_decommittment(q) for q in queries))


def commit_precompile_queue(queries: list[MemoryQuery]) -> bytes:
    """Same 64-byte record serialization as the memory queue."""
    return keccak256(b"".join(serialize_memory_query(q) for q in queries))


# ---------------------------------------------------------------------------
# Rolling (streaming) commitment, spec v2
# ---------------------------------------------------------------------------

def _finalize(lanes: list[int], count: int) -> bytes:
    lanes[16] ^= count | (0x80 << 56)
    lanes = keccak_f1600_ints(lanes)
    return b"".join(lanes[k].to_bytes(8, "little") for k in range(4))


def rolling_commit(queries: list[MemoryQuery]) -> bytes:
    """Host reference for the streaming commitment (device: the engine's
    `wc_state` / `wc_count`, folded by K2)."""
    lanes = [0] * 25
    for r, q in enumerate(queries):
        record = serialize_memory_query(q)
        base = 0 if r % 2 == 0 else 8
        for k in range(8):
            lanes[base + k] ^= int.from_bytes(record[8 * k:8 * k + 8],
                                              "little")
        if r % 2 == 1:
            lanes = keccak_f1600_ints(lanes)
    return _finalize(lanes, len(queries))


def device_rolling_commitments(state) -> list[bytes]:
    """Finalize per-lane device sponge states (wc_state/wc_count) to
    digests, on the host."""
    wc = state.wc_state.cpu().numpy().view(np.uint32)
    counts = state.wc_count.cpu().numpy().view(np.uint32)
    return [_finalize([int(wc[b, k, 0]) | (int(wc[b, k, 1]) << 32)
                       for k in range(25)], int(counts[b]))
            for b in range(wc.shape[0])]


# ---------------------------------------------------------------------------
# Device-queue extraction
# ---------------------------------------------------------------------------

def _lane_streams(state, family: str) -> list[list]:
    """Per-lane query structs of one queue family, in slot (= emission)
    order: the family's packed records serialized on the device, the valid
    rows and per-lane counts copied to the host once."""
    words, valid = serialize_all(state, (family,))[family]
    rows = words[valid].cpu().numpy().view(np.uint32)    # (lane, slot) order
    counts = valid.sum(1).cpu().numpy()
    return [queries_from_packed(family, r)
            for r in np.split(rows, np.cumsum(counts)[:-1])]


def device_queue_streams(state) -> list[list[MemoryQuery]]:
    """Per-lane dense memory-query streams from the device witness queue."""
    return _lane_streams(state, "memory")


def device_log_streams(state) -> list[list]:
    """Per-lane log-query streams from the device log queue (the device
    queues never hold rollback twins: `rollback` is False)."""
    return _lane_streams(state, "log")


def device_decommit_streams(state) -> list[list]:
    return _lane_streams(state, "decommit")


def device_precompile_streams(state) -> list[list[MemoryQuery]]:
    """Per-lane mem_in/mem_out MemoryQuery streams of every precompile
    call, flattened in call order (`value_is_pointer` False; the golden
    counterpart is `flatten_precompile_calls`)."""
    return _lane_streams(state, "precompile")


def device_precompile_rounds(state, config) -> list[list[int]]:
    """Per-lane round counts (PrecompileCyclesWitness equivalent), one per
    call, read from each block's first output slot (flags bits 3+)."""
    ps_in, ps_out = precompile_queue_slots(config)
    ps = ps_in + ps_out
    pq_flags = state.pq_flags.cpu().numpy().view(np.uint32)
    out = []
    for b in range(pq_flags.shape[0]):
        rounds = []
        for base in range(0, pq_flags.shape[1] - ps + 1, ps):
            f = int(pq_flags[b, base + ps_in])
            if f & 4:
                rounds.append(f >> 3)
        out.append(rounds)
    return out


def flatten_precompile_calls(precompile_calls) -> list[MemoryQuery]:
    """Golden-side counterpart: tracer PrecompileCallResult list -> the
    dense per-lane stream (mem_in then mem_out per call, call order)."""
    stream: list[MemoryQuery] = []
    for call in precompile_calls:
        stream.extend(call.mem_in)
        stream.extend(call.mem_out)
    return stream


def commit_device_queues(state) -> tuple[list[bytes], bytes]:
    """(per-lane memory-queue commitments, block commitment)."""
    lanes = [commit_memory_queue(s) for s in device_queue_streams(state)]
    return lanes, block_commitment(lanes)


def commit_all_device_queues(state) -> dict:
    """All queue families committed per lane + folded per block."""
    mem = [commit_memory_queue(s) for s in device_queue_streams(state)]
    logs = [commit_log_queue(s) for s in device_log_streams(state)]
    dec = [commit_decommitter_queue(s) for s in device_decommit_streams(state)]
    out = {
        "memory_lanes": mem, "memory_block": block_commitment(mem),
        "log_lanes": logs, "log_block": block_commitment(logs),
        "decommitter_lanes": dec, "decommitter_block": block_commitment(dec),
    }
    if state.pq_flags.shape[1] > 0:
        pre = [commit_precompile_queue(s)
               for s in device_precompile_streams(state)]
        out["precompile_lanes"] = pre
        out["precompile_block"] = block_commitment(pre)
    return out

