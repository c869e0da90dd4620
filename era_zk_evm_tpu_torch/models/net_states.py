"""Final net states of a transaction from its host-read state rows.

A copy of the host functions of `era_zk_evm_tpu/models/net_states.py`
that the scheduler needs (`storage_map_of` :32, `event_entries_of` :44,
`messages_from_join` :82, `messages_from_entries` :109), with the
`EventMessage` record of `era_zk_evm_tpu/golden/queries.py` and the limb
reader of `era_zk_evm_tpu/utils/u256_host.py`; numpy only.
`tests/test_torch_scheduler.py` holds the copy equal to its source.

On the device the nets are materialised by construction: the final
storage is the lane's KV table (journal rollbacks were replayed on panic),
the net events are the event journal minus its cancelled entries.  The
journal does not keep the emitting address and shard, so they are joined
from the drained log stream on the (unique) emission timestamp.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..isa import params


@dataclasses.dataclass(frozen=True)
class EventMessage:
    """Flattened event / L1 message (reference_impls/event_sink.rs:7-14)."""

    shard_id: int
    is_first: bool
    tx_number_in_block: int
    address: int
    key: int
    value: int


def from_limbs(limbs) -> int:
    """uint32[8] -> Python int."""
    arr = np.asarray(limbs, dtype=np.uint32)
    assert arr.shape[-1] == 8
    return sum(int(arr[..., i]) << (32 * i) for i in range(8))


def storage_map_of(st_key, st_val, st_used, b) -> dict:
    """One lane's final storage {(shard, address, key): value} from the
    (host-read) KV table arrays."""
    m = {}
    for s in np.nonzero(st_used[b])[0]:
        key = from_limbs(st_key[b, s, :8])
        address = sum(int(st_key[b, s, 8 + i]) << (32 * i) for i in range(5))
        shard = int(st_key[b, s, 13])
        m[(shard, address, key)] = from_limbs(st_val[b, s])
    return m


def event_entries_of(ev_meta, ev_key, ev_val, ev_cancelled, ev_count,
                     b) -> list[tuple]:
    """One lane's uncancelled event-journal entries in emission order:
    (timestamp, aux_byte, key, value, is_first, tx_number_in_block)."""
    lane = []
    for i in range(int(ev_count[b])):
        if ev_cancelled[b, i]:
            continue
        packed = int(ev_meta[b, i, 1])
        lane.append((int(ev_meta[b, i, 0]), packed & 0xFF,
                     from_limbs(ev_key[b, i]), from_limbs(ev_val[b, i]),
                     bool((packed >> 8) & 1), (packed >> 16) & 0xFFFF))
    return lane


def messages_from_join(entries, by_ts: dict) -> tuple[list, list]:
    """Join journal entries with a {timestamp: (address, shard)} map to
    recover address/shard; split events vs L1 messages by aux byte.

    Every journal entry must join (the log queue records the same emission
    the journal did): a miss means the caller ran with event_slots > 0 but
    no log queue (log_queue_capacity == 0) or dropped the drained stream,
    so this raises instead of making up an address."""
    events: list[EventMessage] = []
    l1: list[EventMessage] = []
    for ts, aux, key, value, is_first, tx in entries:
        hit = by_ts.get(ts)
        if hit is None:
            raise ValueError(
                f"event-journal entry at timestamp {ts} has no matching "
                "log-stream query — net states with events need "
                "log_queue_capacity > 0 and the full drained log stream")
        address, shard = hit
        msg = EventMessage(
            shard_id=shard, is_first=is_first,
            tx_number_in_block=tx,
            address=address, key=key, value=value)
        (events if aux == params.EVENT_AUX_BYTE else l1).append(msg)
    return events, l1


def messages_from_entries(entries, log_stream) -> tuple[list, list]:
    """messages_from_join over a stream of log-query records with
    `timestamp`, `address` and `shard_id` attributes."""
    return messages_from_join(
        entries, {q.timestamp: (q.address, q.shard_id) for q in log_stream})
