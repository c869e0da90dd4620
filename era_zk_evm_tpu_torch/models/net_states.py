"""Final net states (`get_final_net_states`) from the device state.

The port of `era_zk_evm_tpu/models/net_states.py` (limbs read with the
port's copy of `utils/u256_host.py`): the row readers the scheduler needs
(`storage_map_of`, `event_entries_of`, `messages_from_join`,
`messages_from_entries`, numpy only) and the whole-batch extraction
(`device_storage_maps`, `device_event_entries`, `device_net_states`, and
`net_states_by_tx` for the bootloader block shape, where one VM runs many
transactions).  `tests/test_torch_scheduler.py` and
`tests/test_torch_net_states.py` hold them equal to their sources.

On the device the nets are materialised by construction: the final
storage is the lane's KV table (journal rollbacks were replayed on panic),
the net events are the event journal minus its cancelled entries.  The
journal does not keep the emitting address and shard, so they are joined
from the drained log stream on the (unique) emission timestamp.
"""

from __future__ import annotations

import numpy as np

from ..isa import params
from ..utils import from_limbs
from ..witness.queries import EventMessage
from .state import reference_view


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


def _host(state, names: tuple) -> dict:
    """The state's fields `names` on the host in the reference layout, u32
    fields as uint32."""
    ref = reference_view(state)
    out = {}
    for name in names:
        a = getattr(ref, name).cpu().numpy()
        out[name] = a if a.dtype == bool or name == "ev_count" \
            else a.view(np.uint32)
    return out


def device_storage_maps(state, config) -> list[dict]:
    """Per-lane final storage maps (net values: rollbacks already
    replayed)."""
    if config.storage_slots == 0:
        return [dict() for _ in range(config.batch)]
    h = _host(state, ("st_key", "st_val", "st_used"))
    return [storage_map_of(h["st_key"], h["st_val"], h["st_used"], b)
            for b in range(config.batch)]


def device_event_entries(state) -> list[list[tuple]]:
    """Per-lane uncancelled event-journal entries in emission order."""
    h = _host(state, ("ev_meta", "ev_key", "ev_val", "ev_cancelled",
                      "ev_count"))
    return [event_entries_of(h["ev_meta"], h["ev_key"], h["ev_val"],
                             h["ev_cancelled"], h["ev_count"], b)
            for b in range(h["ev_count"].shape[0])]


def net_states_by_tx(state, config, log_streams) -> list[dict]:
    """Per-lane net outcomes grouped by `tx_number_in_block`: the
    bootloader block shape's extraction (one VM runs a bootloader that
    far-calls every transaction and advances the tx counter between them;
    the counter is stamped onto every log query and event at emission).

    Returns per lane {tx_number: {"events", "l1_messages",
    "storage_writes"}}, storage_writes that tx's storage-write log queries
    from the drained stream (`log_streams`, lane-indexed)."""
    entries = device_event_entries(state)
    out = []
    for b in range(config.batch):
        stream = log_streams[b] if b < len(log_streams) else []
        ev, l1 = messages_from_entries(entries[b], stream)
        lane: dict[int, dict] = {}

        def bucket(tx):
            return lane.setdefault(
                tx, {"events": [], "l1_messages": [], "storage_writes": []})

        for m in ev:
            bucket(m.tx_number_in_block)["events"].append(m)
        for m in l1:
            bucket(m.tx_number_in_block)["l1_messages"].append(m)
        for q in stream:
            if q.aux_byte == params.STORAGE_AUX_BYTE and q.rw_flag:
                bucket(q.tx_number_in_block)["storage_writes"].append(q)
        out.append(lane)
    return out


def device_net_states(state, config, log_streams) -> list[dict]:
    """Per-lane net outcomes, shaped like `get_final_net_states` minus the
    histories (the drained queue streams are the ordered histories):
    {"final_storage", "events", "l1_messages"}.  `log_streams` is the
    lane-indexed drained log-query stream, which gives the events their
    address and shard."""
    storage = device_storage_maps(state, config)
    entries = device_event_entries(state)
    out = []
    for b in range(config.batch):
        ev, l1 = messages_from_entries(
            entries[b], log_streams[b] if b < len(log_streams) else [])
        out.append({"final_storage": storage[b],
                    "events": ev, "l1_messages": l1})
    return out
