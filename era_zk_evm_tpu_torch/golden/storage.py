"""Golden storage + event sink with frame-rollback semantics.

Mirrors the observable behavior of `InMemoryStorage` (testing/storage.rs) and
`InMemoryEventSink` (reference_impls/event_sink.rs): per-frame
(forward, rollbacks) query lists; on panic the child's rollbacks are appended
reversed to the parent's forward list (and, for storage, the values are
actually reverted); on success the child's rollbacks migrate to the parent.
"""

from __future__ import annotations

from ..isa import params
from .queries import EventMessage, LogQuery, RefundType


class _FrameStack:
    def __init__(self) -> None:
        self.frames: list[tuple[list[LogQuery], list[LogQuery]]] = [([], [])]

    def current(self) -> tuple[list[LogQuery], list[LogQuery]]:
        return self.frames[-1]

    def start_frame(self) -> None:
        self.frames.append(([], []))

    def finish_frame(self, panicked: bool) -> list[LogQuery]:
        """Merge child into parent; returns the child's rollbacks (for value
        reversion by the storage impl when panicked)."""
        forward, rollbacks = self.frames.pop()
        p_forward, p_rollbacks = self.frames[-1]
        if panicked:
            p_forward.extend(forward)
            p_forward.extend(reversed(rollbacks))
        else:
            p_forward.extend(forward)
            p_rollbacks.extend(rollbacks)
        return rollbacks


class GoldenStorage:
    """Two-shard in-memory storage with cold/warm markers."""

    def __init__(self) -> None:
        self.inner: list[dict[int, dict[int, int]]] = [
            {} for _ in range(params.NUM_SHARDS)]
        self.warm: list[dict[int, set[int]]] = [
            {} for _ in range(params.NUM_SHARDS)]
        self.frames = _FrameStack()

    def populate(self, elements: list[tuple[int, int, int, int]]) -> None:
        for shard, address, key, value in elements:
            self.inner[shard].setdefault(address, {})[key] = value

    def estimate_refunds_for_write(self, monotonic_cycle_counter: int,
                                   partial_query: LogQuery) -> RefundType:
        return RefundType.NONE

    def execute_partial_query(self, monotonic_cycle_counter: int,
                              query: LogQuery) -> LogQuery:
        assert not query.rollback
        addr_map = self.inner[query.shard_id].setdefault(query.address, {})
        warm_set = self.warm[query.shard_id].setdefault(query.address, set())
        current = addr_map.get(query.key, 0)
        warm_set.add(query.key)
        forward, rollbacks = self.frames.current()
        if query.rw_flag:
            addr_map[query.key] = query.written_value
            query = query.with_(read_value=current)
            forward.append(query)
            rollbacks.append(query.with_(rollback=True))
        else:
            query = query.with_(read_value=current)
            forward.append(query)
        return query

    def start_frame(self, timestamp: int) -> None:
        self.frames.start_frame()

    def finish_frame(self, timestamp: int, panicked: bool) -> None:
        rollbacks = self.frames.finish_frame(panicked)
        if panicked:
            for q in reversed(rollbacks):
                addr_map = self.inner[q.shard_id][q.address]
                assert addr_map[q.key] == q.written_value
                addr_map[q.key] = q.read_value

    def flatten_and_net_history(self):
        assert len(self.frames.frames) == 1
        forward, _ = self.frames.frames[0]
        history = list(forward)
        per_slot: dict[tuple[int, int, int], list[LogQuery]] = {}
        for q in forward:
            per_slot.setdefault((q.shard_id, q.address, q.key), []).append(q)
        return history, per_slot


class GoldenEventSink:
    def __init__(self) -> None:
        self.frames = _FrameStack()

    def add_partial_query(self, monotonic_cycle_counter: int, query: LogQuery) -> None:
        assert query.rw_flag and not query.rollback
        assert query.aux_byte in (params.EVENT_AUX_BYTE, params.L1_MESSAGE_AUX_BYTE)
        forward, rollbacks = self.frames.current()
        forward.append(query)
        rollbacks.append(query.with_(rollback=True))

    def start_frame(self, timestamp: int) -> None:
        self.frames.start_frame()

    def finish_frame(self, panicked: bool, timestamp: int) -> None:
        self.frames.finish_frame(panicked)

    def flatten(self) -> tuple[list[LogQuery], list[EventMessage], list[EventMessage]]:
        """Cancel (query, rollback) pairs by timestamp; split by aux byte
        (event_sink.rs:66-131)."""
        assert len(self.frames.frames) == 1
        forward, _ = self.frames.frames[0]
        history = list(forward)
        tmp: dict[int, LogQuery] = {}
        for q in forward:
            if q.timestamp in tmp:
                assert q.rollback
                del tmp[q.timestamp]
            else:
                assert not q.rollback
                tmp[q.timestamp] = q
        events: list[EventMessage] = []
        l1_messages: list[EventMessage] = []
        for ts in sorted(tmp):
            q = tmp[ts]
            msg = EventMessage(
                shard_id=q.shard_id, is_first=q.is_service,
                tx_number_in_block=q.tx_number_in_block,
                address=q.address, key=q.key, value=q.written_value)
            (events if q.aux_byte == params.EVENT_AUX_BYTE else l1_messages).append(msg)
        return history, events, l1_messages
