"""Segmented block executor: unbounded blocks on bounded device geometry.

The port of `era_zk_evm_tpu/models/executor.py`.  The reference's host loop
runs each VM to its end over unbounded oracles (storage and decommitter
HashMaps, pages allocated forever).  The device arenas are fixed in size,
so a block whose txs recurse deeply, touch many keys or call many
contracts runs as SEGMENTS with the spill protocols of `models/spill.py`
between them:

  per segment
    1. callstack window normalization (spill / unspill bottom frames so the
       fixed device depth serves unbounded recursion);
    2. the segment runs on a clone of a SNAPSHOT; the log-queue
       detectors for cold storage keys AND cold code hashes run together,
       rehydrate what is missing, and replay the segment until no cold
       touch remains (miss-free segments, the common case, run once);
    3. the witness queues drain to host (block clocks rewind), the journal
       and event arrays compact, storage-KV and code-bank entries beyond
       the keep set evict to host, dead heap-frame slots reclaim.

The concatenated drained streams equal an unsegmented run's
(`tests/test_torch_executor.py`, against a big-geometry run on the same
programs and against the JAX executor).  On a CUDA state every segment and
every replay is a K1 launch (`fused_cycle.run_cycles`); the protocols run
in torch ops on the card and on the host between launches.

Geometry contract (asserted): segment <= (max_depth - 3) // 2 when
callstack normalization is on; log_queue_capacity >= segment (the log
stream is both detectors' input); code_pages covers the entry slot +
boundary-live pages + one segment's distinct contracts; storage_slots
covers journal-pinned entries + one segment's distinct keys; heap_frames
covers boundary-live frames + one segment's far calls.
"""

from __future__ import annotations

import dataclasses

from ..config import VmConfig
from .spill import (
    HostCodeBank, HostStorage, SpilledFrames, _missing,
    _touched_in_log_queue, compact_log_state_host, drain_witness_queues,
    extend_streams, normalize_callstack, rehydrate_code, rehydrate_keys,
    reclaim_heap_frames, spill_code_bank, spill_storage_kv,
)
from .state import BatchedVmState, clone_state


@dataclasses.dataclass
class BlockHosts:
    """Host-side overflow stores threaded through a segmented execution."""

    storage: HostStorage
    code: HostCodeBank
    frames: SpilledFrames

    @classmethod
    def empty(cls, batch: int) -> "BlockHosts":
        return cls(storage=HostStorage.empty(batch),
                   code=HostCodeBank.empty(batch),
                   frames=SpilledFrames.empty(batch))


def run_block_segments(state: BatchedVmState, config: VmConfig, run_cycles,
                       n_cycles: int, segment: int,
                       hosts: BlockHosts | None = None,
                       keep_storage: int = 0, keep_code: int = 0,
                       max_replays: int = 8,
                       normalize_stack: bool = True,
                       reclaim_heap: bool = True):
    """Run `n_cycles` in `segment`-cycle slices with every spill protocol
    active.  Returns (state, hosts, streams), streams the per-segment queue
    drains concatenated (equal to an unsegmented drain).

    `run_cycles` is either engine's entry point
    (`models.fused_cycle.run_cycles`, K1 on a CUDA state, or
    `models.batched_vm.run_cycles`, the plain engine), called as
    `run_cycles(state, config, n)`.
    """
    if hosts is None:
        hosts = BlockHosts.empty(config.batch)
    log_on = config.storage_slots > 0 and config.log_queue_capacity > 0
    if normalize_stack:
        assert segment <= (config.max_depth - 3) // 2, \
            "segment too long for the callstack window (max_depth)"
    assert not log_on or config.log_queue_capacity >= segment
    acc: dict[str, list[list]] = {}
    done = 0
    while done < n_cycles:
        n = min(segment, n_cycles - done)
        if normalize_stack:
            state, hosts.frames = normalize_callstack(
                state, config, hosts.frames,
                lo=n + 1, hi=config.max_depth - 2 - n)
        snapshot = state
        for attempt in range(max_replays + 1):
            out = run_cycles(clone_state(snapshot), config, n)
            if not log_on:
                break
            t_keys, t_hashes = _touched_in_log_queue(out)
            miss_k = _missing(t_keys, hosts.storage.maps)
            miss_h = _missing(t_hashes, hosts.code.maps)
            if not any(miss_k) and not any(miss_h):
                break
            assert attempt < max_replays, "segment replay did not converge"
            if any(miss_k):
                snapshot = rehydrate_keys(snapshot, config, hosts.storage,
                                          miss_k)
            if any(miss_h):
                snapshot, hosts.code = spill_code_bank(
                    snapshot, config, hosts.code, keep=0,
                    pin_hashes=t_hashes)
                snapshot = rehydrate_code(snapshot, config, hosts.code,
                                          miss_h)
        state, streams = drain_witness_queues(out, config)
        extend_streams(acc, streams, config.batch)
        if config.storage_slots > 0:
            state = compact_log_state_host(state, config)
            state, hosts.storage = spill_storage_kv(
                state, config, hosts.storage, keep=keep_storage)
            state, hosts.code = spill_code_bank(
                state, config, hosts.code, keep=keep_code)
        if reclaim_heap and config.heap_frames > 1:
            state = reclaim_heap_frames(state, config)
        done += n
    if normalize_stack:
        state, hosts.frames = normalize_callstack(
            state, config, hosts.frames,
            lo=config.max_depth - 2, hi=config.max_depth - 2)
    return state, hosts, acc
