"""Witness-queue draining and rewind between chained calls.

The port of `era_zk_evm_tpu/models/spill.py::drain_witness_queues` and
`_rewind_queues_jit`: the dense memory / log / decommit / precompile queues
are block-positioned by the block clock, so draining reads their contents
to host query structs and rewinds the clock, and a queue sized for one
segment serves an unbounded run.  Concatenating per-segment drains gives
the one-shot stream.
"""

from __future__ import annotations

from ..config import VmConfig
from .state import BatchedVmState

#: the witness-queue tensors and their clocks, which a rewind zeroes
QUEUE_FIELDS = (
    "global_step",                                   # the block clock
    "wq_count", "wq_meta", "wq_value", "wq_flags",
    "lq_count", "lq_meta", "lq_addr", "lq_key", "lq_read", "lq_written",
    "dq_count", "dq_hash", "dq_meta",
    "pq_count", "pq_blocks", "pq_meta", "pq_value", "pq_flags",
)


def drain_witness_queues(state: BatchedVmState, config: VmConfig):
    """Read every enabled queue family to host query structs, then rewind
    the queues in place.

    Returns (state, streams), streams a dict of per-lane lists: ``memory``
    (MemoryQuery), ``log`` (LogQuery), ``decommit`` (DecommittmentQuery),
    ``precompile`` (MemoryQuery), for the families the config enables.
    Timestamps keep counting, so concatenated drains form the continuous
    stream.
    """
    # the readers serialize through witness/packed, which rewinds with
    # this module's rewind_queues
    from ..witness.commitment import (
        device_decommit_streams, device_log_streams,
        device_precompile_streams, device_queue_streams,
    )

    streams = {}
    if config.queue_capacity > 0:
        streams["memory"] = device_queue_streams(state)
    if config.log_queue_capacity > 0:
        streams["log"] = device_log_streams(state)
    if config.decommit_queue_capacity > 0:
        streams["decommit"] = device_decommit_streams(state)
    if config.precompile_queue_capacity > 0:
        streams["precompile"] = device_precompile_streams(state)
    return rewind_queues(state), streams


def rewind_queues(state: BatchedVmState) -> BatchedVmState:
    """Empty every witness queue and reset the block clocks.

    Updates `state` in place (and returns it): the queue tensors are zeroed
    where they lie, so a chained call reuses their memory.  Timestamps keep
    counting and the rolling sponge (`wc_*`) is kept.
    """
    for name in QUEUE_FIELDS:
        getattr(state, name).zero_()
    return state
