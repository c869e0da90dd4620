"""Witness-queue rewind between chained calls.

The port of `era_zk_evm_tpu/models/spill.py::_rewind_queues_jit`.
"""

from __future__ import annotations

from .state import BatchedVmState

_QUEUE_FIELDS = (
    "global_step",                                   # the block clock
    "wq_count", "wq_meta", "wq_value", "wq_flags",
    "lq_count", "lq_meta", "lq_addr", "lq_key", "lq_read", "lq_written",
    "dq_count", "dq_hash", "dq_meta",
    "pq_count", "pq_blocks", "pq_meta", "pq_value", "pq_flags",
)


def rewind_queues(state: BatchedVmState) -> BatchedVmState:
    """Empty every witness queue and reset the block clocks.

    Updates `state` in place (and returns it): the queue tensors are zeroed
    where they lie, so a chained call reuses their memory.  Timestamps keep
    counting and the rolling sponge (`wc_*`) is kept.
    """
    for name in _QUEUE_FIELDS:
        getattr(state, name).zero_()
    return state
