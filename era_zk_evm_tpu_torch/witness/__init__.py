"""Witness machinery: the rolling memory-queue sponge, packed streams, queue
commitments over query structs, the device fold and the sorted queue."""

from .commitment import (  # noqa: F401
    block_commitment, commit_all_device_queues, commit_decommitter_queue,
    commit_device_queues, commit_log_queue, commit_memory_queue,
    device_decommit_streams, device_log_streams, device_queue_streams,
    serialize_decommittment, serialize_log_query, serialize_memory_query,
)
from .device_fold import (  # noqa: F401
    finalize_rolling_device, keccak256_device_stream,
)
from .sorted_queue import (  # noqa: F401
    block_grand_product, grand_product, log_queue_fingerprints,
    sort_log_queue,
)
