"""Witness query records and aux types (surface of `zk_evm_abstractions`).

The port's one set of query classes is `golden/queries.py` (a copy of
`era_zk_evm_tpu/golden/queries.py`): MemoryQuery / LogQuery /
DecommittmentQuery, the aux enums and the flattened EventMessage, with U256
values as Python ints.  This module re-exports them, so a stream the golden
oracle builds and one the device readers build compare equal.
`tests/test_torch_golden.py` holds the copy equal to its source.
"""

from ..golden.queries import (  # noqa: F401
    DecommittmentQuery, EventMessage, LogQuery, MemoryQuery, MemoryType,
    RefundType,
)
