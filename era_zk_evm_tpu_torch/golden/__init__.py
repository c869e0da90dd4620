"""The golden sequential EraVM — the framework's conformance oracle.

Role-equivalent to running the Rust reference out-of-band: exact cycle
semantics, oracle backends, witness streams.  Every TPU kernel and the batched
interpreter are differentially tested against this model (SURVEY.md §4).
"""

from .decommitter import GoldenDecommitter, UnknownCodeHashError  # noqa: F401
from .memory import GoldenMemory  # noqa: F401
from .precompiles import GoldenPrecompilesProcessor  # noqa: F401
from .queries import (  # noqa: F401
    DecommittmentQuery, EventMessage, LogQuery, MemoryQuery, MemoryType,
    RefundType,
)
from .state import CallStackEntry, Flags, PrimitiveValue, VmLocalState  # noqa: F401
from .storage import GoldenEventSink, GoldenStorage  # noqa: F401
from .vm import BlockProperties, ErrorFlags, GoldenVm  # noqa: F401
from .witness import CollectingWitnessTracer, DummyTracer  # noqa: F401
