"""Mesh + sharding layer (data parallel over transaction contexts)."""

from .mesh import (  # noqa: F401
    Mesh, ShardedState, make_mesh, run_block, shard_state,
)
