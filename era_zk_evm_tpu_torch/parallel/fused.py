"""Sharded block execution on the fused engine.

The port of `era_zk_evm_tpu/parallel/fused.py`: data parallel over the
batch, each device running the K-cycle kernel (K1, with K2 in rolling
mode) on its shard under a per-shard config, then the block aggregates of
`parallel.mesh.run_block`.  The port has one engine for the JAX package's
fused and jnp engines, so this shares `mesh.run_block`'s body.
"""

from __future__ import annotations

from ..config import VmConfig
from .mesh import Mesh, ShardedState, run_block, shard_state


def run_block_fused(state, config: VmConfig, n_cycles: int, mesh: Mesh,
                    axis_name: str = "dp", tile: int = 128, k_inner: int = 64,
                    interpret: bool | None = None):
    """Advance a batch-sharded state n_cycles on the fused kernel, in
    launches of `k_inner` cycles, then fold the same block aggregates as
    `parallel.mesh.run_block` (`cycles_retired` as float32) -> (state,
    aggregates).

    `state` is a `ShardedState` over `mesh`, or a plain `BatchedVmState`,
    which is sharded over `mesh` first.  `tile` (the TPU kernel's lanes per
    VMEM tile) and `interpret` (Pallas interpret mode) are accepted and
    ignored: the Hopper kernel runs one thread a lane, and its plain
    version is what a CPU tensor runs."""
    del tile, interpret
    if not isinstance(state, ShardedState):
        state = shard_state(state, mesh, axis_name)
    elif state.mesh != mesh:
        raise ValueError("the state is sharded over another mesh")
    return run_block(state, config, n_cycles, k_inner=k_inner)

