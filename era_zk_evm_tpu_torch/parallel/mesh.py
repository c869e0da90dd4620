"""Mesh construction and block-scale sharding of the batched VM.

The port of `era_zk_evm_tpu/parallel/mesh.py`.  Transaction contexts (the
lanes) are the data-parallel axis: a mesh is an ordered tuple of devices,
`shard_state` splits every state field into contiguous blocks of lanes,
one private copy a device, and `run_block` advances every shard with the
port's one engine (`fused_cycle.run_cycles`: K1, and K2 in rolling mode,
on a card; the plain versions on the CPU) and then reduces the block
aggregates over the shards.  The only cross-device traffic is the
aggregates and, with the rolling commitment, the all-gather of the 32-byte
per-lane digests that the ordered block fold needs.

A mesh may name one device more than once: `make_mesh(devices=["cpu"] *
8)` is the counterpart of the JAX tests' 8-device virtual CPU mesh, and
`[cuda:0] * 4` runs four shards on one card (one after another: the shards
of one card share it).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..config import CS, VmConfig
from ..models import fused_cycle
from ..models.state import (
    FIELD_NAMES, LANE_AXIS, BatchedVmState, reference_array,
)
from ..witness.device_fold import (
    finalize_rolling_device, keccak256_device_stream,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one data-parallel axis."""

    devices: tuple[torch.device, ...]
    axis_name: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis_name: str = "dp",
              devices=None) -> Mesh:
    """A mesh over the cards `cuda:0 .. cuda:{count - 1}` (the first
    `n_devices` of them), or over an explicit device list, repeats
    allowed.  There is no CPU fallback: without a card the default mesh is
    empty and asking for devices fails."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), axis_name)


@dataclasses.dataclass
class ShardedState:
    """A batch split over a mesh: `shards[i]` holds lanes i * B/n ..
    (i + 1) * B/n - 1 on `mesh.devices[i]`, each field a contiguous tensor
    of its own."""

    shards: list[BatchedVmState]
    mesh: Mesh

    @property
    def batch(self) -> int:
        return sum(int(s.done.shape[0]) for s in self.shards)

    def gather(self, device: torch.device | str) -> BatchedVmState:
        """One state on `device`, the lanes in global order."""
        return BatchedVmState(**{
            name: torch.cat([getattr(s, name).to(device)
                             for s in self.shards], dim=LANE_AXIS[name])
            for name in FIELD_NAMES})


def _private_copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    # a slice of a lane-last field is neither contiguous nor private, and
    # `.to` on the same device returns the same view: the engines write
    # the shards in place
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def shard_state(state: BatchedVmState, mesh: Mesh,
                axis_name: str = "dp") -> ShardedState:
    """Split every field along its stored lane axis (`LANE_AXIS`), one
    contiguous private copy a device; the batch must divide the mesh
    size."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}, not {axis_name!r}")
    n, batch = mesh.size, int(state.done.shape[0])
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over {n} devices")
    per = batch // n
    return ShardedState([BatchedVmState(**{
        name: _private_copy(getattr(state, name).narrow(
            LANE_AXIS[name], i * per, per), dev)
        for name in FIELD_NAMES}) for i, dev in enumerate(mesh.devices)], mesh)


def _as_sharded(state) -> ShardedState:
    if isinstance(state, ShardedState):
        return state
    return ShardedState([state], Mesh((state.done.device,)))


def _advance(sharded: ShardedState, config: VmConfig, n_cycles: int,
             k_inner: int) -> None:
    """Advance every shard n_cycles, in place, each under its per-shard
    config.  Every shard is launched before any synchronisation, so on
    distinct cards the shards overlap."""
    n = sharded.mesh.size
    if config.batch % n or sharded.batch != config.batch:
        raise ValueError(f"config batch {config.batch} does not match the "
                         f"{sharded.batch} lanes over {n} devices")
    shard_config = dataclasses.replace(config, batch=config.batch // n)
    for shard, dev in zip(sharded.shards, sharded.mesh.devices):
        with _on(dev):
            fused_cycle.run_cycles(shard, shard_config, n_cycles,
                                   k_inner=k_inner)


def _on(dev: torch.device):
    """The context that makes `dev` the host thread's current card (a
    kernel launches there); nothing for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def block_aggregates(state, config: VmConfig) -> dict:
    """The block aggregates of `era_zk_evm_tpu/parallel/mesh.py`, reduced
    over the shards of `state` (a `ShardedState`, or a plain state as one
    shard) onto `mesh.devices[0]`: finished and error lanes and
    witness queries (int32 sums), cycles retired and root-frame ergs
    remaining (float32, as JAX with x64 off).  The float32 sums are taken
    of the float32 values in float64, which holds them exactly at any batch
    the state can have, then rounded once: the result does not depend on
    how the lanes are sharded (XLA sums in float32, in its own order, so
    JAX may differ from it by float32's rounding).  With the rolling
    commitment, `memory_block_commitment` (int32[8]): each shard finalizes
    its lanes' digests, the digest rows go to `mesh.devices[0]` in global
    lane order (the all-gather, 32 bytes a lane) and one launch of the
    ragged sponge folds them (`keccak256_device_stream`)."""
    sharded = _as_sharded(state)
    out = sharded.mesh.devices[0]

    def total(fn, dtype):
        parts = [fn(s).sum(dtype=dtype).to(out) for s in sharded.shards]
        return torch.stack(parts).sum(dtype=dtype)

    def f32(x):
        return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.float32).to(
            torch.float64)

    agg = {
        "done_lanes": total(lambda s: s.done, torch.int32),
        "error_lanes": total(lambda s: s.lane_error, torch.int32),
        "cycles_retired": total(lambda s: f32(s.monotonic_cycle_counter),
                                torch.float64).to(torch.float32),
        "witness_queries": total(lambda s: s.wq_count, torch.int32),
        "root_ergs": total(
            lambda s: f32(reference_array("cs_scalars", s.cs_scalars)
                          [:, 0, CS["ergs_remaining"]]),
            torch.float64).to(torch.float32),
    }
    if config.rolling_commitment:
        rows = torch.cat([finalize_rolling_device(s.wc_state, s.wc_count)
                          .to(out) for s in sharded.shards])
        with _on(out):
            agg["memory_block_commitment"] = keccak256_device_stream(rows)
    return agg


def run_block(state, config: VmConfig, n_cycles: int, k_inner: int = 128):
    """One sharded block-execution step: advance all lanes n_cycles, then
    fold the block aggregates over the mesh (`block_aggregates`).

    `state` is a `ShardedState` or a plain `BatchedVmState` (a one-shard
    mesh on its own device); it is advanced in place and returned with the
    aggregates, (state, aggregates), as the JAX `run_block` returns them.
    Every shard runs `fused_cycle.run_cycles` in launches of `k_inner`
    cycles, the port's one engine for the JAX package's jnp and fused
    engines alike."""
    _advance(_as_sharded(state), config, n_cycles, k_inner)
    return state, block_aggregates(state, config)
