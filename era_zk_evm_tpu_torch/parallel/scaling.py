"""Weak-scaling harness.

The port of `era_zk_evm_tpu/parallel/scaling.py`: each device carries the
same lane count; efficiency = throughput(n devices) / (n * throughput(1
device)).  Across cards the only cross-device traffic is the aggregate
reduction (and, with the rolling commitment, 32 bytes a lane), so the
efficiency should sit near 1.  On a mesh that names one device several
times (`devices=["cpu"] * 8`, `[cuda:0] * 4`) the shards share that device,
so the rate stays flat in n and the ratio validates the plumbing, not the
hardware.
"""

from __future__ import annotations

import time

import torch

from ..config import VmConfig
from ..isa.assembler import assemble_to_code_words
from ..models.state import make_entry_state
from .mesh import make_mesh, run_block, shard_state

#: the JAX harness's `_WORKLOAD`
WORKLOAD = """
    add 1, r0, r10
    add code[@n], r0, r1
    add 0, r0, r2
    loop:
    add r2, r1, r2
    mul r2, r1, r3, r4
    xor r3, r2, r5
    st.h 0, r5
    ld.h 32, r6
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    n: .word 32768
"""


def _synchronize(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure(n_devices: int, lanes_per_device: int = 256, n_cycles: int = 32,
            devices=None) -> float:
    """Cycles/s of an n-device data-parallel mesh (weak scaling): one warm
    run_block, then one timed, synchronised run.  `devices` gives the
    mesh's devices (the cards by default)."""
    batch = n_devices * lanes_per_device
    config = VmConfig(batch=batch, code_words=16, stack_words=2048,
                      sweep_gating=False,
                      heap_words=64, aux_heap_words=16, max_depth=4,
                      queue_capacity=0)
    mesh = make_mesh(n_devices, devices=devices)
    program = assemble_to_code_words(WORKLOAD)
    state = shard_state(make_entry_state(config, [program] * batch,
                                         ergs=(1 << 31) - 1, device="cpu"),
                        mesh)
    run_block(state, config, n_cycles)
    _synchronize(mesh.devices)
    t0 = time.perf_counter()
    state, agg = run_block(state, config, n_cycles)
    _synchronize(mesh.devices)
    dt = time.perf_counter() - t0
    if int(agg["error_lanes"]) != 0:
        raise AssertionError(f"{int(agg['error_lanes'])} lanes set lane_error")
    return batch * n_cycles / dt


def weak_scaling_report(device_counts=(1, 2, 4, 8),
                        devices=None) -> dict[int, float]:
    """{n: efficiency} over the first n devices of `devices` (the cards by
    default)."""
    rates = {n: measure(n, devices=None if devices is None else devices[:n])
             for n in device_counts}
    base = rates[device_counts[0]] / device_counts[0]
    return {n: rates[n] / (n * base) for n in device_counts}
