"""Multi-device dry run: the sharded block step on tiny shapes.

The port of `__graft_entry__.py::dryrun_multichip`: build an n-device mesh,
run the fused engine's sharded block step on the full witness-queue config,
again with the rolling commitment (the collective block fold), then the
storage + rolling config on `run_block`, and print the same lines as the
JAX run.  `MULTICHIP_r05.json` records that run at n = 8.
"""

from __future__ import annotations

import numpy as np

from ..config import VmConfig
from ..isa.assembler import assemble_to_code_words
from ..models.state import make_entry_state
from .fused import run_block_fused
from .mesh import make_mesh, run_block, shard_state

#: `__graft_entry__.py::_bench_program`
BENCH_PROGRAM = """
    add 1, r0, r10
    add 16, r0, r1           ; loop counter
    add 0, r0, r2
    loop:
    add r2, r1, r2
    mul r2, r1, r3, r4
    xor r3, r2, r5
    shl r5, r10, r6
    add r6, r0, stack+=[1]
    add stack-=[1], r0, r7
    st.h 0, r7
    ld.h 32, r8
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
"""


def _configs(n_devices: int) -> dict[str, VmConfig]:
    """The dry run's three configs, as `__graft_entry__.py` builds them."""
    small = dict(batch=2 * n_devices, code_words=16, stack_words=256,
                 sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                 heap_words=16, aux_heap_words=8, max_depth=4)
    storage = dict(storage_slots=4, journal_slots=8, event_slots=8,
                   log_queue_capacity=8, heap_frames=2, code_pages=2,
                   decommit_queue_capacity=8)
    return {
        "fused": VmConfig(**small, queue_capacity=64, **storage),
        "fused+rolling": VmConfig(**small, queue_capacity=0,
                                  rolling_commitment=True),
        "jnp": VmConfig(batch=2 * n_devices, code_words=16, stack_words=2048,
                        heap_words=16, aux_heap_words=8, max_depth=4,
                        queue_capacity=0, rolling_commitment=True, **storage),
    }


def _counts(aggregates: dict) -> tuple[dict, str | None]:
    """The aggregates as floats, keys sorted as JAX prints a pytree dict,
    and the block commitment's hex (None without one)."""
    commit = aggregates.pop("memory_block_commitment", None)
    if commit is not None:
        commit = commit.cpu().numpy().view(np.uint8).tobytes().hex()
    return {k: float(aggregates[k]) for k in sorted(aggregates)}, commit


def dryrun_multichip(n_devices: int, devices=None,
                     scaling: bool = True) -> dict:
    """Run the three legs on an n-device mesh (the cards unless `devices`
    lists others, repeats allowed), print one line each and, with
    `scaling`, the shared-device throughput retention of `measure`; return
    {leg: (aggregates, commitment hex or None)}."""
    mesh = make_mesh(n_devices, devices=devices)
    words = assemble_to_code_words(BENCH_PROGRAM)
    out = {}
    for leg, config in _configs(n_devices).items():
        state = shard_state(make_entry_state(config, [words] * config.batch,
                                             device="cpu"), mesh)
        if leg == "jnp":
            state, agg = run_block(state, config, 4)
        else:
            state, agg = run_block_fused(state, config, 4, mesh, tile=1,
                                         k_inner=4)
        counts, commit = _counts(agg)
        if counts["error_lanes"] != 0.0:
            raise AssertionError(f"{leg}: {counts}")
        tail = "" if commit is None else f", block_commitment={commit}"
        print(f"dryrun_multichip({n_devices}) {leg}: OK — {counts}{tail}")
        out[leg] = (counts, commit)

    if scaling:
        from .scaling import measure

        counts = (1, n_devices) if n_devices > 1 else (1,)
        rates = {n: measure(n, devices=None if devices is None
                            else list(devices)[:n]) for n in counts}
        retention = rates[counts[-1]] / rates[counts[0]]
        # shards that share a device share its silicon: the rate should
        # stay flat in n, and a big drop would mean the sharded step
        # serializes more than its shards
        kind = ("shared-device mesh, plumbing-only"
                if len(set(mesh.devices)) < mesh.size else "mesh")
        print(f"dryrun_multichip scaling ({kind}): "
              + ", ".join(f"rate({n} dev)={r / 1e6:.2f}M cyc/s"
                          for n, r in rates.items())
              + f", retention={retention:.2f}")
        out["scaling"] = rates
    return out
