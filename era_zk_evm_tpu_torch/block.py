"""Block-level execution pipeline: the port's host-facing entry point.

The port of `era_zk_evm_tpu/block.py`.  The whole block is one call:

    result = execute_block(config, [TxSpec(...), ...])

* transactions run over `config.batch` lanes with continuous refill
  (`models/scheduler.py`) on the port's engine, `fused_cycle.run_cycles`:
  the K1 kernel on the card, its plain torch version on the CPU;
* every tx gets its ordered witness streams as packed record arrays (the
  memory, log, decommit and precompile families), its net states (final
  storage, net events, net L1 messages) and per-family keccak256
  commitments, computed on the device (`witness/packed.py`, K3 on the
  card);
* the block gets per-family folds over the tx digests in tx order and the
  sorted-log grand products (per tx and for the block).

Per-tx results do not depend on the batch or the scheduling policy;
`tests/test_torch_block.py` holds them equal to the JAX pipeline's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import VmConfig, check_slice
from .models import fused_cycle
from .models.scheduler import TxResult, TxSpec, run_block_refill
from .models.state import DEFAULT_DEVICE
from .witness.packed import (
    RECORD_WORDS, block_grand_product, commit_packed_streams,
    fold_digests_device, packed_grand_products,
)

__all__ = ["BlockResult", "TxResult", "TxSpec", "execute_block"]


@dataclasses.dataclass
class BlockResult:
    """Everything a reference user gets from a block, in tx order."""

    txs: list[TxResult]                 # per-tx results incl. streams + nets
    tx_commitments: list[dict]          # per-tx {family: 32-byte digest}
    commitments: dict                   # per-family block fold over tx order
    sorted_log_products: list[int]      # per-tx grand product (sorted stream)
    block_log_product: int              # Goldilocks product over tx order
    stats: dict                         # scheduler occupancy stats

    @property
    def all_ok(self) -> bool:
        return all(t.status == "ok" for t in self.txs)


def _families(config: VmConfig) -> list[str]:
    return [name for name, cap in (
        ("memory", config.queue_capacity),
        ("log", config.log_queue_capacity),
        ("decommit", config.decommit_queue_capacity),
        ("precompile", config.precompile_queue_capacity),
    ) if cap > 0]


def execute_block(config: VmConfig, txs: list[TxSpec], engine: str = "auto",
                  chunk: int = 64, tile: int | None = None,
                  k_inner: int = 128, refill: bool = True,
                  fresh_builder=None, streams: str = "packed",
                  device: torch.device | str = DEFAULT_DEVICE,
                  **sched_kwargs) -> BlockResult:
    """Run a block of transactions end to end on `device`; the arguments
    of `era_zk_evm_tpu.block.execute_block`, plus the device.

    Every `engine` ("auto", "fused", "jnp") runs the port's one engine,
    `fused_cycle.run_cycles`, in launches of at most `k_inner` cycles;
    `chunk` is the cycles-per-round granularity (drains and refills happen
    at chunk boundaries).  `tile` is accepted and ignored: it sets the TPU
    kernel's lanes per VMEM tile, and the Hopper kernel runs one thread per
    lane.  `adaptive_chunk` gets a `run_dyn_fn` built on the same
    `run_cycles` (one kernel for every length, nothing recompiles).  Only
    `streams="packed"` is ported.  Scheduling-policy knobs pass through to
    `run_block_refill`."""
    del tile
    if engine not in ("auto", "fused", "jnp"):
        raise ValueError(f"unknown engine {engine!r}")
    if streams != "packed":
        raise NotImplementedError(
            f"streams={streams!r}: only the packed streams are ported")
    check_slice(config)

    def run_fn(state, config, n):
        return fused_cycle.run_cycles(state, config, n,
                                      k_inner=min(k_inner, n))

    if sched_kwargs.get("adaptive_chunk") \
            and "run_dyn_fn" not in sched_kwargs:
        dyn_k = min(k_inner, chunk)

        def run_dyn(state, config, n):
            return fused_cycle.run_cycles(state, config, n, k_inner=dyn_k)

        sched_kwargs["run_dyn_fn"] = run_dyn
    results, stats = run_block_refill(config, txs, run_fn, chunk,
                                      refill=refill,
                                      fresh_builder=fresh_builder,
                                      collect=streams, device=device,
                                      **sched_kwargs)
    families = _families(config)
    tx_commitments: list[dict] = [dict() for _ in results]
    for name in families:
        w = RECORD_WORDS[name]
        per_tx = [r.streams.get(name, np.zeros((0, w), np.uint32))
                  for r in results]
        for c, d in zip(tx_commitments, commit_packed_streams(per_tx, device)):
            c[name] = d
    commitments = {
        name: fold_digests_device([c[name] for c in tx_commitments], device)
        for name in families}
    log_streams = [r.streams.get(
        "log", np.zeros((0, RECORD_WORDS["log"]), np.uint32))
        for r in results]
    sorted_products = packed_grand_products(log_streams, device=device)
    return BlockResult(txs=results, tx_commitments=tx_commitments,
                       commitments=commitments,
                       sorted_log_products=sorted_products,
                       block_log_product=block_grand_product(sorted_products),
                       stats=stats)
