"""Block-level execution pipeline: the port's host-facing entry point.

The port of `era_zk_evm_tpu/block.py`.  The whole block is one call:

    result = execute_block(config, [TxSpec(...), ...])

* transactions run over `config.batch` lanes with continuous refill
  (`models/scheduler.py`) on the port's engine, `fused_cycle.run_cycles`:
  the K1 kernel on the card, its plain torch version on the CPU;
* every tx gets its ordered witness streams (the memory, log, decommit and
  precompile families), its net states (final storage, net events, net L1
  messages) and per-family keccak256 commitments, computed on the device
  (`commit_block`: the ragged sponge of `witness/packed.py` on the card);
* the block gets per-family folds over the tx digests in tx order and the
  sorted-log grand products (per tx and for the block).

`streams` picks the streams' form, as in the reference: "packed" (record
arrays) or "objects" (the reference's query structs, `witness/queries.py`).
The block is committed from the packed records either way; the objects form
then reads each tx's records into structs (`packed.queries_from_packed`).

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
    RECORD_WORDS, block_grand_product, digest_bytes, fold_digest_rows,
    packed_grand_products, queries_from_packed, stream_digests,
)

__all__ = ["BlockResult", "TxResult", "TxSpec", "commit_block",
           "execute_block"]


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
    `run_cycles` (one kernel for every length, nothing recompiles).
    `streams` is "packed" or "objects" (see the module docstring).
    Scheduling-policy knobs pass through to `run_block_refill`."""
    del tile
    if engine not in ("auto", "fused", "jnp"):
        raise ValueError(f"unknown engine {engine!r}")
    if streams not in ("packed", "objects"):
        raise ValueError(f"unknown streams {streams!r}")
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
                                      collect="packed", device=device,
                                      **sched_kwargs)
    tx_commitments, commitments, sorted_products = commit_block(
        config, results, device)
    if streams == "objects":
        results = [dataclasses.replace(r, streams={
            name: queries_from_packed(name, words)
            for name, words in r.streams.items()}) for r in results]
    return BlockResult(txs=results, tx_commitments=tx_commitments,
                       commitments=commitments,
                       sorted_log_products=sorted_products,
                       block_log_product=block_grand_product(sorted_products),
                       stats=stats)


def commit_block(config: VmConfig, results: list[TxResult],
                 device: torch.device | str = DEFAULT_DEVICE) -> tuple:
    """The block's commitments from its txs' packed streams, on `device`:
    (per-tx {family: digest}, {family: fold over the tx digests in tx
    order}, per-tx sorted-log grand products).  The tx streams of every
    family are one sponge launch and the families' folds another, over the
    digests where they lie (`witness/packed.py`); the grand products take
    K3 for the fingerprints and the host for the products."""
    families = _families(config)
    streams = [r.streams.get(name, np.zeros((0, RECORD_WORDS[name]),
                                            np.uint32))
               for name in families for r in results]
    digests = stream_digests(streams, device).view(len(families),
                                                   len(results), 8)
    folds = digest_bytes(fold_digest_rows(digests))
    rows = digest_bytes(digests.view(-1, 8))
    tx_commitments = [
        {name: rows[f * len(results) + i] for f, name in enumerate(families)}
        for i in range(len(results))]
    commitments = dict(zip(families, folds))
    log_streams = [r.streams.get(
        "log", np.zeros((0, RECORD_WORDS["log"]), np.uint32))
        for r in results]
    return (tx_commitments, commitments,
            packed_grand_products(log_streams, device=device))
