"""Random round-witness scratch blocks for the splice kernel's checks.

`splice_case(name)` gives a config with the precompile units and their
queue, a lane state holding only the fields the splice touches
(`pq_meta`, `pq_value`, `pq_flags`, `pq_count`, `pq_blocks`,
`lane_error`, drawn at random over the whole u32 range) and a scratch block
(`fused_cycle.new_pq_block`'s layout) whose rows are random and whose emit
flags follow the case: no flagged cycle, every cycle flagged, flagged
cycles with silent lanes, trailing unflagged cycles, overflow at cap - PS
(cap - PS a multiple of PS, or not), a nonzero starting `pq_blocks`, n < K,
and PS as in kPrecomp and in kEc.  `SPLICE_CASES` names them.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from ..config import VmConfig, precompile_queue_slots

#: name: (batch, K, n, ecrecover, cap in blocks, extra cap rows, emitting
#: density, flagged cycles, starting pq_blocks)
SPLICE_CASES = {
    "none_flagged": (37, 8, 8, False, 20, 0, 0.5, "none", 0),
    "all_flagged": (37, 8, 8, True, 20, 0, 1.0, "all", 0),
    "silent_lanes": (300, 16, 16, False, 40, 0, 0.3, "random", 0),
    "trailing": (300, 16, 16, True, 40, 0, 0.5, "head", 2),
    "overflow": (300, 16, 16, False, 6, 0, 0.5, "all", 1),
    "overflow_unaligned": (300, 16, 11, True, 6, 5, 0.4, "random", 2),
    "started": (64, 12, 12, True, 30, 0, 0.5, "random", 9),
    "short_chunk": (513, 130, 97, False, 200, 0, 0.2, "random", 5),
}


def splice_config(batch: int, ecrecover: bool, cap_blocks: int,
                  extra: int) -> VmConfig:
    cfg = VmConfig(batch=batch, code_words=16, stack_words=256,
                   stack_abs_words=64, stack_sp_base=960, heap_words=16,
                   aux_heap_words=16, max_depth=8, storage_slots=8,
                   journal_slots=64, event_slots=64,
                   precompile_keccak_blocks=2, precompile_sha_rounds=2,
                   precompile_ecrecover=ecrecover)
    ps = sum(precompile_queue_slots(cfg))
    return dataclasses.replace(cfg, precompile_queue_capacity=cap_blocks * ps
                               + extra)


def _i32(gen, *shape):
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         dtype=torch.int32)


def splice_case(name: str, seed: int = 0):
    """(config, state, pq_block, n) of case `name`, on the CPU."""
    B, K, n, ec, cap_blocks, extra, density, flagged, p0 = SPLICE_CASES[name]
    cfg = splice_config(B, ec, cap_blocks, extra)
    ps = sum(precompile_queue_slots(cfg))
    cap = cfg.precompile_queue_capacity
    gen = torch.Generator().manual_seed(seed)
    cycles = torch.arange(K)
    flag = {"none": cycles < 0, "all": cycles >= 0,
            "head": cycles < n // 2,
            "random": torch.rand(K, generator=gen) < 0.5}[flagged]
    emitting = (torch.rand((K, B), generator=gen) < density) & flag[:, None]
    # a flagged cycle has an emitting lane
    emitting[:, 0] |= flag
    block = (_i32(gen, K, ps, 4, B), _i32(gen, K, ps, 8, B),
             _i32(gen, K, ps, B),
             emitting.to(torch.int32) * torch.randint(
                 1, 4, (K, B), generator=gen, dtype=torch.int32),
             torch.randint(0, 9, (K, B), generator=gen, dtype=torch.int32))
    state = types.SimpleNamespace(
        pq_meta=_i32(gen, B, cap, 4), pq_value=_i32(gen, B, cap, 8),
        pq_flags=_i32(gen, B, cap),
        pq_count=torch.randint(0, 100, (B,), generator=gen,
                               dtype=torch.int32),
        pq_blocks=p0 + torch.randint(0, 3, (B,), generator=gen,
                                     dtype=torch.int32),
        lane_error=torch.rand(B, generator=gen) < 0.1,
        done=torch.zeros(B, dtype=torch.bool))
    return cfg, state, block, n


SPLICE_FIELDS = ("pq_meta", "pq_value", "pq_flags", "pq_count", "pq_blocks",
                 "lane_error")


def to_device(state, block, device):
    """The case's state and block on `device` (copies)."""
    st = types.SimpleNamespace(**{k: v.to(device)
                                  for k, v in vars(state).items()})
    return st, tuple(x.to(device) for x in block)
