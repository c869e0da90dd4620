"""Random round-witness scratch blocks for the splice kernel's checks.

`splice_case(name)` gives a config with the precompile units and their
queue, a lane state holding only the fields the splice touches
(`pq_meta`, `pq_value`, `pq_flags`, `pq_count`, `pq_blocks`,
`lane_error`, drawn at random over the whole u32 range) and a scratch block
(`fused_cycle.new_pq_block`'s layout) as K1 leaves it: each emitting lane's
emit word names its data rows (csrc/common.cuh, PQ_EMIT: n_in mem_in rows,
one mem_out row, two for an ecrecover call), which hold random words, and
every other row of the block holds `GARBAGE`, which the splice must never
copy; its slot count is its data rows.  The emit flags follow the case: no
flagged cycle, every cycle flagged, flagged cycles with silent lanes,
trailing unflagged cycles, overflow at cap - PS (cap - PS a multiple of
PS, or not), a nonzero starting `pq_blocks`, n < K, PS as in kPrecomp and
in kEc, and in kEc an ecrecover call and a 5-word hash in the same cycle
(`ec_and_hash`: both have 6 data rows, at other places).  `SPLICE_CASES`
names them.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from ..config import VmConfig, precompile_queue_slots
from ..models import fused_cycle

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
    "ec_and_hash": (96, 8, 8, True, 20, 0, 0.6, "random", 0),
}

#: the word in every scratch row that carries no data
GARBAGE = -0x21524111             # 0xDEADBEEF


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
    # a flagged cycle has an emitting lane; in ec_and_hash lane 0 makes an
    # ecrecover call and lane 1 hashes 5 words
    emitting[:, 0] |= flag
    ps_in = precompile_queue_slots(cfg)[0]
    n_in = torch.randint(0, ps_in + 1, (K, B), generator=gen,
                         dtype=torch.int32)
    is_ec = torch.zeros((K, B), dtype=torch.bool)
    if ec:
        is_ec = torch.rand((K, B), generator=gen) < 0.5
    if name == "ec_and_hash":
        emitting[:, 1] |= flag
        is_ec = torch.arange(B)[None, :].expand(K, B) % 2 == 0
        n_in = torch.where(is_ec, 4, 5).to(torch.int32)
    n_out = 1 + is_ec.to(torch.int32)
    n_in = torch.where(is_ec, 4, n_in)
    emit = torch.where(emitting, n_in | (n_out << 16), 0)
    rows = (_i32(gen, K, ps, 4, B), _i32(gen, K, ps, 8, B),
            _i32(gen, K, ps, B))
    data = fused_cycle.pq_data_rows(emit, ps, ps_in)
    block = tuple(torch.where(data.reshape(K, ps, *[1] * (x.dim() - 3), B),
                              x, GARBAGE) for x in rows) \
        + (emit, torch.where(emitting, n_in + n_out, 0))
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
