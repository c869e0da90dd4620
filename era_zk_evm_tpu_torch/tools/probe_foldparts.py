"""K2's fixed cost on the card, apart from its permutations: the counterpart
of `tools/probe_foldparts.py`.

The JAX tool doctors the slot flags of one chunk (KQ = 1024 slots, B =
32768 lanes, meta and value drawn from `RandomState(0)`) to split its
bit-sliced fold into its floor, its absorbs and its permutations.  The
port's fold, K2 (`fused_cycle.rolling_fold`), reads each lane's records
compacted, so each variant's slot block is compacted first
(`witness/rolling.compact_slot_rows`, untimed) and K2 timed on it from zero
sponges (`k1_times.fold_row`: the best of 3 CUDA-event times, each on
a fresh copy, held to `rolling_absorb_rows` on the card):

  none    every slot invalid: no record, no permutation, K2's floor (the
          launch, the counts and the sponges read and written);
  half    112 active slots (the JAX tool's draw), flags 5, every lane: 112
          records and 56 keccak-f a lane, the bench's shape;
  noperm  one record a lane, at active slot l % 112 for lane l: 1 record
          and 0 keccak-f a lane, K2's cost with records but no
          permutation.  After compaction each lane's one record is row 0,
          one uniform row a lane; on the TPU its records were scattered
          over the 112 slots.

Each line gives K2's ms, the records and permutations and the bound of
that work (`k1_times.k2_bound`).

    python -m era_zk_evm_tpu_torch.tools.probe_foldparts [--cpu] \
        [--batch B] [--kq KQ]

It runs on the card unless `--cpu` is given (the plain versions: pass a
small `--batch`).  It prints the card's name and power limit first and
every row as one JSON line last; `main(argv)` returns the rows.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..witness.rolling import compact_slot_rows
from .k1_times import card, device_for, fold_line, fold_row, report

B = 32768
K = 128
KQ = K * 8
SEED = 0
#: the bench's active slots a chunk
SLOTS = 112
VARIANTS = ("none", "half", "noperm")


def draw(batch: int, kq: int) -> tuple:
    """The JAX tool's meta and value, from RandomState(SEED), and the
    generator after them (its next draws are the slot patterns).  Drawn as
    int32: the same values as the JAX tool's int64 draw cast to uint32
    (every value < 2^31) from the same stream, in a third of the time."""
    rng = np.random.RandomState(SEED)
    meta = rng.randint(0, 1 << 31, size=(kq, 4, batch), dtype=np.int32)
    val = rng.randint(0, 1 << 31, size=(kq, 8, batch), dtype=np.int32)
    return rng, meta, val


def active_slots(rng, kq: int) -> np.ndarray:
    """The JAX tool's 112 active slots, bool [kq]."""
    slot_valid = np.zeros(kq, bool)
    slot_valid[rng.choice(kq, SLOTS, replace=False)] = True
    return slot_valid


def variant_flags(slot_valid: np.ndarray, batch: int) -> dict:
    """The JAX tool's flag blocks, int32 [kq, batch] a variant."""
    kq = slot_valid.shape[0]
    flags = {"none": np.zeros((kq, batch), np.int32),
             "half": (slot_valid[:, None] * np.full((kq, batch), 5))
             .astype(np.int32)}
    one = np.zeros((kq, batch), np.int32)
    act = np.nonzero(slot_valid)[0]
    one[act[np.arange(batch) % len(act)], np.arange(batch)] = 5
    flags["noperm"] = one
    return flags


def main(argv=None) -> dict:
    """Time K2 on each variant; return {variant: row}."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.probe_foldparts",
        description="K2's floor, absorbs and permutations on the card")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--kq", type=int, default=KQ)
    args = ap.parse_args(argv)
    device = device_for(args.cpu)
    card_line = card(device)
    print(f"card: {card_line}", flush=True)
    rng, meta_np, val_np = draw(args.batch, args.kq)
    meta = torch.from_numpy(meta_np).to(device)
    val = torch.from_numpy(val_np).to(device)
    del meta_np, val_np
    rows = {}
    for name, flg in variant_flags(active_slots(rng, args.kq),
                                   args.batch).items():
        block = compact_slot_rows(meta, val, torch.from_numpy(flg).to(device))
        rows[name], _ = fold_row(block)
        print(fold_line(name, rows[name]), flush=True)
        del block
        torch.cuda.empty_cache()
    return report("probe_foldparts", device, card_line, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
