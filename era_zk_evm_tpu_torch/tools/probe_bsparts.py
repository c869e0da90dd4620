"""K2 on the bench's slot validity: the counterpart of
`tools/probe_bsparts.py`.

The JAX tool splits its bit-sliced fold into the XLA prep (record words to
bit planes, wrap masks) and the whole fold, on meta and value drawn from
`RandomState(0)` and a batch-uniform validity (each slot valid with p =
0.11, about one record a cycle).  The port's fold, K2
(`fused_cycle.rolling_fold`), absorbs each lane's records compacted as
words, with no prep: `full fold` is K2 on the same block compacted
(`witness/rolling.compact_slot_rows`, untimed; `k1_times.fold_row`:
the best of 3 CUDA-event times from zero sponges, held to
`rolling_absorb_rows` on the card) beside its bound; `xla prep` has no
counterpart and prints none.

    python -m era_zk_evm_tpu_torch.tools.probe_bsparts [batch] [n_cycles] \
        [--cpu]

It runs on the card unless `--cpu` is given (the plain versions: pass a
small batch).  It prints the card's name and power limit first and every
row as one JSON line last; `main(argv)` returns the rows.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..witness.rolling import compact_slot_rows
from .probe_foldparts import draw
from .k1_times import card, device_for, fold_line, fold_row, report

B = 32768
K = 128
#: the chance that a slot is valid: about one valid slot a cycle
P_VALID = 0.11
NO_PREP = ("no counterpart: K2 absorbs each lane's compacted records as "
           "words, with no transposes or masks before it")


def main(argv=None) -> dict:
    """K2 on the bench-like block; return {label: row}."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.probe_bsparts",
        description="K2 on bench-like slot validity on the card")
    ap.add_argument("args", nargs="*", type=int, help="[batch] [n_cycles]")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    batch = args.args[0] if args.args else B
    kq = (args.args[1] if len(args.args) > 1 else K) * 8
    device = device_for(args.cpu)
    card_line = card(device)
    print(f"card: {card_line}", flush=True)
    rng, meta, val = draw(batch, kq)
    slot_valid = rng.rand(kq) < P_VALID
    flg = (slot_valid[:, None] * np.full((kq, batch), 5)).astype(np.int32)
    block = compact_slot_rows(*(torch.from_numpy(x).to(device)
                                for x in (meta, val, flg)))
    del meta, val, flg
    rows = {}
    rows["full fold"], _ = fold_row(block)
    rows["full fold"]["active_slots"] = int(slot_valid.sum())
    print(fold_line("full fold", rows["full fold"]), flush=True)
    rows["xla prep"] = {"ms": None, "reason": NO_PREP}
    print(f"xla prep: none ({NO_PREP})", flush=True)
    return report("probe_bsparts", device, card_line, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
