"""The fold's pieces on the card: the counterpart of
`tools/probe_fold_split.py`.

The JAX tool times its v4 / v5 fold's XLA prep, the relayout of meta and
value, its mask kernel, its main kernel and the bit-plane conversions of
the sponge apart, on meta and value drawn from `RandomState(0)` and the
112 active slots of `probe_foldparts` (flags 5, every lane).  The port's
fold is one kernel, K2 (`fused_cycle.rolling_fold`), on each lane's records
compacted (`witness/rolling.compact_slot_rows`, untimed), from zero sponges
(`k1_times.fold_row`: the best of 3 CUDA-event times, held to
`rolling_absorb_rows` on the card).  Labels, as the JAX tool's:

  main (default)
    prep(masks+flags)      none: K2 reads each lane's record count and
                           takes the parity from wc_count & 1;
    meta/val reshape+copy  a copy of meta and value (`clone`, a torch op:
                           the JAX line is XLA, not Pallas) beside the
                           bound of its bytes, read and written;
    full fold              K2 on the 112 active slots;
    fold all-invalid       K2 with every count 0;
  pieces
    mask kernel (112 act), mask kernel (0 act)
                           none: K2 has no mask kernel;
    main kernel (0 act), main kernel (112 act)
                           K2 on counts 0 and 112;
    state->planes, planes->state
                           `probe_keccak.states_to_planes` /
                           `planes_to_states` on the sponges [B, 25, 2];
    full fold              K2 on the 112 active slots.

    python -m era_zk_evm_tpu_torch.tools.probe_fold_split [pieces] [--cpu] \
        [--batch B] [--kq KQ]

It runs on the card unless `--cpu` is given (the plain versions: pass a
small `--batch`, a multiple of 256).  It prints the card's name and power
limit first and every row as one JSON line last; `main(argv)` returns the
rows.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..witness.rolling import compact_slot_rows
from .k1_times import (
    HBM_BYTES_PER_MS, best_ms, card, device_for, fold_line, fold_row, report,
)
from .probe_foldparts import B, KQ, active_slots, draw, variant_flags
from .probe_keccak import planes_to_states, states_to_planes

NO_PREP = ("no counterpart: K2 reads each lane's record count and takes the "
           "parity from wc_count & 1; no masks or flags are packed")
NO_MASK = ("no counterpart: K2 has no mask kernel; the parity is "
           "wc_count & 1, read a lane")


def timed_row(fn, device, n_bytes: int) -> dict:
    """A torch op's best of 3 CUDA-event times beside its bytes' bound."""
    return {"ms": best_ms(fn, device=device), "bytes": n_bytes,
            "bound_ms": n_bytes / HBM_BYTES_PER_MS, "bound_by": "bytes"}


def main(argv=None) -> dict:
    """The JAX tool's `main` lines, or its `pieces` lines with `pieces`;
    return {label: row}."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.probe_fold_split",
        description="the fold's pieces (K2) on the card")
    ap.add_argument("group", nargs="?", choices=("pieces",))
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
    flags = variant_flags(active_slots(rng, args.kq), args.batch)
    blocks = {n: compact_slot_rows(meta, val,
                                   torch.from_numpy(flags[v]).to(device))
              for n, v in (("112", "half"), ("0", "none"))}
    rows = {}

    def fold(label, key):
        rows[label], sponges = fold_row(blocks[key])
        print(fold_line(label, rows[label]), flush=True)
        return sponges

    def absent(label, reason):
        rows[label] = {"ms": None, "reason": reason}
        print(f"{label}: none ({reason})", flush=True)

    def timed(label, fn, n_bytes):
        rows[label] = timed_row(fn, device, n_bytes)
        print(f"{label}: {rows[label]['ms']:.4f}ms (bound "
              f"{rows[label]['bound_ms']:.4f} ms, {n_bytes} bytes)",
              flush=True)

    if args.group != "pieces":
        absent("prep(masks+flags)", NO_PREP)
        timed("meta/val reshape+copy", lambda: (meta.clone(), val.clone()),
              2 * (meta.nbytes + val.nbytes))
        fold("full fold", "112")
        fold("fold all-invalid", "0")
    else:
        for act in ("112", "0"):
            absent(f"mask kernel ({act} act)", NO_MASK)
        fold("main kernel (0 act)", "0")
        wc = fold("main kernel (112 act)", "112")[0]
        box = {}
        timed("state->planes",
              lambda: box.__setitem__("p", states_to_planes(wc)),
              2 * wc.nbytes)
        timed("planes->state",
              lambda: box.__setitem__("s", planes_to_states(box["p"])),
              2 * wc.nbytes)
        if not torch.equal(box["s"], wc):
            raise AssertionError("planes_to_states(states_to_planes(s)) != s")
        fold("full fold", "112")
    del blocks, meta, val
    torch.cuda.empty_cache()
    return report("probe_fold_split", device, card_line, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
