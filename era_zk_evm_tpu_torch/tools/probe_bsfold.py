"""The bit-sliced fold's two costs on the card: the counterpart of
`tools/probe_bsfold.py`.

  perm  P2 (`probe_keccak.keccak_bitslice`, csrc/probe_keccak.cu) on bit
        planes of ones int32[1600, 8, G8], G8 = B / 256 (32 states a u32),
        256 permutations a launch: µs a batch permutation and lane
        permutations a second, the best of 3 CUDA-event times after a warm
        call, beside P2's operation bound (`k1_times.BITSLICE_ROUND_OPS` a
        round of 32 states);
  tr    `rec_words_to_planes`, the transpose of a chunk's record words
        int32[KQ, 12, B] into bit planes int32[KQ, 384, 8, B / 256] (XLA in
        the JAX package, torch ops here, on `probe_keccak._bit_transpose_32`),
        on ones, beside the bound of its bytes, read and written.  A
        bit-sliced fold, or a bit-sliced K3, would pay it; K2 absorbs
        records as words and pays none.

    python -m era_zk_evm_tpu_torch.tools.probe_bsfold [batch] [kq] [--cpu] \
        [--iters 256]

It runs on the card unless `--cpu` is given (the plain versions: pass a
small batch, a multiple of 256).  It prints the card's name and power limit
first and every row as one JSON line last; `main(argv)` returns the rows.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .k1_times import (
    BITSLICE_ROUND_OPS, HBM_BYTES_PER_MS, INT32_OPS_PER_MS, best_ms, card,
    device_for, report,
)
from .probe_keccak import _bit_transpose_32, keccak_bitslice

BATCH, KQ, ITERS = 32768, 1024, 256
#: 32-bit words of a record: meta 4, value 8
WORDS = 12


def rec_words_to_planes(rec: torch.Tensor) -> torch.Tensor:
    """int32[KQ, W, B] record words -> bit planes int32[KQ, W * 32, 8,
    B // 256]: plane (w, z) holds bit z of word w for 32 consecutive lanes
    a u32 (`states_to_planes`' lane grouping); a copy of
    tools/probe_bsfold.py::rec_words_to_planes."""
    kq, w, b = rec.shape
    p = _bit_transpose_32(rec.reshape(kq, w, b // 32, 32))
    return p.permute(0, 1, 3, 2).reshape(kq, w * 32, 8, b // 256)


def probe_perm(batch: int, device, iters: int = ITERS) -> dict:
    g8 = batch // 256
    planes = torch.ones((1600, 8, g8), dtype=torch.int32, device=device)
    ms = best_ms(lambda: keccak_bitslice(planes, iters), device=device)
    ops = iters * 24 * BITSLICE_ROUND_OPS * 8 * g8
    return {"ms": ms, "g8": g8, "iters": iters,
            "bound_ms": ops / INT32_OPS_PER_MS, "bound_by": "operations",
            "us_per_batch_perm": ms * 1e3 / iters,
            "lane_perms_per_sec": batch * iters / (ms / 1e3)}


def probe_tr(batch: int, kq: int, device) -> dict:
    rec = torch.ones((kq, WORDS, batch), dtype=torch.int32, device=device)
    ms = best_ms(lambda: rec_words_to_planes(rec), device=device)
    n_bytes = 2 * rec.nbytes
    return {"ms": ms, "kq": kq, "bytes": n_bytes,
            "bound_ms": n_bytes / HBM_BYTES_PER_MS, "bound_by": "bytes"}


def main(argv=None) -> dict:
    """Time perm and tr; return {"perm": row, "transpose": row}."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.probe_bsfold",
        description="the bit-sliced permutation (P2) and the record "
                    "transpose on the card")
    ap.add_argument("args", nargs="*", type=int, help="[batch] [kq]")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="permutations a P2 launch")
    args = ap.parse_args(argv)
    batch = args.args[0] if args.args else BATCH
    kq = args.args[1] if len(args.args) > 1 else KQ
    device = device_for(args.cpu)
    card_line = card(device)
    print(f"card: {card_line}", flush=True)
    rows = {"perm": probe_perm(batch, device, args.iters)}
    p = rows["perm"]
    print(f"perm G8={p['g8']}: {p['us_per_batch_perm']:.1f}us/batch-perm "
          f"({p['lane_perms_per_sec'] / 1e6:.1f}M lane-perms/s; P2, "
          f"{p['ms']:.3f} ms a launch, bound {p['bound_ms']:.3f} ms)",
          flush=True)
    torch.cuda.empty_cache()
    t = rows["transpose"] = probe_tr(batch, kq, device)
    print(f"transpose KQ={kq} B={batch} ({t['bytes'] / 2 / 2**20:.0f}MB): "
          f"{t['ms']:.3f}ms (bound {t['bound_ms']:.3f} ms, bytes)", flush=True)
    torch.cuda.empty_cache()
    return report("probe_bsfold", device, card_line, rows)


if __name__ == "__main__":
    main(sys.argv[1:])
