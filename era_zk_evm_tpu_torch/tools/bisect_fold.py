"""The gated-fold probe P7 on the card: the counterpart of
`tools/bisect_fold.py`.

`fold(flags, st, variant)` runs KQ slots of the gated keccak fold on st
int32[51, B] (words 0-24 the low and 25-49 the high halves of a keccak
state, word 50 a count) under flags int32[KQ, B]: on a CUDA tensor with
csrc/bisect_fold.cu, on a CPU tensor with `fold_plain`.  With valid =
flg & 4, rec = flg & 3 (XORed into u64 lanes 0-7, "even", or 8-15, "odd")
and wrap = valid and the count odd, a slot does, by variant:

  old    valid: st = f(st ^ even)
  wrapb  wrap:  st = f(st ^ even)
  sel    wrap:  st = f(st ^ odd)
  two    valid: st ^= (wrap ? odd : even); then wrap: st = f(st)   (= new)

and every variant adds valid to the count.  `P7_LAUNCHES` counts launches.
`main(argv)` runs the variants on the tool's inputs (every flag 5, the
state zero) and prints each one's time:

    python -m era_zk_evm_tpu_torch.tools.bisect_fold [old wrapb sel two]
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

from ..ops.keccak import keccak_f1600_lanes
from .k1_times import device_for

P7_LAUNCHES = 0
KQ = 16
B = 32768
VARIANTS = {"old": 0, "wrapb": 1, "sel": 2, "two": 3, "new": 3}


def fold_plain(flags: torch.Tensor, st: torch.Tensor,
               variant: str) -> torch.Tensor:
    """The plain version of P7."""
    v = VARIANTS[variant]
    lanes = (st[:25].to(torch.int64) & 0xFFFFFFFF) \
        | (st[25:50].to(torch.int64) << 32)
    count = st[50].clone()
    for flg in flags:
        valid = (flg & 4) != 0
        rec = (flg & 3).to(torch.int64) * 0x100000001
        wrap = ((flg >> 2) & count & 1) != 0
        odd = wrap if v == 3 else torch.full_like(valid, v == 2)
        absorb = valid if v in (0, 3) else wrap
        permute = valid if v == 0 else wrap
        lanes = lanes.clone()
        lanes[:8] ^= torch.where(absorb & ~odd, rec, 0)
        lanes[8:16] ^= torch.where(absorb & odd, rec, 0)
        lanes = torch.where(permute, keccak_f1600_lanes(lanes), lanes)
        count = count + valid.to(torch.int32)
    lo = lanes & 0xFFFFFFFF
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)
    hi = (lanes >> 32).to(torch.int32)
    return torch.cat([lo, hi, count[None]])


def fold(flags: torch.Tensor, st: torch.Tensor, variant: str) -> torch.Tensor:
    """P7: st after the KQ slots of `flags`; a new tensor."""
    global P7_LAUNCHES
    if flags.dim() != 2 or st.dim() != 2 or st.shape[0] != 51 \
            or flags.shape[1] != st.shape[1] or flags.dtype != torch.int32 \
            or st.dtype != torch.int32 or variant not in VARIANTS:
        raise ValueError(f"P7: flags {flags.dtype}{list(flags.shape)}, st "
                         f"{st.dtype}{list(st.shape)}, variant {variant!r}")
    if st.device.type == "cpu":
        return fold_plain(flags, st, variant)
    if st.device.type != "cuda":
        raise ValueError(f"no P7 kernel for device {st.device}")
    from .._build import load

    flags, out = flags.contiguous(), st.contiguous().clone()
    stream = torch.cuda.current_stream(st.device).cuda_stream
    rc = load().eravm_p7_launch(
        ctypes.c_void_p(flags.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        out.shape[1], flags.shape[0], VARIANTS[variant],
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"P7 launch failed: cudaError {rc}")
    P7_LAUNCHES += 1
    return out


def tool_inputs(batch: int, device):
    """The tool's inputs: every flag 5 (valid, record 1), the state zero."""
    return (torch.full((KQ, batch), 5, dtype=torch.int32, device=device),
            torch.zeros((51, batch), dtype=torch.int32, device=device))


def main(argv=None) -> dict:
    """The named variants on the tool's inputs; return {variant: seconds}."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.bisect_fold",
        description="gated keccak fold variants (P7) on the card")
    ap.add_argument("variants", nargs="*", help="old wrapb sel two new")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=B)
    args = ap.parse_args(argv)
    device = device_for(args.cpu)
    flags, st = tool_inputs(args.batch, device)
    from .probe_keccak import best_seconds

    secs = {}
    for v in args.variants or ["old", "wrapb", "sel", "two"]:
        secs[v] = best_seconds(lambda: fold(flags, st, v), device, reps=1)
        print(f"{v}: OK ({secs[v] * 1e3:.3f} ms)", flush=True)
    return secs


if __name__ == "__main__":
    main(sys.argv[1:])
