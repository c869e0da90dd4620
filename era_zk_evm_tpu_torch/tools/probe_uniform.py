"""The uniform-index probe P6 on the card: the counterpart of
`tools/probe_mosaic_uniform.py`.

`uniform_gather(arena, idx, reps, mode, lane_major)` computes out
int32[8, TB] = reps x arena[k, idx[t], t] mod 2^32 (0 where idx[t] >= W) for
arena int32[8, W, TB] (the tool's batch-last layout; int32[TB, 8, W],
arena[t, k, idx[t]], when `lane_major`) and idx int32[TB], as a sum of
`reps` gathers: on a CUDA tensor with csrc/probe_uniform.cu (mode 0 a
per-lane load, mode 1 the warp-uniform fast path), on a CPU tensor with
`uniform_gather_plain`.  `P6_LAUNCHES` counts launches.  `main(argv)` runs
both modes on the tool's arena and index (every lane 37), checks that they
agree, and prints the time a gather:

    python -m era_zk_evm_tpu_torch.tools.probe_uniform [--tb 32768] \
        [--random] [--lane-major]
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

P6_LAUNCHES = 0
W, TB, REPS = 256, 256, 512
INDEX = 37          # the tool's index, every lane alike


def uniform_gather_plain(arena: torch.Tensor, idx: torch.Tensor,
                         reps: int, lane_major: bool = False) -> torch.Tensor:
    """The plain version of P6."""
    if lane_major:
        arena = arena.permute(1, 2, 0)
    w = arena.shape[1]
    i = idx.to(torch.int64) & 0xFFFFFFFF
    inside = i < w
    cols = torch.arange(arena.shape[2], device=arena.device)
    vals = arena[:, i.clamp(max=w - 1), cols].to(torch.int64) & 0xFFFFFFFF
    out = torch.where(inside, vals * reps, 0) & 0xFFFFFFFF
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def uniform_gather(arena: torch.Tensor, idx: torch.Tensor, reps: int,
                   mode: int = 0, lane_major: bool = False) -> torch.Tensor:
    """P6: int32[8, TB] from arena int32[8, W, TB] (int32[TB, 8, W] when
    `lane_major`) and idx int32[TB]."""
    global P6_LAUNCHES
    k_dim, tb = (1, arena.shape[0]) if lane_major else (0, arena.shape[-1])
    if arena.dim() != 3 or arena.shape[k_dim] != 8 \
            or tuple(idx.shape) != (tb,) \
            or arena.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"P6: arena {arena.dtype}{list(arena.shape)}, idx "
                         f"{idx.dtype}{list(idx.shape)}")
    if arena.device.type == "cpu":
        return uniform_gather_plain(arena, idx, reps, lane_major)
    if arena.device.type != "cuda":
        raise ValueError(f"no P6 kernel for device {arena.device}")
    from .._build import load

    arena, idx = arena.contiguous(), idx.contiguous()
    out = torch.empty((8, tb), dtype=torch.int32, device=arena.device)
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    rc = load().eravm_p6_launch(
        ctypes.c_void_p(arena.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), arena.shape[-1 if lane_major else 1],
        tb, reps, mode, int(lane_major), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"P6 launch failed: cudaError {rc}")
    P6_LAUNCHES += 1
    return out


def tool_inputs(w: int, tb: int, device, random_index: bool = False,
                lane_major: bool = False):
    """The tool's arena (0, 1, 2, ... over [8, W, TB]; laid out [TB, 8, W]
    when `lane_major`, the same function) and index (INDEX in every lane,
    or uniform random in [0, W))."""
    arena = torch.arange(8 * w * tb, dtype=torch.int32,
                         device=device).reshape(8, w, tb)
    if lane_major:
        arena = arena.permute(2, 0, 1).contiguous()
    if random_index:
        gen = torch.Generator().manual_seed(0)
        idx = torch.randint(0, w, (tb,), generator=gen, dtype=torch.int32)
    else:
        idx = torch.full((tb,), INDEX, dtype=torch.int32)
    return arena, idx.to(device)


def main(argv=None) -> dict:
    """Both modes on the tool's inputs; return {mode: seconds a gather}."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.probe_uniform",
        description="uniform-index gather probe (P6) on the card")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--w", type=int, default=W)
    ap.add_argument("--tb", type=int, default=TB)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--random", action="store_true",
                    help="a random index a lane in place of the tool's 37")
    ap.add_argument("--lane-major", action="store_true",
                    help="the arena laid out [TB, 8, W], as K1's arenas")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --cpu to run the plain version")
    if not args.random and args.w <= INDEX:
        raise SystemExit(f"--w must exceed the tool's index {INDEX}")
    arena, idx = tool_inputs(args.w, args.tb, device, args.random,
                             args.lane_major)
    from .probe_keccak import best_seconds

    outs, secs = {}, {}
    for mode in (0, 1):
        secs[mode] = best_seconds(
            lambda: outs.__setitem__(mode, uniform_gather(
                arena, idx, args.reps, mode, args.lane_major)), device,
            reps=1) / args.reps
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("uniform fast path result mismatch")
    print(f"PROBE OK — per-lane load {secs[0] * 1e6:.3f} us/gather, "
          f"warp-uniform path {secs[1] * 1e6:.3f} us/gather")
    return secs


if __name__ == "__main__":
    main(sys.argv[1:])
