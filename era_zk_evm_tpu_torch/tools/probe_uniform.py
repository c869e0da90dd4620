"""The uniform-index probe P6 on the card: the counterpart of
`tools/probe_mosaic_uniform.py`.

`uniform_gather(arena, idx, reps, mode, lane_major)` computes out
int32[8, TB] = reps x arena[k, idx[t], t] mod 2^32 (0 where idx[t] >= W) for
arena int32[8, W, TB] (the tool's batch-last layout; int32[TB, 8, W],
arena[t, k, idx[t]], when `lane_major`) and idx int32[TB], as a sum of
`reps` gathers: on a CUDA tensor with csrc/probe_uniform.cu (mode 0 a
per-lane load, mode 1 the warp-uniform fast path; each gather one weak
load, served by L1 after the first, `split` warps sharing a lane's gathers,
by default `split_for`'s count), on a CPU tensor with
`uniform_gather_plain`.  `word_gather(arena, idx, reps, layout)` prices
K1's own access, a thread reading a whole 256-bit word: the same function
with the arena in one of `WORD_LAYOUTS` ("lane_words" [TB, W, 8], K1's
lane-major arenas, read as 8 x 32-bit loads; "lane_words_v4", the same read
as 2 x 128-bit loads; "words_batch_last" [W, 8, TB]).  `P6_LAUNCHES` counts
launches of both kernels.  Three measurements stand beside P6
(`P6C_LAUNCHES`): `empty_launch(device)`, an empty kernel launched as P6
is, what a launch costs alone; and two that explain P6's earlier design
(strong loads, served by L2) and bound nothing now:
`chain_gather(arena, start, reps)`, one warp's chain of dependent strong
loads, gives one such load's latency; `line_sum(arena, n, blocks, reps)`
sums strong loads with each load to another line than the 15 before it.
`main(argv)` runs both modes on the tool's arena and index (every lane
37), checks that they agree, and prints the time a gather (`--sweep` times
every layout, element and word, at the given TBs):

    python -m era_zk_evm_tpu_torch.tools.probe_uniform [--tb 32768] \
        [--random] [--lane-major]
    python -m era_zk_evm_tpu_torch.tools.probe_uniform --sweep 32768,4096
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys

import torch

P6_LAUNCHES = 0
P6C_LAUNCHES = 0
W, TB, REPS = 256, 256, 512
INDEX = 37          # the tool's index, every lane alike
SPLIT_MAX = 16      # the most warps that share a lane group's gathers
SPLIT_WARPS_PER_SM = 16   # the warps an SM that split_for aims at
#: the word layouts: (kernel layout id, permutation from the canonical
#: arena [8, W, TB])
WORD_LAYOUTS = {"lane_words": (0, (2, 1, 0)), "lane_words_v4": (1, (2, 1, 0)),
                "words_batch_last": (2, (1, 0, 2))}


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


def split_for(warps: int, sms: int) -> int:
    """S, the warps that share one lane group's gathers: the smallest power
    of two up to SPLIT_MAX at which `warps` (the launch's warps at S = 1)
    times S reach a quarter of the card's resident warps (SPLIT_WARPS_PER_SM
    an SM of `sms`)."""
    s = 1
    while s < SPLIT_MAX and warps * s < SPLIT_WARPS_PER_SM * sms:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def card_split(tb: int, device, words: bool = False) -> int:
    """`split_for`'s S for P6 (8 warps a lane group of 32, one a k) or its
    word reads (one) at TB on the card `device`."""
    return split_for((1 if words else 8) * -(-tb // 32),
                     _sms(torch.device(device)))


def _check_split(split: int) -> None:
    if not 0 <= split <= SPLIT_MAX:
        raise ValueError(f"P6: split {split} outside 0 .. {SPLIT_MAX}")


def uniform_gather(arena: torch.Tensor, idx: torch.Tensor, reps: int,
                   mode: int = 0, lane_major: bool = False,
                   split: int = 0) -> torch.Tensor:
    """P6: int32[8, TB] from arena int32[8, W, TB] (int32[TB, 8, W] when
    `lane_major`) and idx int32[TB]; on the card `split` warps share a
    lane's gathers (0: `card_split`'s)."""
    global P6_LAUNCHES
    k_dim, tb = (1, arena.shape[0]) if lane_major else (0, arena.shape[-1])
    if arena.dim() != 3 or arena.shape[k_dim] != 8 \
            or tuple(idx.shape) != (tb,) \
            or arena.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"P6: arena {arena.dtype}{list(arena.shape)}, idx "
                         f"{idx.dtype}{list(idx.shape)}")
    _check_split(split)
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
        tb, reps, mode, int(lane_major),
        split or card_split(tb, arena.device), 0, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"P6 launch failed: cudaError {rc}")
    P6_LAUNCHES += 1
    return out


def empty_launch(device) -> None:
    """An empty kernel on `device`'s current stream, launched as P6 is."""
    global P6C_LAUNCHES
    from .._build import load

    if torch.device(device).type != "cuda":
        raise ValueError(f"no empty kernel for device {device}")
    rc = load().eravm_p6_empty_launch(ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"empty launch failed: cudaError {rc}")
    P6C_LAUNCHES += 1


def chain_gather_plain(arena: torch.Tensor, start: torch.Tensor,
                       reps: int) -> torch.Tensor:
    """The plain version of P6's chain: `reps` times i = arena[i] from
    start (int32 indices into arena)."""
    i = start.to(torch.int64)
    for _ in range(reps):
        i = arena[i].to(torch.int64)
    return i.to(torch.int32)


def line_sum_plain(arena: torch.Tensor, n: int, blocks: int,
                   reps: int) -> torch.Tensor:
    """The plain version of P6's lines: int32[blocks, n], lane t of block b
    the sum mod 2^32 of arena[(16 b + r % 16) * n + t] over r < reps."""
    lines = arena[:16 * blocks * n].reshape(blocks, 16, n).to(torch.int64)
    counts = torch.tensor([len(range(j, reps, 16)) for j in range(16)],
                          dtype=torch.int64, device=arena.device)
    out = (lines * counts[None, :, None]).sum(1) & 0xFFFFFFFF
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def _p6c(arena, start, out, n, reps, blocks):
    global P6C_LAUNCHES
    from .._build import load

    stream = torch.cuda.current_stream(arena.device).cuda_stream
    rc = load().eravm_p6c_launch(
        ctypes.c_void_p(arena.data_ptr()), ctypes.c_void_p(start.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n, reps, blocks,
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"P6 bound launch failed: cudaError {rc}")
    P6C_LAUNCHES += 1
    return out


def _p6c_device(arena: torch.Tensor, what: str) -> bool:
    """True on a CUDA arena, False on a CPU one (the plain version)."""
    if arena.dim() != 1 or arena.dtype != torch.int32:
        raise ValueError(f"P6 {what}: arena {arena.dtype}{list(arena.shape)}")
    if arena.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no P6 {what} kernel for device {arena.device}")
    return arena.device.type == "cuda"


def chain_gather(arena: torch.Tensor, start: torch.Tensor,
                 reps: int) -> torch.Tensor:
    """P6's chain: int32[n] (n <= 1024, one block), `reps` dependent volatile
    loads a lane (csrc/probe_uniform.cu, p6c_kernel): with arena[i] = i,
    each lane's loads read its own L2-resident word, each address waiting
    on the load before it.  Every index must lie in the arena."""
    n = start.shape[0] if start.dim() == 1 else 0
    if not 1 <= n <= 1024 or start.dtype != torch.int32:
        raise ValueError(f"P6 chain: start {start.dtype}{list(start.shape)}")
    if not _p6c_device(arena, "chain"):
        return chain_gather_plain(arena, start, reps)
    arena, start = arena.contiguous(), start.contiguous()
    return _p6c(arena, start, torch.empty_like(start), n, reps, 0)


def line_sum(arena: torch.Tensor, n: int, blocks: int,
             reps: int) -> torch.Tensor:
    """P6's lines: `line_sum_plain`'s function (csrc/probe_uniform.cu,
    p6r_kernel: `blocks` blocks of n <= 1024 lanes, each lane's `reps`
    volatile loads independent and cycling over 16 lines)."""
    if not 1 <= n <= 1024 or blocks < 1 or arena.numel() < 16 * blocks * n:
        raise ValueError(f"P6 lines: n={n}, blocks={blocks}, arena "
                         f"{list(arena.shape)}")
    if not _p6c_device(arena, "lines"):
        return line_sum_plain(arena, n, blocks, reps)
    arena = arena.contiguous()
    out = torch.empty((blocks, n), dtype=torch.int32, device=arena.device)
    return _p6c(arena, arena, out, n, reps, blocks)


def _canonical(arena: torch.Tensor, layout: str) -> torch.Tensor:
    """The [8, W, TB] view of a word-layout arena."""
    perm = WORD_LAYOUTS[layout][1]
    return arena.permute(*[perm.index(d) for d in range(3)])


def word_gather_plain(arena: torch.Tensor, idx: torch.Tensor, reps: int,
                      layout: str) -> torch.Tensor:
    """The plain version of P6's word reads."""
    return uniform_gather_plain(_canonical(arena, layout), idx, reps)


def word_gather(arena: torch.Tensor, idx: torch.Tensor, reps: int,
                layout: str, split: int = 0) -> torch.Tensor:
    """P6's word reads: int32[8, TB], limb l of word (t, idx[t]) times
    reps, from a word arena in `layout` (see WORD_LAYOUTS); `split` as
    `uniform_gather`'s."""
    global P6_LAUNCHES
    if layout not in WORD_LAYOUTS or arena.dim() != 3 \
            or _canonical(arena, layout).shape[0] != 8 \
            or tuple(idx.shape) != (_canonical(arena, layout).shape[2],) \
            or arena.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"P6 words ({layout}): arena {arena.dtype}"
                         f"{list(arena.shape)}, idx {idx.dtype}"
                         f"{list(idx.shape)}")
    _check_split(split)
    if arena.device.type == "cpu":
        return word_gather_plain(arena, idx, reps, layout)
    if arena.device.type != "cuda":
        raise ValueError(f"no P6 kernel for device {arena.device}")
    from .._build import load

    arena, idx = arena.contiguous(), idx.contiguous()
    _, w, tb = _canonical(arena, layout).shape
    out = torch.empty((8, tb), dtype=torch.int32, device=arena.device)
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    rc = load().eravm_p6w_launch(
        ctypes.c_void_p(arena.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), w, tb, reps, WORD_LAYOUTS[layout][0],
        split or card_split(tb, arena.device, words=True), 0,
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"P6 word launch failed: cudaError {rc}")
    P6_LAUNCHES += 1
    return out


def tool_inputs(w: int, tb: int, device, random_index: bool = False,
                lane_major: bool = False, word_layout: str | None = None):
    """The tool's arena (0, 1, 2, ... over [8, W, TB]; laid out [TB, 8, W]
    when `lane_major`, or in a word layout, the same function) and index
    (INDEX in every lane, or uniform random in [0, W))."""
    arena = torch.arange(8 * w * tb, dtype=torch.int32,
                         device=device).reshape(8, w, tb)
    if lane_major:
        arena = arena.permute(2, 0, 1).contiguous()
    elif word_layout is not None:
        arena = arena.permute(*WORD_LAYOUTS[word_layout][1]).contiguous()
    if random_index:
        gen = torch.Generator().manual_seed(0)
        idx = torch.randint(0, w, (tb,), generator=gen, dtype=torch.int32)
    else:
        idx = torch.full((tb,), INDEX, dtype=torch.int32)
    return arena, idx.to(device)


def sweep(tbs, device, w: int = W, reps: int = REPS) -> dict:
    """Microseconds a gather (the best of three calls over `reps`) of every
    layout (the tool's batch-last and the lane-major element arenas, mode
    0; the three word layouts) at each TB, with the tool's index and a
    random one, each checked against its plain version on the same
    inputs."""
    from .probe_keccak import best_seconds

    out = {}
    for tb in tbs:
        for random_index in (False, True):
            kind = "random" if random_index else "uniform"
            for layout in ("batch_last", "lane_major") + tuple(WORD_LAYOUTS):
                words = layout in WORD_LAYOUTS
                arena, idx = tool_inputs(
                    w, tb, device, random_index, layout == "lane_major",
                    layout if words else None)
                box = {}
                if words:
                    fn = lambda: box.__setitem__(  # noqa: E731
                        "k", word_gather(arena, idx, reps, layout))
                    want = word_gather_plain(arena, idx, reps, layout)
                else:
                    fn = lambda: box.__setitem__(  # noqa: E731
                        "k", uniform_gather(arena, idx, reps, 0,
                                            layout == "lane_major"))
                    want = uniform_gather_plain(arena, idx, reps,
                                                layout == "lane_major")
                sec = best_seconds(fn, device, reps=3) / reps
                if not torch.equal(box["k"], want):
                    raise AssertionError(f"P6 {layout} {kind} TB={tb}")
                out[f"tb{tb}_{layout}_{kind}_us"] = sec * 1e6
                del arena, idx
    return out


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
                    help="the arena laid out [TB, 8, W]")
    ap.add_argument("--sweep", metavar="TB,TB,...",
                    help="time every layout at these TBs (one JSON line)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --cpu to run the plain version")
    if args.sweep:
        out = sweep([int(t) for t in args.sweep.split(",")], device, args.w,
                    args.reps)
        print(json.dumps(out))
        return out
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
