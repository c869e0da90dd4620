"""Keccak-f[1600] formulation probes on the card: the counterpart of
`tools/probe_keccak.py` (its Pallas kernels P1-P5).

Each probe has a wrapper, which launches its CUDA kernel on a CUDA tensor and
runs its plain torch version on a CPU tensor, and a launch count:

  P1 `keccak_rows2d`   `iters` chained keccak-f of int32[B, 25, 2] states
                       through a batch-last copy, `tile` threads a block,
                       `unroll` permutations a loop trip
                       (csrc/probe_keccak.cu; plain: K3's plain version);
  P2 `keccak_bitslice` `iters` keccak-f of bit planes int32[1600, 8, G8], 32
                       states per u32, plane 64 (x + 5y) + z, the order of
                       `states_to_planes` (csrc/probe_keccak.cu; plain:
                       `keccak_bitslice_plain`);
  P5 `keccak_bitslice_fused`  P2 with theta applied in the chi reads (the
                       same function);
  P3 `alu_chain`       `iters` x (inner / rows) steps of one op over int32
                       [rows, ...] (csrc/probe_rate.cu; plain:
                       `alu_chain_plain`), and `probe_vpu_rate`, its rate;
  P4 `round_chain`     `iters` single keccak rounds with one fixed round
                       constant over int32[N, 25, 2] (csrc/probe_rate.cu;
                       plain: `round_chain_plain`), and `probe_round_rate`.

`main(argv)` takes the JAX tool's variant names (`base`, K3's kernel;
`rows2d`, `rows2d_tT_uU`, `roundrate_tT`, `vpu_OP[_r1][_tT]`, `bitslice_gG`)
and `bitslice_fused_gG`, and prints a rate for each:

    python -m era_zk_evm_tpu_torch.tools.probe_keccak vpu_xor bitslice_g128

It runs on the card unless `--cpu` is given (then pass small `--batch` and
`--iters`: the plain versions are slow at the tool's shapes).
"""

from __future__ import annotations

import argparse
import ctypes
import math
import sys
import time

import torch

from ..ops import keccak
from ..ops.keccak import KECCAK_RC, KECCAK_ROTATIONS, keccak_f1600_plain

P1_LAUNCHES = 0
P2_LAUNCHES = 0
P3_LAUNCHES = 0
P4_LAUNCHES = 0
P5_LAUNCHES = 0

#: u32 operations a row-step in the JAX probe's units (rotl1 = shl, shr, or)
OPS_PER_STEP = {"xor": 1, "mix": 3, "andnot": 3}
_P3_OPS = {"xor": 0, "mix": 1, "andnot": 2}
#: the round-rate probe's fixed round constant: low u32 0x12345678, high
#: u32 0x9ABCDEF0
ROUND_RC = 0x9ABCDEF012345678


def _lib():
    from .._build import load

    return load()


def _args(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _require_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")


# ---- P1 -------------------------------------------------------------------

def keccak_rows2d(state: torch.Tensor, iters: int, tile: int = 2048,
                  unroll: int = 1) -> torch.Tensor:
    """P1: `iters` chained keccak-f of int32[B, 25, 2]; a new tensor.

    B % tile == 0, tile % 8 == 0 and iters % unroll == 0, as the JAX tool
    asks; on the card a block holds min(tile, 1024) threads (1024 is the
    card's limit) and unroll is 1, 2 or 4."""
    global P1_LAUNCHES
    keccak._check(state, iters)
    B = state.shape[0]
    if B % tile or tile % 8 or iters % unroll or unroll not in (1, 2, 4):
        raise ValueError(f"P1: B={B}, tile={tile}, iters={iters}, "
                         f"unroll={unroll}")
    if state.device.type == "cpu":
        return keccak_f1600_plain(state, iters)
    _require_card(state, "P1")
    rows = state.reshape(B, 50).T.contiguous()        # u32 word w at [w, b]
    _launched(_lib().eravm_p1_launch(_args(rows), B, iters, min(tile, 1024),
                                     unroll, _stream(rows)), "P1")
    P1_LAUNCHES += 1
    return rows.T.reshape(B, 25, 2).contiguous()


# ---- bit planes (P2, P5) ------------------------------------------------------

_BT_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


def _bit_transpose_32(x: torch.Tensor) -> torch.Tensor:
    """Transpose 32x32 bit matrices of int32[..., 32]: out[..., i] bit j is
    in[..., j] bit i (era_zk_evm_tpu/ops/keccak.py::_bit_transpose_32; the
    masks clear the bits an arithmetic shift would fill)."""
    for stage, m in enumerate(_BT_MASKS):
        w = 1 << stage
        xs = x.reshape(x.shape[:-1] + (32 // (2 * w), 2, w))
        a, b = xs[..., 0, :], xs[..., 1, :]
        t = ((a >> w) ^ b) & m
        a, b = a ^ (t << w), b ^ t
        x = torch.stack([a, b], dim=-2).reshape(x.shape)
    return x


def states_to_planes(state: torch.Tensor) -> torch.Tensor:
    """int32[B, 25, 2] states -> bit planes int32[1600, 8, B // 256], a copy
    of era_zk_evm_tpu/ops/keccak.py::states_to_planes (B % 256 == 0)."""
    B = state.shape[0]
    if B % 256:
        raise ValueError(f"states_to_planes: B={B} is no multiple of 256")
    w = state.reshape(B // 32, 32, 50).transpose(1, 2)    # [G, word, s]
    p = _bit_transpose_32(w.contiguous()).reshape(B // 32, 1600)
    return p.T.reshape(1600, 8, B // 256).contiguous()


def planes_to_states(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of states_to_planes: int32[1600, 8, G8] ->
    int32[32 * 8 * G8, 25, 2]."""
    G = planes.shape[1] * planes.shape[2]
    p = planes.reshape(1600, G).T.reshape(G, 50, 32)
    w = _bit_transpose_32(p.contiguous())                 # [G, word, s]
    return w.transpose(1, 2).reshape(G * 32, 25, 2).contiguous()


def bitslice_round_plan() -> list[tuple[int, int, int]]:
    """For each output plane of a round, the three post-theta planes chi
    reads (rho and pi as renamings): a copy of tools/probe_keccak.py::
    _bitslice_round_plan."""
    def p(x, y, z):
        return (x % 5 + 5 * (y % 5)) * 64 + (z % 64)

    def pre(xx, yy, zz):
        # B[xx, yy] is A[x, y] rotated by rho, pi mapping (x, y) to
        # (y, 2x + 3y): y = xx, x = 3 (yy - 3 xx) mod 5
        xx, yy = xx % 5, yy % 5
        y_src = xx
        x_src = (yy - 3 * xx) * 3 % 5
        return p(x_src, y_src, zz - KECCAK_ROTATIONS[x_src + 5 * y_src])

    return [(pre(x, y, z), pre(x + 1, y, z), pre(x + 2, y, z))
            for y in range(5) for x in range(5) for z in range(64)]


def rc_planes(device="cpu") -> torch.Tensor:
    """The round constants as plane masks int32[24, 64]: -1 (all 32 states)
    where bit z of round r's constant is set, else 0."""
    return torch.tensor([[-((rc >> z) & 1) for z in range(64)]
                         for rc in KECCAK_RC], dtype=torch.int32,
                        device=device)


def keccak_bitslice_plain(planes: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of P2 and P5: `iters` keccak-f of bit planes
    int32[1600, ...] in torch, on the planes' device."""
    shape = planes.shape
    a = planes.reshape(1600, -1)
    src = torch.tensor(bitslice_round_plan(), dtype=torch.int64,
                       device=planes.device).T
    rcp = rc_planes(planes.device)
    for _ in range(iters):
        for r in range(24):
            s = a.view(5, 5, 64, -1)                      # [y, x, z, cols]
            c = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4]          # [x, z, cols]
            d = c.roll(1, 0) ^ c.roll(-1, 0).roll(1, 1)   # C[x-1][z] ^ C[x+1][z-1]
            th = (s ^ d[None]).view(1600, -1)
            a = th[src[0]] ^ (~th[src[1]] & th[src[2]])
            a[:64] ^= rcp[r][:, None]
    return a.reshape(shape)


def _bitslice(planes: torch.Tensor, iters: int, fused: bool) -> torch.Tensor:
    global P2_LAUNCHES, P5_LAUNCHES
    if planes.dim() != 3 or planes.shape[0] != 1600 \
            or planes.dtype != torch.int32:
        raise ValueError(f"planes: expected int32[1600, 8, G8], got "
                         f"{planes.dtype}{list(planes.shape)}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if planes.device.type == "cpu":
        return keccak_bitslice_plain(planes, iters)
    what = "P5" if fused else "P2"
    _require_card(planes, what)
    state = planes.contiguous().clone()
    cols = state.shape[1] * state.shape[2]
    if cols == 0:
        return state
    _launched(_lib().eravm_p2_launch(_args(state), cols, iters, int(fused),
                                     _stream(state)), what)
    if fused:
        P5_LAUNCHES += 1
    else:
        P2_LAUNCHES += 1
    return state


def keccak_bitslice(planes: torch.Tensor, iters: int) -> torch.Tensor:
    """P2: `iters` keccak-f of int32[1600, 8, G8] bit planes; a new
    tensor."""
    return _bitslice(planes, iters, fused=False)


def keccak_bitslice_fused(planes: torch.Tensor, iters: int) -> torch.Tensor:
    """P5: P2's function, theta applied in the chi reads."""
    return _bitslice(planes, iters, fused=True)


# ---- P3 -------------------------------------------------------------------

def alu_chain_plain(state: torch.Tensor, op: str, inner: int,
                    iters: int) -> torch.Tensor:
    """The plain version of P3: `iters` x (inner // rows) steps of `op` over
    the rows of int32[rows, ...] (row j from the old rows j, j + 1, j + 2,
    mod rows): xor r[j] ^ r[j+1], mix rotl1(r[j]) ^ r[j+1], andnot
    r[j] ^ (~r[j+1] & r[j+2])."""
    if op not in OPS_PER_STEP:
        raise ValueError(f"unknown op {op!r}")
    rows = state.shape[0]
    r = state.reshape(rows, -1)
    for _ in range(iters * (inner // rows)):
        b = r.roll(-1, 0)
        if op == "xor":
            r = r ^ b
        elif op == "mix":
            r = ((r << 1) | ((r >> 31) & 1)) ^ b
        else:
            r = r ^ (~b & r.roll(-2, 0))
    return r.reshape(state.shape)


def alu_chain(state: torch.Tensor, op: str, inner: int,
              iters: int) -> torch.Tensor:
    """P3: `alu_chain_plain`'s function; a new tensor.  On the card rows is
    8 (the row count of every caller of the JAX tool) and a thread steps one
    column."""
    global P3_LAUNCHES
    if op not in OPS_PER_STEP or state.dtype != torch.int32:
        raise ValueError(f"P3: op {op!r}, {state.dtype}")
    if state.device.type == "cpu":
        return alu_chain_plain(state, op, inner, iters)
    _require_card(state, "P3")
    rows = state.shape[0]
    steps = iters * (inner // rows)
    if rows != 8 or steps >= 2**31:
        raise ValueError(f"P3: rows={rows}, steps={steps}")
    st = state.contiguous().clone()
    n = st.numel() // rows
    _launched(_lib().eravm_p3_launch(_args(st), rows, n, steps, _P3_OPS[op],
                                     _stream(st)), "P3")
    P3_LAUNCHES += 1
    return st


def best_seconds(fn, device, reps: int = 3) -> float:
    """The best of `reps` synchronised calls of fn after a warm one."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def probe_vpu_rate(op: str = "xor", rows: int = 8, tile: int = 1024,
                   inner: int = 512, iters: int = 65536,
                   rank1: bool = False, device="cuda") -> float:
    """P3's rate: u32 operations a second (the JAX probe's count, OPS_PER_STEP
    a row-step) over `rows` random rows of `tile` columns, shaped
    [rows, 8, tile // 8] (or [rows, tile] when rank1)."""
    device = torch.device(device)
    shape = (rows, tile) if rank1 else (rows, 8, tile // 8)
    gen = torch.Generator().manual_seed(0)
    st = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                       dtype=torch.int32).to(device)
    dt = best_seconds(lambda: alu_chain(st, op, inner, iters), device,
                       reps=1)
    return iters * (inner // rows) * rows * OPS_PER_STEP[op] * tile / dt


# ---- P4 -------------------------------------------------------------------

def round_chain_plain(state: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of P4: `iters` keccak rounds with ROUND_RC over
    int32[N, 25, 2]."""
    return keccak.from_lanes(keccak.keccak_rounds_lanes(
        keccak.to_lanes(state), [ROUND_RC] * iters))


def round_chain(state: torch.Tensor, iters: int) -> torch.Tensor:
    """P4: `round_chain_plain`'s function; a new tensor."""
    global P4_LAUNCHES
    keccak._check(state, iters)
    if state.device.type == "cpu":
        return round_chain_plain(state, iters)
    _require_card(state, "P4")
    st = state.contiguous().clone()
    _launched(_lib().eravm_p4_launch(_args(st), st.shape[0], iters,
                                     _stream(st)), "P4")
    P4_LAUNCHES += 1
    return st


def probe_round_rate(tile: int = 1024, iters: int = 4096,
                     device="cuda") -> float:
    """P4's rate: permutation equivalents (rounds / 24) a second of `tile`
    states."""
    device = torch.device(device)
    st = torch.ones((tile, 25, 2), dtype=torch.int32, device=device)
    dt = best_seconds(lambda: round_chain(st, iters), device, reps=1)
    return tile * iters / 24 / dt


# ---- the tool ---------------------------------------------------------------

def main(argv=None) -> dict:
    """Run the named variants; return {variant: rate}."""
    ap = argparse.ArgumentParser(
        prog="python -m era_zk_evm_tpu_torch.tools.probe_keccak",
        description="keccak-f formulation probes (P1-P5) on the card")
    ap.add_argument("variants", nargs="*",
                    help="base rows2d rows2d_tT_uU roundrate_tT "
                         "vpu_OP[_r1][_tT] bitslice_gG bitslice_fused_gG")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--iters", type=int, default=None,
                    help="overrides each variant's iteration count "
                         "(permutations 128, rounds 4096, vpu loops 65536)")
    args = ap.parse_args(argv)
    variants = args.variants or ["base", "rows2d"]
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --cpu to run the plain versions")
    print(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}",
          file=sys.stderr)
    batch = args.batch
    iters = args.iters or 128
    st = torch.ones((batch, 25, 2), dtype=torch.int32, device=device)
    results = {}
    for v in variants:
        t0 = time.time()
        if v == "base":
            fn, n = (lambda: keccak.keccak_f1600(st, iters)), batch
        elif v.startswith("rows2d"):
            tile, unroll = 2048, 1
            if v.startswith("rows2d_t"):
                t, _, u = v[len("rows2d_t"):].partition("_u")
                tile, unroll = int(t), int(u or 1)
            fn, n = (lambda: keccak_rows2d(st, iters, tile, unroll)), batch
        elif v.startswith("roundrate"):
            tile = int(v.split("_t")[1]) if "_t" in v else 1024
            rate = probe_round_rate(tile, args.iters or 4096, device)
            print(f"{v}: {rate / 1e6:.1f}M perm-equiv/s per tile")
            results[v] = rate
            continue
        elif v.startswith("vpu_"):
            rest, tile = v[4:], 1024
            if "_t" in rest:
                rest, _, t = rest.partition("_t")
                tile = int(t)
            rank1 = rest.endswith("_r1")
            op = rest[:-3] if rank1 else rest
            rate = probe_vpu_rate(op, tile=tile, iters=args.iters or 65536,
                                  rank1=rank1, device=device)
            print(f"{v}: {rate / 1e9:.2f}G u32-ops/s "
                  f"({rate / 1024 / 1e9:.2f}G dense-equivalent vreg-ops/s)")
            results[v] = rate
            continue
        elif v.startswith("bitslice"):
            g8 = int(v.split("_g")[1]) if "_g" in v else 128
            planes = torch.ones((1600, 8, g8), dtype=torch.int32,
                                device=device)
            f = keccak_bitslice_fused if v.startswith("bitslice_fused") \
                else keccak_bitslice
            fn, n = (lambda: f(planes, iters)), 32 * 8 * g8
        else:
            print(f"unknown variant {v}", file=sys.stderr)
            continue
        rate = n * iters / best_seconds(fn, device)
        results[v] = rate
        print(f"{v}: {rate / 1e6:.1f}M perms/s  "
              f"(total {time.time() - t0:.0f}s incl. build)")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
