"""K1's four instances and the rolling main path (K1 + K2) timed on the
card at the smoke run's shapes, for comparing two trees of the port in one
process each on one card.

    python era_zk_evm_tpu_torch/tools/k1_times.py [--tree DIR] [--reps 3]
        [--cases ec,precompile]

`--tree DIR` imports `era_zk_evm_tpu_torch` from DIR (another checkout of
the repository, e.g. the parent commit unpacked with `git archive`) in
place of this one, so one command can time parent, change, change, parent
on the same card.  The script uses only entry points that every tree of
the port since ecrecover has (`make_entry_state`, `clone_state`,
`fused_cycle.cycle_chunk`, `new_pq_block`, `splice_precompile_rows`, the
bench programs), builds that tree's kernels, and prints one JSON line:
the card's name and power limit and, per case, the best of `--reps`
CUDA-event times of one 128-cycle `cycle_chunk` call (with the round-witness
splice for kPrecomp and kEc, as `chip_smoke.py` times them), the splice
alone (the tree's `splice_rows` where it has one, the kernel, else its
torch `splice_precompile_rows`) with its device time by kernel from one
`torch.profiler` pass and the bound of the bytes it must move
(`splice_bytes`, counted alike for every tree), the launch's block size
and, for kEc where
the tree has `ops.secp256k1.ecrecover_unit`, the unit alone on the same
32768 signatures; K1's device time alone (`k1_device_ms`) and every
kernel's of the timed call from one `torch.profiler` pass.  `units` times
the keccak256 / sha256 units alone (`fused_cycle.precompile_units`, where
the tree has it) on the precompile mix's calls, a call a lane, beside their
operation bound: the kernel's device time a launch (`torch.profiler`) and
the CUDA-event time of the wrapper's call (`ms_events`, which holds the
host's launch work: the kernel takes far less).  The cases are `chip_smoke.py`'s K1
(WORKLOAD, B = 32768, memory queue), K1-storage (STORAGE_WORKLOAD, B =
32768, a second call on the warm state), K1-precompile (the precompile
mix, B = 32768) and K1-ecrecover (signed transfers, a recovery in every
lane, B = 32768), precompile-ec (the precompile mix on the ecrecover
instance kEc, which it runs without a recovery: the instance's cost
beside kPrecomp's), and K1 and K1-storage again at the block phases' B =
4096.  `main-b` is `chip_smoke.py`'s main-b (mode (b): the rolling
commitment, WORKLOAD, B = 32768) through the entry points every tree has
(`fused_cycle.run_cycles(st, cfg, 128, k_inner=128)`, `spill.rewind_queues`,
the tree's own `chip_smoke.bench_config`): the best of `--reps` walls of
one pipelined call (8 calls chained, host clock around a synchronised
run), K1's and K2's device time a call from one `torch.profiler` pass over
8 calls, split by kernel name (`k1_kernel`, `k2_kernel`), and lane 0's
memory records a chunk.  `ptxas` gives the registers, stack frame and
spills of every K1 and K2 instance (and the splice and unit kernels), from
the tree's build log, and `sass_counts` each K1 and unit kernel's SASS
instructions, local, global and shared loads and stores and calls; `--cases` picks cases (default all);
`sass_round` the SASS instructions (all, logic) of one keccak-f round in
K2, K3, the sponge and the units alone, read with `cuobjdump` (a loop's
count over the rounds it holds: 24 where they are unrolled), against the
180 int32 operations a round that the bounds count.  `keccak` times K3
(`ops.keccak.keccak_f1600_`) at the fingerprints' shape 131072 x 1,
65536 x 2048 and 131072 x 128, and chained at N = 1 (one permutation's
latency, beside `k3_n1_bound_us`: K3's permutation SASS at one instruction
a cycle), and the sponge (`ops.keccak.keccak256_ragged`) on seeded ragged
streams whose longest has 16954 blocks and on a T = 1 fold of 8192
digests, with bounds and the sponge's serial floor; every tree since the
ragged sponge has both entry points.  `blocks` runs block-precompile and
block-ecrecover through the tree's own `chip_smoke.py` helpers (B = 4096,
8192 txs): walls, txs/s, idle share, K1's and the splice's device time.
`bitslice` times the bit-sliced probes P2 and P5 at G8 = 128 and 4096 x
128 permutations beside their operation bound and K3 on the same 134217728
permutations, checks each against K3, and gives the tree's design, the
warps an SM holds and the SASS a round (LOP3, SHF, SHFL; `cuobjdump`).
`uniform` times the uniform-index probe P6 (`tools/probe_uniform`:
`uniform_gather`, `word_gather`, entry points every tree has) at W = 256,
REPS = 512 and TB = 256, 4096 and 32768, every layout with the tool's
index and a random one (elements in both modes), each held against its
plain version: the CUDA-event time of one call and its device time (the
call queued while the card is held busy, so the host's launch work is not
timed), beside its L1 floor (`p6_sectors`, `p6_floor_ms`, counted alike
for every tree); where the tree's wrapper takes `split`, the
batch-last and lane-major elements (uniform index, mode 1) and the
batch-last words again at S = 1, 2, 4, 8 and 16; an empty launch where
the tree has one; the tree's load design (`uniform_design`) and the SASS
of P6's loops (`load_overlap_sass`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import os
import re
import shutil
import subprocess
import sys
import time

CASES = ("main-b", "a", "log", "precompile", "precompile-ec", "ec", "a4096",
         "log4096", "units", "keccak", "blocks", "bitslice", "uniform")

#: int32 operations a keccak-f and a sha256 compression (chip_smoke.py's
#: bounds count the same)
KECCAK_OPS, SHA256_OPS = 4320, 1624
#: 132 SMs x 64 int32 lanes at the card's 1980 MHz: int32 operations a ms
INT32_OPS_PER_MS = 132 * 64 * 1980e3
#: the card's SM clock in MHz: instructions a microsecond at one a cycle
SM_MHZ = 1980
HBM_BYTES_PER_MS = 3.35e9
#: the keccak case's K3 shapes (states, iters): the fingerprints',
#: bench_keccak's and bench_keccak_u32pair's; K3 chained at N = 1; the
#: sponge's ragged streams: their count, mean and longest rate blocks (as
#: block-realistic's memory family: 8192 streams, 10123839 blocks, the
#: longest 16954), and the T = 1 fold's digests
K3_SHAPES = ((131072, 1), (65536, 2048), (131072, 128))
SERIAL_ITERS = 20000
RAGGED_STREAMS, RAGGED_MEAN_BLOCKS, RAGGED_LONGEST = 8192, 1236, 16954
FOLD_DIGESTS = 8192
#: the bitslice case: P2 / P5 at chip_smoke.py's G8s x 128 permutations;
#: int32 operations of a bit-sliced round of 32 states (chip_smoke.py's
#: BITSLICE_ROUND_OPS); K3 on as many permutations as P2 at G8 = 4096
BITSLICE_G8, BITSLICE_ITERS, BITSLICE_ROUND_OPS = (128, 4096), 128, 3840
BITSLICE_K3 = (65536, 2048)
#: the uniform case: P6 at chip_smoke.py's W, TBs and REPS, and the splits
#: timed beside each tree's own; P6's floor: the card's SMs, each moving one
#: 128-byte line (4 sectors of 32 bytes) a clock through its L1
UNIFORM_W, UNIFORM_TBS, UNIFORM_REPS = 256, (256, 4096, 32768), 512
UNIFORM_SPLITS = (1, 2, 4, 8, 16)
#: clocks the card spins ahead of a `held` timing (~1 ms at 1980 MHz)
HOLD_CYCLES = 2_000_000
SMS, L1_BYTES_PER_CLOCK, SECTOR = 132, 128, 32
#: P6's element and word layouts
P6_LAYOUTS = ("batch_last", "lane_major", "lane_words", "lane_words_v4",
              "words_batch_last")


def splice_bytes(emit, nslots, ps: int, cap: int, blocks0: int) -> int:
    """The bytes one splice of a chunk's round-witness rows must move (its
    bound's count, the same for any tree): emit and nslots (int32 [n, B])
    read; the data rows of each lane that keeps a surviving block read (its
    slot count, at most PS: the call's mem_in and mem_out rows); the range
    of queue rows that the surviving blocks cover written in full, 13 words
    a row (meta 4, value 8, flags 1) a lane; the lane scalars (pq_count,
    pq_blocks, lane_error) read and written.  `blocks0` is the clock,
    min(pq_blocks)."""
    import torch

    n, B = emit.shape
    flagged = (emit != 0).any(1).to(torch.int64)
    pos = blocks0 + torch.cumsum(flagged, 0) - flagged
    base = torch.clamp(pos * ps, max=cap - ps)
    last = torch.ones(n, dtype=torch.bool)
    last[:-1] = base[1:] != base[:-1]
    kept = last & (pos * ps <= cap - ps)
    rows_read = int(torch.where(emit[kept] != 0,
                                torch.clamp(nslots[kept], max=ps), 0).sum())
    rows_written = int(base[-1] + ps - base[0]) * B
    return 2 * emit.numel() * 4 + (rows_read + rows_written) * 13 * 4 \
        + 2 * B * (4 + 4 + 1)


def held_ms(fn) -> float:
    """One call's device time in ms: the card is held busy
    (`torch.cuda._sleep`, HOLD_CYCLES clocks) while the host queues the
    call between two CUDA events, so the host's own launch work is not
    timed."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def ptxas(log: str) -> dict:
    """Each K1 and K2 kernel's registers, stack frame and spills (bytes),
    from `nvcc -Xptxas -v` output: {mangled name: {...}}."""
    out, entry = {}, None
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", ln)
        if m and re.search(r"k[12]_kernel|pq_\w+_kernel|units?_kernel",
                           m.group(1)):
            entry = m.group(1)
            f = re.findall(r"(\d+) bytes", lines[i + 1])
            out[entry] = {"frame": int(f[0]), "spill_stores": int(f[1]),
                          "spill_loads": int(f[2])}
        elif m:
            entry = None
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            entry = None
    return out


def read_sass(lib_path) -> str | None:
    """cuobjdump -sass of a built library; None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_loops(sass: str, function: str, local: bool = False,
               consts: bool = False,
               opcodes: tuple[str, ...] = ()) -> list[tuple[int, ...]]:
    """The backward-branch loops of one function in cuobjdump's SASS (its
    mangled name matching the regex `function`), in address order: (all
    instructions, the logic ones: LOP3 and the funnel shift SHF) from the
    branch target to the branch, with `local` the local-memory loads and
    stores (spills) among them, with `consts` the 64-bit loads from the
    constant bank of the module's tables (c[0x3]: keccak's round constants
    are its only 64-bit table), then the count of each of `opcodes` (by
    the opcode's name before its first dot, e.g. SHFL)."""
    m = re.search(rf"Function : \S*{function}\S*\n(.*?)"
                  r"(?=\n\s*Function :|\Z)", sass, re.S)
    if not m:
        return []
    offsets, logic, labels, branches, pending = [], [], {}, [], []
    spills, const64, named = [], [], {name: [] for name in opcodes}
    for line in m.group(1).splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not ins:
            continue
        off = int(ins.group(1), 16)
        labels.update((name, off) for name in pending)
        pending = []
        offsets.append(off)
        words = ins.group(2).split()          # [@predicate] opcode ...
        opcode = words[1] if words[0].startswith("@") else words[0]
        if opcode.split(".")[0] in ("LOP3", "LOP", "SHF"):
            logic.append(off)
        if opcode.split(".")[0] in ("LDL", "STL"):
            spills.append(off)
        if opcode.split(".")[0] in named:
            named[opcode.split(".")[0]].append(off)
        if opcode.split(".")[0] in ("LDC", "ULDC") and ".64" in opcode \
                and "c[0x3]" in ins.group(2):
            const64.append(off)
        br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", ins.group(2))
        if br:
            branches.append((off, br.group(1)))
    loops = []
    for off, target in branches:
        t = int(target, 16) if target.startswith("0x") else labels.get(target)
        if t is not None and t < off:
            loops.append((sum(t <= o <= off for o in offsets),
                          sum(t <= o <= off for o in logic))
                         + (sum(t <= o <= off for o in spills),) * local
                         + (sum(t <= o <= off for o in const64),) * consts
                         + tuple(sum(t <= o <= off for o in named[name])
                                 for name in opcodes))
    return loops


#: SASS opcodes counted per function by `sass_counts`
SASS_CLASSES = {"local_loads": ("LDL",), "local_stores": ("STL",),
                "global_loads": ("LDG",), "global_stores": ("STG",),
                "shared_loads": ("LDS",), "shared_stores": ("STS",),
                "calls": ("CALL",)}


def sass_counts(sass: str | None, pattern: str = r"k1_kernel|unit") -> dict:
    """{mangled name: counts} for every function of cuobjdump's SASS whose
    name matches the regex `pattern`: all instructions and those of each
    class of `SASS_CLASSES` (local, global and shared loads and stores,
    calls).  Empty without cuobjdump."""
    out = {}
    if sass is None:
        return out
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)",
                         sass, re.S):
        if not re.search(pattern, m.group(1)):
            continue
        counts = dict.fromkeys(("instructions", *SASS_CLASSES), 0)
        for line in m.group(2).splitlines():
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if not ins:
                continue
            words = ins.group(1).split()
            opcode = (words[1] if words[0].startswith("@") else words[0]
                      ).split(".")[0]
            counts["instructions"] += 1
            for name, ops in SASS_CLASSES.items():
                counts[name] += opcode in ops
        out[m.group(1)] = counts
    return out


def keccak_round_sass(sass: str | None) -> dict:
    """{kernel: (all, logic, rounds)} for K2, K3, the sponge and the units
    alone (the precompile units' permutation): the kernel's smallest loop
    with 100 logic instructions or more holds `rounds` keccak-f rounds, one
    a load of a round constant in it, or 24 where it loads none (the rounds
    unrolled, their constants loaded before the loop), and all and logic
    are its SASS instructions over `rounds`, a round's; None without
    cuobjdump or such a loop."""
    out = {}
    for fn in ("k2_kernel", "k3_kernel", "k3s_kernel", "units_kernel"):
        loops = [x for x in sass_loops(sass, fn, consts=True) if x[1] >= 100] \
            if sass is not None else []
        if not loops:
            out[fn] = None
            continue
        n_all, n_logic, n_rc = min(loops)
        rounds = n_rc or 24
        out[fn] = (n_all / rounds, n_logic / rounds, rounds)
    return out


def p6_sectors(idx, w: int, tb: int, layout: str) -> int:
    """The 32-byte sectors that one repetition of P6's gathers touches, in
    `layout` (P6_LAYOUTS), summed over its warp loads: a warp load is 32
    consecutive lanes' load of one k (the elements), one limb (the words'
    32-bit loads) or one 16-byte half of a word (`lane_words_v4`), and
    touches the distinct sectors of its live lanes (index below `w`)."""
    import torch

    i = idx.to(torch.int64) & 0xFFFFFFFF
    live = i < w
    i = torch.where(live, i, 0)
    t = torch.arange(tb, dtype=torch.int64, device=idx.device)
    k = torch.arange(8, dtype=torch.int64, device=idx.device)[:, None]
    words = {"batch_last": lambda: (k * w + i) * tb + t,
             "lane_major": lambda: (t * 8 + k) * w + i,
             "lane_words": lambda: (t * w + i) * 8 + k,
             "lane_words_v4": lambda: (t * w + i) * 8 + 4 * k[:2],
             "words_batch_last": lambda: (i * 8 + k) * tb + t}[layout]()
    sector = torch.where(live, words * 4 // SECTOR, -1)
    pad = -tb % 32
    sector = torch.nn.functional.pad(sector, (0, pad), value=-1)
    sector = sector.view(sector.shape[0], -1, 32).sort(-1).values
    first = torch.ones_like(sector, dtype=torch.bool)
    first[..., 1:] = sector[..., 1:] != sector[..., :-1]
    return int((first & (sector >= 0)).sum())


def p6_floor_ms(sectors: int, reps: int, tb: int, sm_mhz: float) -> float:
    """P6's floor in ms: `reps` repetitions of `sectors` sectors through the
    card's L1s (SMS of them, each L1_BYTES_PER_CLOCK a clock at `sm_mhz`),
    or the compulsory bytes over device memory's rate (the 8 gathered words
    and the index read, the 8 output words written: 17 a lane), whichever
    is larger."""
    l1_ms = reps * sectors * SECTOR / (SMS * L1_BYTES_PER_CLOCK * sm_mhz * 1e3)
    return max(l1_ms, 4 * 17 * tb / HBM_BYTES_PER_MS)


def load_overlap_sass(sass: str | None, function: str) -> dict | None:
    """The loop of `function` (a regex of its mangled name) in cuobjdump's
    SASS that holds the most global loads (LDG): their opcodes, how many a
    trip, all the trip's instructions, and how many loads issue before the
    first instruction of the trip that reads a loaded register (the loads
    a thread has in flight at once); None without cuobjdump or such a
    loop."""
    m = sass and re.search(rf"Function : \S*{function}\S*\n(.*?)"
                           r"(?=\n\s*Function :|\Z)", sass, re.S)
    if not m:
        return None
    ins = [(int(off, 16), text) for off, text in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", m.group(1))]
    best = None
    for off, text in ins:
        br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if not br or int(br.group(1), 16) >= off:
            continue
        body = [t.split(None, 1) for o, t in ins
                if int(br.group(1), 16) <= o <= off]
        body = [w[1].split(None, 1) if w[0].startswith("@") else w
                for w in body]
        loads = [w for w in body if w[0].startswith("LDG")]
        if not loads or (best and len(loads) <= best["loads_a_trip"]):
            continue
        pending, in_flight = set(), len(loads)
        for w in body:
            regs = re.findall(r"\bR(\d+)\b", w[1] if len(w) > 1 else "")
            if w[0].startswith("LDG"):
                pending.add(regs[0])
            elif pending & set(regs[1:]):
                in_flight = len(pending)
                break
        best = {"load_opcodes": sorted({w[0] for w in loads}),
                "loads_a_trip": len(loads), "in_flight": in_flight,
                "instructions_a_trip": len(body)}
    return best


def uniform_design(tree) -> dict:
    """The load design that `tree`'s csrc/probe_uniform.cu builds P6 with,
    as a variant tree edits it: the load's PTX (P6_LD_OP), the loads a trip
    issues before the first is summed (kP6InFlight), whether each load is
    offset by the kernel argument that the wrapper passes as 0
    (kP6Offset) and whether the arena tile is staged in shared memory (the
    `staged` variant's p6s_kernel); {} where the source has none of them (a
    tree before the weak-load design)."""
    src = (pathlib.Path(tree) / "era_zk_evm_tpu_torch" / "csrc"
           / "probe_uniform.cu").read_text()
    found = {"load": re.search(r'#define P6_LD_OP "([\w.]+)"', src),
             **{k: re.search(rf"constexpr \w+ {c} = (\w+);", src)
                for k, c in (("in_flight", "kP6InFlight"),
                             ("offset", "kP6Offset"))}}
    if not all(found.values()):
        return {}
    design = {k: m.group(1) for k, m in found.items()}
    design["in_flight"] = int(design["in_flight"])
    design["staged"] = "p6s_kernel" in src
    return design


def bitslice_design(tree) -> dict:
    """The warps a block and rounds a loop trip (kP2Warps, kP2Trip) that
    `tree`'s csrc/probe_keccak.cu builds P2 / P5 with, as a variant tree
    edits them: {"warps_a_block": w, "trip": t}, {} where the source has
    neither (a tree before the warp-a-column design)."""
    src = (pathlib.Path(tree) / "era_zk_evm_tpu_torch" / "csrc"
           / "probe_keccak.cu").read_text()
    found = {k: re.search(rf"constexpr int {c} = (\d+);", src)
             for k, c in (("warps_a_block", "kP2Warps"), ("trip", "kP2Trip"))}
    return {k: int(m.group(1)) for k, m in found.items() if m} \
        if all(found.values()) else {}


#: the opcodes that bitslice_round_sass counts a round
BITSLICE_OPCODES = ("LOP3", "SHF", "SHFL", "LDS", "STS")


def bitslice_round_sass(sass: str | None, trip: int | None) -> dict:
    """{P2, P5: {all, LOP3, SHF, SHFL, LDS, STS}} SASS instructions a round
    of p2_kernel<false> and <true>: the kernel's smallest loop with 100
    logic instructions or more holds `trip` rounds (the tree's
    kP2Trip); None without cuobjdump, such a loop or a trip (a tree
    before the warp-a-column design)."""
    out = {}
    for name, fn in (("P2", r"p2_kernelILb0E"), ("P5", r"p2_kernelILb1E")):
        loops = [x for x in sass_loops(sass, fn, opcodes=BITSLICE_OPCODES)
                 if x[1] >= 100] if sass is not None and trip else []
        out[name] = None if not loops else dict(zip(
            ("all", "logic") + BITSLICE_OPCODES,
            (v / trip for v in min(loops))))
    return out


def unit_round_sass(sass: str | None) -> dict:
    """{K1 instance with the units: (all, logic, local-memory) SASS
    instructions of its keccak-f round loop}: the instance's smallest loop
    with 100 logic instructions or more (the units' permutation, a round a
    trip); None without cuobjdump or such a loop."""
    out = {}
    for name, fn in (("kPrecomp", r"k1_kernelILb1ELb1ELb0E"),
                     ("kEc", r"k1_kernelILb1ELb1ELb1E")):
        rounds = [x for x in sass_loops(sass, fn, local=True)
                  if x[1] >= 100] if sass is not None else []
        out[name] = min(rounds) if rounds else None
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]),
                    help="import the port from this checkout (default: "
                         "the one holding this script)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases (default: all)")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    if set(cases) - set(CASES):
        raise SystemExit(f"k1_times: cases are {CASES}")
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_times: no CUDA card")
    from era_zk_evm_tpu_torch import _build
    from era_zk_evm_tpu_torch.config import VmConfig, precompile_queue_slots
    from era_zk_evm_tpu_torch.models import fused_cycle
    from era_zk_evm_tpu_torch.models.spill import rewind_queues
    from era_zk_evm_tpu_torch.models.state import (
        clone_state, make_entry_state,
    )
    from era_zk_evm_tpu_torch.ops import secp256k1
    from era_zk_evm_tpu_torch.testing import block_programs, ec_programs
    from era_zk_evm_tpu_torch.testing.programs import (
        STORAGE_WORKLOAD, WORKLOAD, assemble,
    )

    dev = torch.device("cuda:0")
    K, ERGS = 128, (1 << 31) - 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.time()
    lib = _build.build()
    _build.load()
    build_s = time.time() - t0

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def base(batch, **kw):
        return VmConfig(batch=batch, code_words=16, stack_words=256,
                        sweep_gating=False, stack_abs_words=64,
                        stack_sp_base=960, aux_heap_words=16, max_depth=8,
                        **kw)

    def storage(batch):
        return base(batch, heap_words=16, storage_slots=8, journal_slots=64,
                    event_slots=64)

    def units(cfg, ecrecover=False):
        cfg = dataclasses.replace(cfg, precompile_keccak_blocks=2,
                                  precompile_sha_rounds=2,
                                  precompile_ecrecover=ecrecover)
        return dataclasses.replace(cfg, precompile_queue_capacity=K * sum(
            precompile_queue_slots(cfg)))

    def case(name):
        """(config, entry state, warm calls before the timed one)"""
        batch = 4096 if name.endswith("4096") else 32768
        if name.startswith("a"):
            cfg = base(batch, heap_words=64, queue_capacity=K * 8)
            return cfg, make_entry_state(cfg, [assemble(WORKLOAD)] * batch,
                                         ergs=ERGS, device=dev), 0
        if name.startswith("log"):
            cfg = storage(batch)
            return cfg, make_entry_state(
                cfg, [assemble(STORAGE_WORKLOAD)] * batch, ergs=ERGS,
                device=dev), 1
        if name.startswith("precompile"):
            cfg = units(storage(batch), ecrecover=name.endswith("-ec"))
            mix = block_programs.precompile_mix(batch)
            cache = {}
            return cfg, make_entry_state(
                cfg, [cache.setdefault(s, assemble(s)) for _, s, *_ in mix],
                ergs=ERGS, entry_address=[e for e, *_ in mix],
                device=dev), 0
        cfg = units(storage(batch), ecrecover=True)
        mix = ec_programs.ecrecover_mix(8192)
        cache = {}
        progs = [cache.setdefault(s, assemble(s)) for _, s, *_ in mix]
        return cfg, make_entry_state(
            cfg, [progs[i % len(progs)] for i in range(batch)], ergs=ERGS,
            entry_address=ec_programs.EC, device=dev), 0

    def splice_kernels(entry, cfg, pq) -> dict:
        """The splice's device time by kernel name (torch.profiler, one
        call on a fresh copy of the entry state)."""
        sp = clone_state(entry)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            splice_fn(sp, cfg, pq, K)
            torch.cuda.synchronize()
        return {e.key[:40]: e.self_device_time_total / 1e3
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    def k1_device(entry, cfg, pq, warm_calls) -> dict:
        """The device time by kernel name of one timed call (after the
        case's warm calls, on a fresh copy of the entry state), from one
        `torch.profiler` pass: K1 alone and the splice's kernels."""
        st = clone_state(entry)
        for _ in range(warm_calls):
            fused_cycle.cycle_chunk(st, cfg, K, pq_block=pq)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fused_cycle.cycle_chunk(st, cfg, K, pq_block=pq)
            torch.cuda.synchronize()
        return {e.key[:40]: e.self_device_time_total / 1e3
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    def unit_times(batch) -> dict:
        """The ecrecover unit alone (ec_unit_kernel) on the signatures of
        the ec case's lanes: the best of `--reps` times, recoveries/s."""
        mix = ec_programs.ecrecover_mix(8192)
        sigs = [mix[i % len(mix)][4] for i in range(batch)]
        digest, r, s = (torch.tensor(
            [secp256k1.to_limbs(c[i]) for c in sigs], dtype=torch.int64)
            .to(torch.int32).to(dev) for i in (0, 2, 3))
        v = torch.tensor([c[1] for c in sigs], dtype=torch.int32).to(dev)
        secp256k1.ecrecover_unit(digest, v, r, s)          # warm
        times = [timed(lambda: secp256k1.ecrecover_unit(digest, v, r, s))
                 for _ in range(args.reps)]
        return {"unit_ms": min(times), "unit_ms_all": times,
                "unit_recoveries_per_sec": batch / (min(times) / 1e3)}

    def units_times() -> dict:
        """The keccak256 / sha256 units alone (`precompile_units`) on the
        precompile mix's calls at B = 32768, a call a lane (keccak256 of 64
        bytes at offset 0, sha256 of 1 or 2 rounds at word 0, random words
        from a seed): the best of `--reps` times, against the operation
        bound of their keccak-f and compressions."""
        import numpy as np

        cfg = units(storage(32768))
        mix = block_programs.precompile_mix(cfg.batch)
        rounds = np.array([r for *_, r in mix])
        ps_in = precompile_queue_slots(cfg)[0]
        rng = np.random.RandomState(14)
        arena = torch.from_numpy(rng.randint(
            -2**31, 2**31, size=(ps_in, 8, cfg.batch)).astype(np.int32)
        ).to(dev)
        call = torch.from_numpy(np.stack([
            (rounds > 0).astype(np.int32), np.zeros_like(rounds),
            np.zeros_like(rounds), np.where(rounds > 0, 0, 64), rounds],
            axis=1).astype(np.int32)).to(dev)
        fused_cycle.precompile_units(cfg, arena, call)          # warm
        times = [timed(lambda: fused_cycle.precompile_units(cfg, arena, call))
                 for _ in range(args.reps)]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fused_cycle.precompile_units(cfg, arena, call)
            torch.cuda.synchronize()
        kernel = [e for e in prof.key_averages() if "units_kernel" in e.key]
        perms, comps = int((rounds == 0).sum()), int(rounds.sum())
        return {"batch": cfg.batch, "ms_events": min(times),
                "ms_events_all": times,
                "ms": sum(e.self_device_time_total for e in kernel) / 1e3
                / max(sum(e.count for e in kernel), 1),
                "keccak_f": perms, "sha256_compressions": comps,
                "bound_ms": (perms * KECCAK_OPS + comps * SHA256_OPS)
                / INT32_OPS_PER_MS}

    def keccak_times() -> dict:
        """K3 (`ops.keccak.keccak_f1600_`, in place) at K3_SHAPES and at
        N = 1 chained SERIAL_ITERS times (one permutation's latency on one
        thread), and the sponge (`ops.keccak.keccak256_ragged`) on seeded
        ragged streams and on a T = 1 fold: the best of `--reps` CUDA-event
        times beside the bounds (and the sponge's serial floor, its longest
        stream at K3's N = 1 latency).  The inputs are made on the card from
        fixed seeds, so two trees permute the same states."""
        import numpy as np

        from era_zk_evm_tpu_torch.ops import keccak

        gen = torch.Generator(device=dev).manual_seed(15)

        def words(n):
            return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                 dtype=torch.int32, device=dev)

        def best(fn):
            fn()
            return min(timed(fn) for _ in range(args.reps))

        res = {}
        for n, iters in K3_SHAPES:
            st = words(n * 50).view(n, 25, 2)
            ms = best(lambda: keccak.keccak_f1600_(st, iters))
            res[f"k3_{n}x{iters}_ms"] = ms
            res[f"k3_{n}x{iters}_bound_ms"] = max(
                2 * n * 200 / HBM_BYTES_PER_MS,
                n * iters * KECCAK_OPS / INT32_OPS_PER_MS)
            del st
        one = words(50).view(1, 25, 2)
        perm_us = best(lambda: keccak.keccak_f1600_(one, SERIAL_ITERS)) \
            * 1e3 / SERIAL_ITERS
        res["k3_n1_us"] = perm_us
        rng = np.random.default_rng(15)
        blocks = np.minimum(rng.geometric(1 / RAGGED_MEAN_BLOCKS,
                                          RAGGED_STREAMS), RAGGED_LONGEST)
        blocks[0] = RAGGED_LONGEST
        for name, lengths in (
                ("ragged", 34 * (blocks - 1) + rng.integers(0, 34, blocks.size)),
                ("fold", np.array([8 * FOLD_DIGESTS]))):
            offsets = torch.from_numpy(np.concatenate(
                [[0], np.cumsum(lengths)]).astype(np.int64)).to(dev)
            w = words(int(lengths.sum()))
            nbs = lengths // 34 + 1
            res[f"sponge_{name}_ms"] = best(
                lambda: keccak.keccak256_ragged(w, offsets))
            res[f"sponge_{name}_blocks"] = int(nbs.sum())
            res[f"sponge_{name}_longest"] = int(nbs.max())
            res[f"sponge_{name}_bound_ms"] = max(
                (w.numel() * 4 + offsets.numel() * 8 + 32 * lengths.size)
                / HBM_BYTES_PER_MS, int(nbs.sum()) * KECCAK_OPS
                / INT32_OPS_PER_MS)
            res[f"sponge_{name}_serial_floor_ms"] = \
                int(nbs.max()) * perm_us / 1e3
            del w, offsets
        return res

    def bitslice_times() -> dict:
        """P2 and P5 (`tools/probe_keccak.keccak_bitslice`, `_fused`, entry
        points every tree has) at BITSLICE_G8 x BITSLICE_ITERS on the planes
        of seeded random states: the best of `--reps` CUDA-event times
        beside the operation bound, each kernel's one-permutation output
        held against K3 through `planes_to_states` (`equal`), K3 on as many
        permutations as P2 at G8 = 4096 (BITSLICE_K3, in place), and where
        the tree has them its design (`bitslice_design`), the warps an SM
        holds at once (eravm_p2_warps_per_sm) and the SASS a round."""
        import ctypes

        from era_zk_evm_tpu_torch.ops import keccak
        from era_zk_evm_tpu_torch.tools import probe_keccak as pk

        gen = torch.Generator(device=dev).manual_seed(17)
        lib = _build.load()
        design = bitslice_design(args.tree)
        if hasattr(lib, "eravm_p2_warps_per_sm"):
            lib.eravm_p2_warps_per_sm.argtypes = [ctypes.c_int]
            design.update({f"{k}_warps_per_sm": lib.eravm_p2_warps_per_sm(f)
                           for f, k in enumerate(("p2", "p5"))})
        res = {"design": design, "sass_round": bitslice_round_sass(
            sass, design.get("trip"))}

        def best(fn):
            fn()
            return min(timed(fn) for _ in range(args.reps))

        for g8 in BITSLICE_G8:
            n = 256 * g8
            states = torch.randint(-2**31, 2**31 - 1, (n, 25, 2),
                                   generator=gen, dtype=torch.int32,
                                   device=dev)
            planes = pk.states_to_planes(states)
            k3 = keccak.keccak_f1600(states, 1)
            cols = 8 * g8
            res[f"g{g8}_bound_ms"] = max(
                2 * 6400 * cols / HBM_BYTES_PER_MS,
                cols * 24 * BITSLICE_ITERS * BITSLICE_ROUND_OPS
                / INT32_OPS_PER_MS)
            for name, f in (("p2", pk.keccak_bitslice),
                            ("p5", pk.keccak_bitslice_fused)):
                res[f"{name}_g{g8}_equal"] = torch.equal(
                    pk.planes_to_states(f(planes, 1)), k3)
                res[f"{name}_g{g8}_ms"] = best(
                    lambda: f(planes, BITSLICE_ITERS))
            del states, planes, k3
        n, iters = BITSLICE_K3
        st = torch.randint(-2**31, 2**31 - 1, (n, 25, 2), generator=gen,
                           dtype=torch.int32, device=dev)
        res["k3_same_perms_ms"] = best(lambda: keccak.keccak_f1600_(st, iters))
        return res

    def uniform_times() -> dict:
        """P6 at UNIFORM_TBS: every layout, index and mode as the module
        docstring says, {case: [ms, device ms, floor ms, floor over device
        ms]} (the best of `--reps` CUDA-event times of one call, and of
        `held_ms`'s device times; `equal` false and
        the case in `unequal` where it differs from the plain version), the
        splits where the wrapper takes one (`split<S>` cases), the S each
        TB gets, an empty launch (both times), the design and the loops'
        SASS."""
        import inspect

        from era_zk_evm_tpu_torch.tools import probe_uniform as pu

        def best(fn):
            fn()
            return min(timed(fn) for _ in range(args.reps))

        def best_held(fn):
            fn()
            return min(held_ms(fn) for _ in range(args.reps))

        takes_split = "split" in inspect.signature(
            pu.uniform_gather).parameters
        res = {"design": uniform_design(args.tree),
               "sass": {f: load_overlap_sass(sass, f)
                        for f in ("p6_kernel", "p6w_kernel")},
               "cases": {}, "unequal": []}
        if hasattr(pu, "empty_launch"):
            res["empty_ms"] = best(lambda: pu.empty_launch(dev))
            res["empty_device_ms"] = best_held(lambda: pu.empty_launch(dev))
        for tb in UNIFORM_TBS:
            if takes_split:
                res[f"tb{tb}_split"] = pu.card_split(tb, dev)
                res[f"tb{tb}_words_split"] = pu.card_split(tb, dev, True)
            for random_index in (False, True):
                kind = "random" if random_index else "uniform"
                for layout in P6_LAYOUTS:
                    words = layout not in ("batch_last", "lane_major")
                    arena, idx = pu.tool_inputs(
                        UNIFORM_W, tb, dev, random_index,
                        layout == "lane_major", layout if words else None)
                    floor = p6_floor_ms(
                        p6_sectors(idx, UNIFORM_W, tb, layout),
                        UNIFORM_REPS, tb, SM_MHZ)
                    if words:
                        want = pu.word_gather_plain(arena, idx, UNIFORM_REPS,
                                                    layout)
                        runs = {"": lambda s: pu.word_gather(
                            arena, idx, UNIFORM_REPS, layout,
                            **({"split": s} if s else {}))}
                    else:
                        want = pu.uniform_gather_plain(
                            arena, idx, UNIFORM_REPS, layout == "lane_major")
                        runs = {f"_mode{m}": lambda s, m=m: pu.uniform_gather(
                            arena, idx, UNIFORM_REPS, m,
                            layout == "lane_major",
                            **({"split": s} if s else {})) for m in (0, 1)}
                    splits = [0]
                    if takes_split and not random_index and layout in (
                            "batch_last", "lane_major", "words_batch_last"):
                        splits += list(UNIFORM_SPLITS)
                    for suffix, run in runs.items():
                        for s in splits:
                            if s and suffix == "_mode0":
                                continue
                            tag = (f"tb{tb}_{layout}_{kind}{suffix}"
                                   + (f"_split{s}" if s else ""))
                            box = {}
                            ms = best(lambda: box.__setitem__("k", run(s)))
                            if not torch.equal(box["k"], want):
                                res["unequal"].append(tag)
                            dev_ms = best_held(lambda: run(s))
                            res["cases"][tag] = [ms, dev_ms, floor,
                                                 floor / dev_ms]
                    del arena, idx, want
        res["equal"] = not res["unequal"]
        return res

    def blocks() -> dict:
        """block-precompile and block-ecrecover as the tree's own
        `chip_smoke.py` drives them (its `block_config`, `BLOCK_KNOBS`,
        mixes and `block_phase`: a warm run, a timed one, a profiled one),
        then `--reps` - 1 more synchronised walls: txs/s at the best wall,
        the device's idle share, K1's and the splice's device time and the
        launches."""
        import chip_smoke as cs

        ec_txs = cs.as_txs(ec_programs.ecrecover_mix(2 * cs.B_BLOCK))
        res = {}
        for tag, ec in (("block-precompile", False),
                        ("block-ecrecover", True)):
            cfg = cs.block_config(cs.B_BLOCK, precompile=True, ecrecover=ec)
            knobs = dict(cs.BLOCK_KNOBS)
            knobs["drain_compact_frac"] = dict(knobs["drain_compact_frac"],
                                               precompile=0.25)
            txs = ec_txs if ec else cs.mix_txs("precompile", 2 * cs.B_BLOCK)
            _, wall, launches, prof = cs.block_phase(tag, cfg, txs, knobs,
                                                     dev)
            walls = [wall]
            for _ in range(args.reps - 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cs.execute_block(cfg, txs, device=dev, **knobs)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            res[tag] = {"txs": len(txs), "walls_s": walls,
                        "txs_per_sec": len(txs) / min(walls),
                        "launches": launches,
                        **{k: prof[k] for k in ("idle_share", "k1_device_ms",
                                                "splice_device_ms")}}
        return res

    def main_b() -> dict:
        """chip_smoke.py's main-b: pipelined wall a call, K1's and K2's
        device time a call, lane 0's records a chunk."""
        import chip_smoke

        calls = 8
        cfg = chip_smoke.bench_config(32768, rolling=True)
        entry = make_entry_state(cfg, [assemble(WORKLOAD)] * cfg.batch,
                                 ergs=ERGS, device=dev)
        st = clone_state(entry)

        def call():
            fused_cycle.run_cycles(st, cfg, K, k_inner=K)
            rewind_queues(st)

        call()                                    # loads, warms
        torch.cuda.synchronize()
        before = int(st.wc_count[0])
        call()
        torch.cuda.synchronize()
        records = int(st.wc_count[0]) - before
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / calls)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        dev_ms = {"k1": 0.0, "k2": 0.0}
        counts = {"k1": 0, "k2": 0}
        for e in prof.key_averages():
            for k in dev_ms:
                if f"{k}_kernel" in e.key:
                    dev_ms[k] += e.self_device_time_total / 1e3 / calls
                    counts[k] += e.count
        errors = int(st.lane_error.sum())
        return {"batch": cfg.batch, "wall_ms": min(walls) * 1e3,
                "wall_ms_all": [w * 1e3 for w in walls],
                "cycles_per_sec_pipelined": cfg.batch * K / min(walls),
                "k1_device_ms": dev_ms["k1"], "k2_device_ms": dev_ms["k2"],
                "profiled_launches": counts,
                "records_lane0_per_chunk": records, "lane_errors": errors}

    sass = read_sass(lib)
    out = {"card": card, "tree": args.tree, "build_s": build_s,
           "torch": torch.__version__,
           "ptxas": ptxas((lib.parent / "build.log").read_text()),
           "sass_round": keccak_round_sass(sass),
           "unit_round_sass": unit_round_sass(sass),
           "sass_counts": sass_counts(sass)}
    splice_fn = getattr(fused_cycle, "splice_rows",
                        fused_cycle.splice_precompile_rows)
    for name in cases:
        if name == "blocks":
            out[name] = blocks()
            torch.cuda.empty_cache()
            continue
        if name == "main-b":
            out[name] = main_b()
            torch.cuda.empty_cache()
            continue
        if name == "units":
            if hasattr(fused_cycle, "precompile_units"):
                out[name] = units_times()
            continue
        if name == "bitslice":
            out[name] = bitslice_times()
            torch.cuda.empty_cache()
            continue
        if name == "uniform":
            out[name] = uniform_times()
            torch.cuda.empty_cache()
            continue
        if name == "keccak":
            out[name] = keccak_times()
            k3 = out["sass_round"]["k3_kernel"]
            # one permutation's SASS at one instruction a cycle
            out[name]["k3_n1_bound_us"] = k3[0] * 24 / SM_MHZ if k3 else None
            torch.cuda.empty_cache()
            continue
        cfg, entry, warm_calls = case(name)
        pq = fused_cycle.new_pq_block(cfg, K, dev)
        warm = clone_state(entry)
        fused_cycle.cycle_chunk(warm, cfg, K, pq_block=pq)   # loads, warms
        del warm
        times, splices, kernels = [], [], None
        for _ in range(args.reps):
            st = clone_state(entry)
            for _ in range(warm_calls):
                fused_cycle.cycle_chunk(st, cfg, K, pq_block=pq)
            times.append(timed(lambda: fused_cycle.cycle_chunk(
                st, cfg, K, pq_block=pq)))
            if pq is not None:
                sp = clone_state(entry)
                splices.append(timed(lambda: splice_fn(sp, cfg, pq, K)))
                del sp
                kernels = splice_kernels(entry, cfg, pq)
            errors = int(st.lane_error.sum())
            del st
        device_ms = k1_device(entry, cfg, pq, warm_calls)
        out[name] = {"batch": cfg.batch, "ms": min(times), "ms_all": times,
                     "k1_device_ms": sum(v for k, v in device_ms.items()
                                         if "k1_kernel" in k),
                     "device_ms": device_ms,
                     "splice_ms": min(splices, default=None),
                     "splice_ms_all": splices, "splice_kernels_ms": kernels,
                     "lane_errors": errors,
                     "threads": getattr(fused_cycle, "k1_threads",
                                        lambda b: 128)(cfg.batch)}
        if pq is not None:
            n_bytes = splice_bytes(
                pq[3].cpu(), pq[4].cpu(), pq[0].shape[1],
                cfg.precompile_queue_capacity, int(entry.pq_blocks.min()))
            out[name].update(splice_bytes=n_bytes,
                             splice_bound_ms=n_bytes / HBM_BYTES_PER_MS)
        if name == "ec" and hasattr(secp256k1, "ecrecover_unit"):
            out[name].update(unit_times(cfg.batch))
        del entry, pq
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
