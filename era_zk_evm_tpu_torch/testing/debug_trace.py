"""Debug tracing: per-cycle architectural snapshots of selected lanes.

The port of `era_zk_evm_tpu/testing/debug_trace.py`.  The reference's
`Tracer` hooks observe one VM from inside its cycle loop; a batched engine
is opaque while it runs, so `trace_cycles` steps the product engine one
cycle at a time, `fused_cycle.run_cycles(state, config, 1)` (one K1 launch
a cycle on a CUDA state, the plain step on a CPU one), and reads back the
before-execution view of the traced lanes: pc, the instruction about to
execute and its disassembly, sp, ergs, flags, depth, timestamp.  The rows
line up 1:1 with golden's `CollectingDebugTracer` events
(`tests/test_torch_debug_trace.py`), so a mismatching cycle localizes
immediately.  Each cycle reads back only the traced lanes' columns, in one
copy: it syncs the device once a cycle, so it is a debugging tool, not a
production path.

`resolve_page` / `dump_page_content` / `dump_full_page` dump one lane's VM
page from the device arenas, as golden's `dump_page` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CS, VmConfig
from ..isa.assembler import disassemble_one
from ..models import fused_cycle
from ..models.state import BatchedVmState, arena_word_major, reference_view
from ..utils import from_limbs


@dataclasses.dataclass
class CycleSnapshot:
    """One lane's architectural state at a cycle boundary."""

    cycle: int
    pc: int
    sp: int
    ergs: int
    depth: int
    flags: tuple[bool, bool, bool]      # (lt/of, eq, gt)
    timestamp: int
    instruction: int                    # raw 8-byte encoding at pc
    asm: str                            # disassembly of `instruction`
    done: bool
    lane_error: bool
    registers: list[int] | None = None  # optional full register file


def _fetch_instruction(cb_page: np.ndarray, cb_valid: np.ndarray,
                       code: np.ndarray, config: VmConfig, pc: int,
                       code_page: int) -> int:
    """The 8-byte instruction at (code_page, pc) in one lane's code bank
    (`cb_page`, `cb_valid` [P]; `code` [P*CW, 8] uint32)."""
    slot = None
    for s in range(cb_page.shape[0]):
        if cb_valid[s] and int(cb_page[s]) == code_page:
            slot = s
            break
    if slot is None:
        return 0
    super_pc, sub_pc = pc >> 2, pc & 3
    if super_pc >= config.code_words:
        return 0
    word = from_limbs(code[slot * config.code_words + super_pc])
    shift = 64 * (3 - sub_pc)
    return (word >> shift) & ((1 << 64) - 1)


def _read_lanes(state: BatchedVmState, config: VmConfig, idx: torch.Tensor,
                with_registers: bool) -> list[np.ndarray]:
    """The traced lanes' columns, gathered on the device and copied to the
    host in one piece: depth, the current frame's scalars, flags,
    timestamp, done, lane_error, the code bank and, if asked, the
    registers; each [n, .] uint32."""
    ref = reference_view(state)
    depth = state.depth[idx]
    parts = [depth[:, None], ref.cs_scalars[idx, depth.to(torch.int64)],
             state.flags[idx], state.timestamp[idx, None],
             state.done[idx, None], state.lane_error[idx, None],
             ref.cb_page[idx], ref.cb_valid[idx],
             arena_word_major(ref.code, config)[idx].flatten(1)]
    if with_registers:
        parts.append(state.regs[idx].flatten(1))
    sizes = [p.shape[1] for p in parts]
    flat = torch.cat([p.to(torch.int32) for p in parts], 1).cpu().numpy()
    return np.split(flat.view(np.uint32), np.cumsum(sizes)[:-1], axis=1)


def trace_cycles(state: BatchedVmState, config: VmConfig, n_cycles: int,
                 lanes: list[int] | None = None,
                 with_registers: bool = False,
                 ) -> tuple[BatchedVmState, list[list[CycleSnapshot]]]:
    """Step n_cycles one at a time, snapshotting `lanes` before each cycle.

    Returns (state, traces), the state advanced in place and traces[i] the
    i-th requested lane's per-cycle snapshots.  The snapshot is the
    before-execution view: the instruction ABOUT to execute at that cycle.
    """
    lanes = list(range(config.batch)) if lanes is None else list(lanes)
    traces: list[list[CycleSnapshot]] = [[] for _ in lanes]
    idx = torch.as_tensor(lanes, dtype=torch.int64, device=state.done.device)
    for k in range(n_cycles):
        (depth, frame, flags, ts, done, err, cb_page, cb_valid, code,
         *regs) = _read_lanes(state, config, idx, with_registers)
        for i in range(len(lanes)):
            pc = int(frame[i, CS["pc"]])
            insn = _fetch_instruction(
                cb_page[i], cb_valid[i], code[i].reshape(-1, 8), config,
                pc, int(frame[i, CS["code_page"]]))
            traces[i].append(CycleSnapshot(
                cycle=k,
                pc=pc,
                sp=int(frame[i, CS["sp"]]),
                ergs=int(frame[i, CS["ergs_remaining"]]),
                depth=int(depth[i, 0]),
                flags=tuple(bool(f) for f in flags[i]),
                timestamp=int(ts[i, 0]),
                instruction=insn,
                asm=disassemble_one(insn) if insn else "<no code>",
                done=bool(done[i, 0]),
                lane_error=bool(err[i, 0]),
                registers=[from_limbs(r) for r in regs[0][i].reshape(-1, 8)]
                if with_registers else None,
            ))
        fused_cycle.run_cycles(state, config, 1)
    return state, traces


def resolve_page(state: BatchedVmState, config: VmConfig, lane: int,
                 page: int):
    """Map a VM page number to its backing device arena for one lane.

    Returns (kind, arena, word_offset, n_words), `arena` the arena as a
    word-major view `[B, W, 8]` of the stored tensor (no copy) and kind in
    {"code", "stack", "heap", "aux_heap"}, or None if the page is not
    materialized on the device.  Reads only the lane's page tables.
    """
    ref = reference_view(state)
    cb_page = ref.cb_page[lane].cpu().numpy().view(np.uint32)
    cb_valid = ref.cb_valid[lane].cpu().numpy()
    for slot in range(config.code_pages):
        if cb_valid[slot] and int(cb_page[slot]) == page:
            return ("code", arena_word_major(ref.code, config),
                    slot * config.code_words, config.code_words)
    hp = ref.hp_page[lane].cpu().numpy().view(np.uint32)
    ap = ref.ap_page[lane].cpu().numpy().view(np.uint32)
    nf = int(state.frame_count[lane])
    for slot in range(min(nf, config.heap_frames)):
        if int(hp[slot]) == page:
            return ("heap", arena_word_major(ref.heap, config),
                    slot * config.heap_words, config.heap_words)
        if int(ap[slot]) == page:
            return ("aux_heap", arena_word_major(ref.aux_heap, config),
                    slot * config.aux_heap_words, config.aux_heap_words)
    # stack pages: frame base + 1 for any frame row (popped rows keep
    # their metadata, so finished lanes still dump)
    bases = ref.cs_scalars[lane, :, CS["base_memory_page"]].cpu().numpy()
    for base in bases.view(np.uint32):
        if int(base) + 1 == page:
            return ("stack", arena_word_major(ref.stack, config), 0,
                    config.stack_words)
    return None


def dump_page_content(state: BatchedVmState, config: VmConfig, lane: int,
                      page: int, start: int = 0,
                      end: int | None = None) -> list[str]:
    """Hex dump of word range [start, end) of a VM page for one lane: one
    64-hex-digit string per 32-byte word, as golden's `dump_page`.
    Unmaterialized pages and words outside the arena dump as zeros (the
    reference's sparse pages read as zero too)."""
    hit = resolve_page(state, config, lane, page)
    if hit is None:
        n = (end if end is not None else start + 1) - start
        return ["0" * 64] * max(n, 0)
    _, arena, off, n_words = hit
    if end is None:
        end = n_words
    lo, hi = max(start, 0), min(end, n_words)
    words = (arena[lane, off + lo:off + hi].cpu().numpy().view(np.uint32)
             if lo < hi else np.zeros((0, 8), dtype=np.uint32))
    return [f"{from_limbs(words[w - lo]):064x}" if lo <= w < hi
            else "0" * 64 for w in range(start, end)]


def dump_full_page(state: BatchedVmState, config: VmConfig, lane: int,
                   page: int) -> list[str]:
    """Whole-page hex dump (golden's dump_full_page counterpart)."""
    return dump_page_content(state, config, lane, page)


def format_trace(trace: list[CycleSnapshot]) -> str:
    """Render one lane's trace as a debugger-style listing."""
    lines = []
    for s in trace:
        mark = "!" if s.lane_error else ("." if s.done else " ")
        fl = "".join(c if f else "-" for c, f in zip("leg", s.flags))
        lines.append(
            f"{mark} c{s.cycle:05d} d{s.depth} pc={s.pc:5d} sp={s.sp:5d} "
            f"ergs={s.ergs:10d} [{fl}] ts={s.timestamp:6d}  {s.asm}")
    return "\n".join(lines)
