"""The dispatcher: chained chunks of the K1 cycle kernel, K2 in rolling mode.

The counterpart of `era_zk_evm_tpu/models/fused_cycle.py::run_cycles_fused`
for the ported slice, storage-enabled configs included (K1 then also reads
and writes the storage, journal, event, code-bank, frame and log / decommit
queue tensors) and the keccak256 / sha256 / ecrecover precompile units.
Where the JAX package detours each ecrecover cycle through its jnp engine
(`_run_cycles_fused_ec`), K1's ecrecover instance runs it in the launch, so
`run_cycles(n)` is one launch per chunk for every config.  `run_cycles`
runs `n_cycles` in chunks of `k_inner`: each chunk is one K1 launch
(`cycle_chunk`) and, with the rolling commitment on, one K2 launch
(`rolling_fold`) over the chunk's records, which K1 writes compacted: each
lane's valid memory-query slots in its first rows, with a count a lane
(`new_slot_block`).  With a precompile queue, K1 writes each cycle's
round-witness rows into a chunk scratch block and `splice_rows` moves them
into the queue at the batch-global block clock, without a host sync: on the
card the splice kernel (csrc/pq_splice.cu), which writes only the blocks
that survive; its plain version is `splice_precompile_rows`, torch ops.

Each wrapper takes its kernel for CUDA tensors and its plain torch version
for CPU tensors: `models/batched_vm.cycle_step` (and
`witness/rolling.compact_slot_rows` for the block) for K1,
`witness/rolling.rolling_absorb_rows` for K2.  On a CUDA tensor a wrapper
launches its kernel or raises; there is no fallback.  `K1_LAUNCHES` and
`K2_LAUNCHES` count kernel launches (never plain-version calls);
`K1_PRECOMPILE_LAUNCHES` and `K1_ECRECOVER_LAUNCHES` count the K1 launches
of the precompile instance (kPrecomp) and of the ecrecover instance (kEc),
`PQ_SPLICE_LAUNCHES` the splice kernel's launches.  `precompile_units` runs
K1's keccak256 / sha256 units alone, a call a thread (the units kernel,
counted in `PRECOMPILE_UNIT_LAUNCHES`), to check and time them apart from
the interpreter; its plain version is `precompile_units_plain`.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..config import (
    CS_SCALAR_FIELDS, SLOTS_PER_CYCLE, VmConfig, check_slice,
    precompile_queue_slots,
)
from ..isa import params
from ..ops.u256 import M32
from ..witness.rolling import compact_slot_rows, rolling_absorb_rows
from . import batched_vm
from .state import BOOL_FIELDS, BatchedVmState, stored_shape

K1_LAUNCHES = 0
K1_PRECOMPILE_LAUNCHES = 0
K1_ECRECOVER_LAUNCHES = 0
K2_LAUNCHES = 0
PQ_SPLICE_LAUNCHES = 0
PRECOMPILE_UNIT_LAUNCHES = 0

# K1's development hooks, the JAX kernel's (era_zk_evm_tpu/models/
# fused_cycle.py:527-544), with its names and semantics.  Each is fixed when
# K1 is compiled, as the JAX ones are when it is traced: while one is set,
# `cycle_chunk` launches K1 from a library of its own, built from K1's
# sources with the hooks as -D flags (`k1_hook_flags`, `_build.load_hooked`);
# no product entry point reads or sets them.  A hooked launch computes wrong
# results by design (tools/ablate_fused.py times them); csrc/cycle_kernel.cu
# says what each does.

#: dev-only output-passthrough set: nv fields forced back to the carried
#: value after _cycle_tile (XLA then DCEs their producers) — liveness-level
#: crash bisection.  "mem" disables the arena ref stores.
#: (K1: a lane field named here keeps its carried value each cycle; "mem"
#: turns the stack, heap and aux-heap stores and the callstack's push
#: stores off.  The names: `K1_PASSTHROUGH_BITS`.)
DEBUG_PASSTHROUGH: frozenset = frozenset()

#: dev-only section-skip set: named heavyweight units replaced by zeros to
#: bisect compile-resource blowups ("mul", "div", "shift", "uma_shift").
#: (K1: also the JAX probes' "stack_rw", "heap_rw", "stack_rw_rt",
#: "stack_st_rt" and "stack_st_off": `K1_SKIP_BITS`.)
DEBUG_SKIP: frozenset = frozenset()

#: dev-only bisect hook: when set to stage N, _cycle_tile returns early after
#: that stage (carry structure preserved; probe value folded into timestamp
#: to keep the truncated computation live).  Used to localize Mosaic crashes.
#: (K1: its cycle returns after the section `K1_STAGES[N]` names.)
DEBUG_STAGE = None

#: DEBUG_SKIP's names, each a bit of K1_SKIP_* (csrc/eravm_gen.h)
K1_SKIP_BITS = {name: 1 << i for i, name in enumerate((
    "mul", "div", "shift", "uma_shift", "stack_rw", "heap_rw", "stack_rw_rt",
    "stack_st_rt", "stack_st_off"))}

#: DEBUG_PASSTHROUGH's names, each a bit of K1_PASS_*: "mem" and the lane
#: fields that K1 writes back (the state's names, as the JAX nv keys)
K1_PASSTHROUGH_BITS = {name: 1 << i for i, name in enumerate((
    "mem", "regs", "reg_ptr", "flags", "timestamp", "monotonic_cycle_counter",
    "ergs_per_pubdata", "tx_number", "pending_exception",
    "previous_code_word", "previous_super_pc", "previous_code_page",
    "context_u128", "depth", "done", "lane_error", "wq_count",
    "spent_pubdata", "page_counter", "st_count", "j_count", "ev_count",
    "lq_count", "dq_count", "frame_count"))}

#: DEBUG_STAGE's stages, the JAX kernel's _stage_cut numbers, in the order
#: of the cycle: the section of K1's lane_cycle that each closes (the table
#: above K1_CUT in csrc/cycle_kernel.cu)
K1_STAGES = {
    0: "frame", 1: "fetch", 11: "decode fields", 12: "price",
    13: "masking", 21: "masked opcode", 22: "src0 address",
    23: "dst0 address", 24: "memory operand reads", 25: "src0 selected",
    26: "src1 + swap", 2: "taint erasure", 3: "ALU", 4: "context + ptr",
    5: "UMA", 6: "log, units, near call, ret", 7: "far call, flags, dst",
    8: "frame machinery", 9: "register writebacks", 10: "memory writebacks",
}

#: the stages that close before K1's first store in an instance without
#: LOG (with it, the log section's stores come before stage 6): a cut there
#: leaves every field of the state as it was but timestamp
K1_STAGES_BEFORE_STORES = tuple(K1_STAGES)[:tuple(K1_STAGES).index(8)]


def k1_hook_flags() -> list[str]:
    """The -D flags of K1's hooked build for the hooks as set now, [] when
    none is.  Raises ValueError on a name or stage that K1 does not have."""
    skip, stage = frozenset(DEBUG_SKIP), DEBUG_STAGE
    passthrough = frozenset(DEBUG_PASSTHROUGH)
    for hook, names, known in (("DEBUG_SKIP", skip, K1_SKIP_BITS),
                               ("DEBUG_PASSTHROUGH", passthrough,
                                K1_PASSTHROUGH_BITS)):
        if names - set(known):
            raise ValueError(f"{hook}: unknown {sorted(names - set(known))}"
                             f"; K1 has {sorted(known)}")
    if stage is not None and stage not in K1_STAGES:
        raise ValueError(f"DEBUG_STAGE: no stage {stage!r}; K1 has "
                         f"{sorted(K1_STAGES)}")
    flags = []
    if skip:
        flags.append(f"-DK1_DEBUG_SKIP={sum(K1_SKIP_BITS[n] for n in skip)}u")
    if stage is not None:
        flags.append(f"-DK1_DEBUG_STAGE={stage}")
    if passthrough:
        flags.append("-DK1_DEBUG_PASSTHROUGH="
                     f"{sum(K1_PASSTHROUGH_BITS[n] for n in passthrough)}u")
    return flags


@contextlib.contextmanager
def k1_hooks(skip=frozenset(), stage=None, passthrough=frozenset()):
    """K1's development hooks set for the block, all reset after it."""
    global DEBUG_SKIP, DEBUG_STAGE, DEBUG_PASSTHROUGH
    DEBUG_SKIP, DEBUG_STAGE = frozenset(skip), stage
    DEBUG_PASSTHROUGH = frozenset(passthrough)
    try:
        yield
    finally:
        DEBUG_SKIP, DEBUG_STAGE = frozenset(), None
        DEBUG_PASSTHROUGH = frozenset()


def k1_library():
    """The library that `cycle_chunk` launches K1 from: `_build.load()`'s,
    or while a hook is set the hooked build's."""
    from .. import _build

    flags = k1_hook_flags()
    return _build.load_hooked(flags) if flags else _build.load()


def precompile_instance(config: VmConfig) -> bool:
    """Whether K1 runs a precompile instance (kPrecomp): the units are on
    when the LOG unit is and `precompile_keccak_blocks > 0`, as in the JAX
    engines."""
    return config.storage_slots > 0 and config.precompile_keccak_blocks > 0


def ecrecover_instance(config: VmConfig) -> bool:
    """Whether K1 runs its fourth instance (kEc), the precompile instance
    with the ecrecover unit."""
    return precompile_instance(config) and config.precompile_ecrecover


def _k1_fields(config: VmConfig) -> list[tuple[str, str, tuple]]:
    """(K1Args field, state field, reference shape) for every state tensor
    K1 reads or writes; K1 takes each in its stored layout
    (`state.stored_shape`)."""
    B, D = config.batch, config.max_depth
    R = params.REGISTERS_COUNT
    P, F = config.code_pages, config.heap_frames
    S, J, E = config.storage_slots, config.journal_slots, config.event_slots
    LQ, DQ = config.log_queue_capacity, config.decommit_queue_capacity
    return [
        ("regs", "regs", (B, R, 8)), ("reg_ptr", "reg_ptr", (B, R)),
        ("flags", "flags", (B, 3)), ("timestamp", "timestamp", (B,)),
        ("mcc", "monotonic_cycle_counter", (B,)),
        ("ergs_per_pubdata", "ergs_per_pubdata", (B,)),
        ("tx_number", "tx_number", (B,)),
        ("pending", "pending_exception", (B,)),
        ("prev_code_word", "previous_code_word", (B, 8)),
        ("prev_super_pc", "previous_super_pc", (B,)),
        ("prev_code_page", "previous_code_page", (B,)),
        ("context_u128", "context_u128", (B, 4)), ("depth", "depth", (B,)),
        ("cs_this", "cs_this_address", (B, D, 5)),
        ("cs_sender", "cs_msg_sender", (B, D, 5)),
        ("cs_code_addr", "cs_code_address", (B, D, 5)),
        ("cs_u128", "cs_context_u128", (B, D, 4)),
        ("cs_scalars", "cs_scalars", (B, D, len(CS_SCALAR_FIELDS))),
        ("code", "code", (B, P * config.code_words, 8)),
        ("stack", "stack", (B, config.stack_words * 8)),
        ("stack_tag", "stack_ptr_tag", (B, config.stack_words)),
        ("heap", "heap", (B, F * config.heap_words, 8)),
        ("aux_heap", "aux_heap", (B, F * config.aux_heap_words, 8)),
        ("hp_page", "hp_page", (B, F)), ("ap_page", "ap_page", (B, F)),
        ("cb_page", "cb_page", (B, P)), ("cb_valid", "cb_valid", (B, P)),
        ("j_count", "j_count", (B,)), ("ev_count", "ev_count", (B,)),
        ("spent_pubdata", "spent_pubdata", (B,)),
        ("st_key", "st_key", (B, S, 14)), ("st_val", "st_val", (B, S, 8)),
        ("st_used", "st_used", (B, S)), ("st_count", "st_count", (B,)),
        ("j_slot", "j_slot", (B, J)), ("j_prev", "j_prev", (B, J, 8)),
        ("ev_key", "ev_key", (B, E, 8)), ("ev_val", "ev_val", (B, E, 8)),
        ("ev_meta", "ev_meta", (B, E, 2)),
        ("ev_cancelled", "ev_cancelled", (B, E)),
        ("lq_meta", "lq_meta", (B, LQ, 4)), ("lq_addr", "lq_addr", (B, LQ, 5)),
        ("lq_key", "lq_key", (B, LQ, 8)), ("lq_read", "lq_read", (B, LQ, 8)),
        ("lq_written", "lq_written", (B, LQ, 8)),
        ("lq_count", "lq_count", (B,)),
        ("dq_hash", "dq_hash", (B, DQ, 8)), ("dq_meta", "dq_meta", (B, DQ, 4)),
        ("dq_count", "dq_count", (B,)), ("cb_hash", "cb_hash", (B, P, 8)),
        ("default_aa_hash", "default_aa_hash", (B, 8)),
        ("frame_count", "frame_count", (B,)),
        ("page_counter", "page_counter", (B,)),
        ("done", "done", (B,)), ("lane_error", "lane_error", (B,)),
        ("global_step", "global_step", (B,)), ("wq_count", "wq_count", (B,)),
    ]


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> ctypes.c_void_p:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype}{list(shape)} on {device}, "
            f"got {t.dtype}{list(t.shape)} on {t.device}")
    return ctypes.c_void_p(t.data_ptr())


def _slot_block_shapes(config: VmConfig, rows: int):
    B = config.batch
    return (rows, 4, B), (rows, 8, B), (rows, B)


def new_slot_block(config: VmConfig, k_cycles: int,
                   device: torch.device | str) -> tuple:
    """Scratch (meta, value, flags, count) for one chunk's memory records:
    K1 writes each lane's valid slots to rows 0 .. count - 1 of [k_cycles *
    8, ., B] and each lane's count to int32[B]; rows past a lane's count
    are left unwritten."""
    shapes = _slot_block_shapes(config, k_cycles * SLOTS_PER_CYCLE)
    return tuple(torch.empty(s, dtype=torch.int32, device=device)
                 for s in shapes + ((config.batch,),))


def _pq_rows_in_kernel(config: VmConfig) -> bool:
    return precompile_instance(config) and config.precompile_queue_capacity > 0


def _pq_block_shapes(config: VmConfig, k_cycles: int):
    ps = sum(precompile_queue_slots(config))
    B = config.batch
    return ((k_cycles, ps, 4, B), (k_cycles, ps, 8, B), (k_cycles, ps, B),
            (k_cycles, B), (k_cycles, B))


def new_pq_block(config: VmConfig, k_cycles: int,
                 device: torch.device | str) -> tuple | None:
    """Scratch (meta, value, flags, emit, nslots) for one chunk's
    round-witness rows, or None when K1 writes none.  K1 writes every
    cycle's emit and nslots rows, and of a lane's block only the rows that
    carry data, which its emit word names (`pq_data_rows`): the splice
    reads nothing else."""
    if not _pq_rows_in_kernel(config):
        return None
    return tuple(torch.empty(s, dtype=torch.int32, device=device)
                 for s in _pq_block_shapes(config, k_cycles))


def pq_data_rows(emit: torch.Tensor, ps: int, ps_in: int) -> torch.Tensor:
    """Which rows of each lane's block carry data, bool [n, PS, B], from
    the emit words int32 [n, B] (csrc/common.cuh, PQ_EMIT): 0 where the
    lane ran no unit, else its n_in mem_in rows (rows 0 .. n_in - 1) in
    the low 16 bits and its n_out mem_out rows (rows PS_IN .. PS_IN +
    n_out - 1) above them."""
    rows = torch.arange(ps, device=emit.device)[None, :, None]
    n_in, n_out = (emit & 0xFFFF)[:, None], (emit >> 16)[:, None]
    return (rows < n_in) | ((rows >= ps_in) & (rows - ps_in < n_out))


def splice_precompile_rows(state: BatchedVmState, config: VmConfig,
                           pq_block: tuple, n: int) -> None:
    """Move the round-witness rows of a chunk's first n cycles from
    `pq_block` into the state's precompile queue, in place.

    The queue's block clock is batch-global: a cycle in which any lane ran
    a unit is flagged, and flagged cycles take consecutive blocks of PS
    rows from `pq_blocks`.  As in the JAX engine, every cycle writes the
    block at min(pos * PS, cap - PS) (all zero rows unless it is flagged and
    fits), a cycle whose block would pass the capacity drops its rows, sets
    `lane_error` on its emitting lanes and credits them no `pq_count`, and
    the clock advances by the flagged cycles.  One block is written a
    position, the last cycle's there, and the clamped block (at cap - PS)
    after the others, so that where cap - PS is no multiple of PS it
    overwrites the block it overlaps, as the engine's cycle-after-cycle
    writes do.  Of a kept block only the rows that carry data are read
    (`pq_data_rows`); its other rows are written as zeros, whatever the
    scratch holds there.  The splice kernel's plain version
    (`splice_rows`): torch ops, with a host sync on a CUDA state."""
    meta, value, flags, emit, nslots = (x[:n] for x in pq_block)
    B, ps = config.batch, meta.shape[1]
    cap = config.precompile_queue_capacity
    data = pq_data_rows(emit, ps, precompile_queue_slots(config)[0])
    emitting = emit != 0                                   # [n, B]
    flagged = emitting.any(1).to(torch.int64)              # [n]
    pos = state.pq_blocks.min().to(torch.int64) + torch.cumsum(flagged, 0) \
        - flagged
    overflow = pos * ps > cap - ps
    base = torch.clamp(pos * ps, max=cap - ps)
    is_last = torch.ones_like(overflow)                    # last at its base
    is_last[:-1] = base[1:] != base[:-1]
    keep = data & ~overflow[:, None, None]                 # [n, PS, B]
    clamped = base == cap - ps
    for sel in (is_last & ~clamped, is_last & clamped):
        c = sel.nonzero()[:, 0]
        m = c.numel() * ps
        rows = (base[c, None] + torch.arange(ps, device=base.device)) \
            .reshape(-1)
        kc = keep[c]
        state.pq_meta[:, rows] = (meta[c] * kc[:, :, None, :]) \
            .permute(3, 0, 1, 2).reshape(B, m, 4)
        state.pq_value[:, rows] = (value[c] * kc[:, :, None, :]) \
            .permute(3, 0, 1, 2).reshape(B, m, 8)
        state.pq_flags[:, rows] = (flags[c] * kc) \
            .permute(2, 0, 1).reshape(B, m)
    state.lane_error |= (emitting & overflow[:, None]).any(0)
    state.pq_count += (nslots * ~overflow[:, None]).sum(0, dtype=torch.int32)
    state.pq_blocks += flagged.sum().to(torch.int32)


def splice_args(state: BatchedVmState, config: VmConfig, pq_block: tuple,
                n: int, scratch: torch.Tensor):
    """The SpliceArgs struct of one splice (csrc/pq_splice.cu) of the first
    n cycles of `pq_block` into the state's queue, after checking every
    tensor's device, dtype, shape and contiguity; `scratch` is the
    kernels' int32 scratch (the flag blocks' partials and the table),
    `eravm_pq_splice_scratch(B, n, PS)` words."""
    from .._build import SpliceArgs

    B, cap = config.batch, config.precompile_queue_capacity
    K, ps = pq_block[0].shape[:2]
    if not 0 < n <= min(K, 128) or cap < ps:
        raise ValueError(f"splice of {n} cycles of a {K}-cycle block into "
                         f"{cap} rows of blocks of {ps}: needs 0 < n <= "
                         f"min(K, 128) and cap >= PS")
    device = state.done.device
    args = SpliceArgs()
    for name, t, shape in zip(
            ("meta_blk", "value_blk", "flags_blk", "emit", "nslots"),
            pq_block, _pq_block_shapes(config, K)):
        setattr(args, name, _check(t, name, shape, torch.int32, device))
    for name, shape, dtype in (
            ("pq_meta", (B, cap, 4), torch.int32),
            ("pq_value", (B, cap, 8), torch.int32),
            ("pq_flags", (B, cap), torch.int32),
            ("pq_count", (B,), torch.int32), ("pq_blocks", (B,), torch.int32),
            ("lane_error", (B,), torch.bool)):
        setattr(args, name, _check(getattr(state, name), name, shape, dtype,
                                   device))
    args.scratch = _check(scratch, "scratch", tuple(scratch.shape),
                          torch.int32, device)
    args.n, args.ps, args.cap, args.batch = n, ps, cap, B
    args.ps_in = precompile_queue_slots(config)[0]
    return args


def splice_rows(state: BatchedVmState, config: VmConfig, pq_block: tuple,
                n: int) -> None:
    """`splice_precompile_rows`, in place: the splice kernel on a CUDA state
    (two launches on the current stream, no host sync; the two kernels of
    one device's splices must run in stream order), the plain version on a
    CPU state."""
    global PQ_SPLICE_LAUNCHES
    device = state.done.device
    if device.type == "cpu":
        splice_precompile_rows(state, config, pq_block, n)
        return
    if device.type != "cuda":
        raise ValueError(f"no splice kernel for device {device}")
    from .._build import load

    lib = load()
    scratch = torch.empty(lib.eravm_pq_splice_scratch(
        config.batch, n, pq_block[0].shape[1]), dtype=torch.int32,
        device=device)
    args = splice_args(state, config, pq_block, n, scratch)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.eravm_pq_splice_launch(ctypes.byref(args),
                                    ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"splice launch failed: cudaError {rc}")
    PQ_SPLICE_LAUNCHES += 1


def _check_units(config: VmConfig, arena: torch.Tensor,
                 call: torch.Tensor) -> None:
    n = call.shape[0]
    if config.precompile_keccak_blocks <= 0:
        raise ValueError("the units need precompile_keccak_blocks > 0")
    for name, t, dims in (("arena", arena, 3), ("call", call, 2)):
        if t.dtype != torch.int32 or t.dim() != dims \
                or not t.is_contiguous() or t.device != call.device:
            raise ValueError(f"{name}: expected contiguous int32 of {dims} "
                             f"dims on {call.device}, got {t.dtype}"
                             f"{list(t.shape)} on {t.device}")
    if call.shape[1] != 5 or arena.shape[1:] != (8, n):
        raise ValueError(f"expected call [n, 5] and arena [words, 8, n], got "
                         f"{list(call.shape)} and {list(arena.shape)}")


def precompile_units_plain(config: VmConfig, arena: torch.Tensor,
                           call: torch.Tensor) -> tuple:
    """The keccak256 / sha256 units of the plain engine (`batched_vm`'s
    sponge and compression over `ops/keccak.py`'s and `ops/sha256.py`'s
    batched permutation and compression), a call a lane, with
    `precompile_units`' arguments and results."""
    _check_units(config, arena, call)
    n, n_words = call.shape[0], arena.shape[0]
    c = call.to(torch.int64) & M32
    kind, base, in_off, in_len, rounds = c.unbind(1)
    words = arena.permute(2, 0, 1).to(torch.int64) & M32
    lanes = torch.arange(n, device=call.device)

    def word(idx):
        i = (base + idx) & M32
        inside = i < n_words
        return words[lanes, torch.where(inside, i, 0)] * inside[:, None]

    mk = config.precompile_keccak_blocks
    ms = max(config.precompile_sha_rounds, 1)
    is_sha = kind != 0
    kc_blocks = in_len // 136 + 1
    out = torch.where(
        is_sha[:, None],
        batched_vm._sha_unit(word, ms, is_sha, in_off, rounds),
        batched_vm._keccak_unit(word, mk, ~is_sha, in_off, in_len, kc_blocks,
                                (kc_blocks * 136 - 1) & M32))
    err = torch.where(is_sha, rounds > ms, kc_blocks > mk)
    return out, err


def precompile_units(config: VmConfig, arena: torch.Tensor,
                     call: torch.Tensor) -> tuple:
    """K1's keccak256 / sha256 precompile units alone, a call a lane, with
    the config's limits (`precompile_keccak_blocks`, `precompile_sha_rounds`)
    and window (PS_IN words): lane i reads word `idx` of its frame as word
    base + idx (u32) of its column of `arena` (int32 [n_words, 8, n],
    lane-last like K1's heap; zeros past n_words), and `call` (int32 [n, 5])
    holds (kind: 0 keccak256, 1 sha256; base; in_off; in_len; rounds), the
    precompile ABI's fields.  Returns the output words (int64 [n, 8], u32
    limbs) and whether each call sets lane_error for the units' limits.  On
    CUDA tensors the units kernel (csrc/cycle_kernel_ec.cu), on CPU tensors
    `precompile_units_plain`."""
    global PRECOMPILE_UNIT_LAUNCHES
    if call.device.type == "cpu":
        return precompile_units_plain(config, arena, call)
    if call.device.type != "cuda":
        raise ValueError(f"no units kernel for device {call.device}")
    from .._build import UnitsArgs, load

    _check_units(config, arena, call)
    n = call.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=call.device)
    err = torch.empty((n,), dtype=torch.int32, device=call.device)
    args = UnitsArgs(arena.data_ptr(), call.data_ptr(), out.data_ptr(),
                     err.data_ptr(), n, arena.shape[0],
                     config.precompile_keccak_blocks,
                     config.precompile_sha_rounds,
                     precompile_queue_slots(config)[0])
    stream = torch.cuda.current_stream(call.device).cuda_stream
    rc = load().eravm_units_launch(ctypes.byref(args),
                                   ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"units launch failed: cudaError {rc}")
    PRECOMPILE_UNIT_LAUNCHES += 1
    return out.to(torch.int64) & M32, err != 0


def k1_args(state: BatchedVmState, config: VmConfig, k_cycles: int, n: int,
            block: tuple | None, step0: torch.Tensor,
            pq_block: tuple | None = None):
    """The K1Args struct for one launch, after checking every tensor's
    device, dtype, shape and contiguity.  `step0` is a 0-dim int32 tensor
    holding min(global_step), read by the kernel; `pq_block` is the
    round-witness scratch (`new_pq_block`) when K1 writes one."""
    from .._build import K1Args

    device = state.done.device
    args = K1Args()
    for arg_name, field, shape in _k1_fields(config):
        dtype = torch.bool if field in BOOL_FIELDS else torch.int32
        setattr(args, arg_name, _check(getattr(state, field), field,
                                       stored_shape(field, shape), dtype,
                                       device))
    # the persistent queue (its zero-row tensors when it is off), and the
    # chunk's record block in rolling mode (the queue's tensors and
    # wq_count stand in for it when it is off: K1 then never touches them)
    queue = (state.wq_meta, state.wq_value, state.wq_flags)
    blk = queue + (state.wq_count,)
    if config.rolling_commitment:
        if block is None or block[0].shape[0] < n * SLOTS_PER_CYCLE:
            raise ValueError("rolling mode needs a slot block as long as "
                             "the chunk")
        blk = block
    for prefix, q, rows in (("q", queue, config.queue_capacity),
                            ("blk", blk, blk[0].shape[0])):
        shapes = _slot_block_shapes(config, rows) + ((config.batch,),)
        for part, t, shape in zip(("meta", "value", "flags", "count"), q,
                                  shapes):
            setattr(args, f"{prefix}_{part}",
                    _check(t, f"{prefix}_{part}", shape, torch.int32, device))
    args.step0 = ctypes.c_void_p(step0.data_ptr())
    if _pq_rows_in_kernel(config) != (pq_block is not None):
        raise ValueError("the round-witness scratch block is needed exactly "
                         "when K1 runs the precompile units with a queue")
    if pq_block is not None:
        if pq_block[0].shape[0] < n:
            raise ValueError("round-witness block shorter than the chunk")
        shapes = _pq_block_shapes(config, pq_block[0].shape[0])
        for arg_name, t, shape in zip(
                ("pq_meta_blk", "pq_value_blk", "pq_flags_blk", "pq_emit_blk",
                 "pq_nslots_blk"), pq_block, shapes):
            setattr(args, arg_name, _check(t, arg_name, shape, torch.int32,
                                           device))
    args.keccak_blocks = config.precompile_keccak_blocks
    args.sha_rounds = config.precompile_sha_rounds
    args.pq_slots_in = precompile_queue_slots(config)[0]
    args.pq_capacity = config.precompile_queue_capacity
    args.batch = config.batch
    args.max_depth = config.max_depth
    args.code_words = config.code_words
    args.code_pages = config.code_pages
    args.stack_words = config.stack_words
    args.stack_abs_words = (-1 if config.stack_abs_words is None
                            else config.stack_abs_words)
    args.stack_sp_base = config.stack_sp_base
    args.heap_words = config.heap_words
    args.aux_heap_words = config.aux_heap_words
    args.heap_frames = config.heap_frames
    args.queue_capacity = config.queue_capacity
    args.storage_slots = config.storage_slots
    args.journal_slots = config.journal_slots
    args.event_slots = config.event_slots
    args.log_queue_capacity = config.log_queue_capacity
    args.decommit_queue_capacity = config.decommit_queue_capacity
    args.emit_queue = int(config.queue_capacity > 0)
    args.emit_block = int(config.rolling_commitment)
    args.k_cycles = k_cycles
    args.k_stop = n
    return args


def k1_threads(batch: int) -> int:
    """The block size K1's launches take at `batch` lanes on this card (its
    grid spans every SM: csrc/cycle_kernel.cu, k1_block_threads)."""
    from .._build import load

    return load().eravm_k1_threads(batch)


def cycle_chunk(state: BatchedVmState, config: VmConfig, k_cycles: int,
                k_stop: int | None = None, block: tuple | None = None,
                pq_block: tuple | None = None) -> BatchedVmState:
    """K1: run min(k_cycles, k_stop) cycles of every lane, in place.

    With the memory queue on (mode a), each cycle's 8 memory-query slots go
    into the persistent queue (`wq_*`); with the rolling commitment on
    (mode b, beside the queue or alone), each lane's valid slots also go,
    compacted, to `block` (see `new_slot_block`) for `rolling_fold`: on a
    CPU state the plain engine writes the chunk's dense slot rows and
    `compact_slot_rows` compacts them into `block`.  With the precompile
    units and their queue, the round-witness rows go through `pq_block`
    (allocated here when not given) and the splice kernel (`splice_rows`).
    """
    global K1_LAUNCHES, K1_PRECOMPILE_LAUNCHES, K1_ECRECOVER_LAUNCHES
    check_slice(config)
    n = k_cycles if k_stop is None else min(k_cycles, k_stop)
    if config.rolling_commitment and block is None:
        raise ValueError("rolling mode needs a slot block")
    device = state.done.device
    if device.type == "cpu":
        if k1_hook_flags():
            raise ValueError("K1's development hooks change K1, which runs "
                             "on a CUDA state; the plain engine has none")
        dense = None if block is None else tuple(
            torch.empty(s, dtype=torch.int32)
            for s in _slot_block_shapes(config, n * SLOTS_PER_CYCLE))
        for c in range(n):
            rows = None if dense is None else tuple(
                x[c * SLOTS_PER_CYCLE:(c + 1) * SLOTS_PER_CYCLE]
                for x in dense)
            batched_vm.cycle_step(state, config, rows)
        if dense is not None:
            for dst, src in zip(block, compact_slot_rows(*dense)):
                dst[:src.shape[0]] = src
        return state
    if device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {device}")

    if pq_block is None:
        pq_block = new_pq_block(config, n, device)
    step0 = state.global_step.min()   # stays on the device: no host sync
    args = k1_args(state, config, k_cycles, n, block, step0, pq_block)
    stream = torch.cuda.current_stream(device).cuda_stream
    ec = ecrecover_instance(config)
    rc = k1_library().eravm_k1_launch(ctypes.byref(args), ec,
                                      ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    K1_LAUNCHES += 1
    K1_PRECOMPILE_LAUNCHES += precompile_instance(config) and not ec
    K1_ECRECOVER_LAUNCHES += ec
    if pq_block is not None:
        splice_rows(state, config, pq_block, n)
    return state


def rolling_fold(wc_state: torch.Tensor, wc_count: torch.Tensor,
                 block: tuple) -> None:
    """K2: fold each lane's records of `block` (`new_slot_block`, as K1
    wrote it: rows 0 .. count[b] - 1 of lane b) into the sponges, in
    place."""
    global K2_LAUNCHES
    device = wc_state.device
    if device.type == "cpu":
        rolling_absorb_rows(wc_state, wc_count, *block)
        return
    if device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {device}")
    from .._build import load

    B, rows = wc_state.shape[0], block[0].shape[0]
    shapes = ((rows, 4, B), (rows, 8, B), (rows, B), (B,), (B, 25, 2), (B,))
    names = ("meta", "value", "flags", "count", "wc_state", "wc_count")
    ptrs = [_check(t, name, shape, torch.int32, device)
            for t, name, shape in zip(tuple(block) + (wc_state, wc_count),
                                      names, shapes)]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load().eravm_k2_launch(*ptrs, rows, B, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    K2_LAUNCHES += 1


def run_cycles(state: BatchedVmState, config: VmConfig, n_cycles: int,
               k_inner: int = 128) -> BatchedVmState:
    """Advance all lanes by n_cycles, in place, in chunks of k_inner.

    The drop-in counterpart of `run_cycles_fused`: on a CUDA state every
    chunk is a K1 launch (and a K2 launch in rolling mode); on a CPU state
    the same chunks run the plain versions.  Any `n_cycles` runs the same
    kernel, so this also serves the scheduler's dynamic-length chunks.
    """
    check_slice(config)
    device = state.done.device
    block = pq_block = None
    if config.rolling_commitment:
        block = new_slot_block(config, min(k_inner, n_cycles), device)
    if device.type == "cuda":
        pq_block = new_pq_block(config, min(k_inner, n_cycles), device)
    done = 0
    while done < n_cycles:
        k = min(k_inner, n_cycles - done)
        cycle_chunk(state, config, k, k, block, pq_block)
        if block is not None:
            rolling_fold(state.wc_state, state.wc_count, block)
        done += k
    return state
