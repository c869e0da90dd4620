"""The dispatcher: chained chunks of the K1 cycle kernel, and K2 in mode (b).

The counterpart of `era_zk_evm_tpu/models/fused_cycle.py::run_cycles_fused`
for the ported slice, storage-enabled configs included (K1 then also reads
and writes the storage, journal, event, code-bank, frame and log / decommit
queue tensors) and the keccak256 / sha256 / ecrecover precompile units.
Where the JAX package detours each ecrecover cycle through its jnp engine
(`_run_cycles_fused_ec`), K1's ecrecover instance runs it in the launch, so
`run_cycles(n)` is one launch per chunk for every config.  `run_cycles`
runs `n_cycles` in chunks of `k_inner`: each chunk is one K1 launch
(`cycle_chunk`) and, with the rolling commitment on, one K2 launch
(`rolling_fold`) over the chunk's slot block.  With a precompile queue, K1
writes each cycle's round-witness rows into a chunk scratch block and
`splice_precompile_rows` moves them into the queue at the batch-global
block clock, in torch ops on the device, without a host sync.

Each wrapper takes its kernel for CUDA tensors and its plain torch version
for CPU tensors: `models/batched_vm.cycle_step` for K1,
`witness/rolling.rolling_absorb` for K2.  On a CUDA tensor a wrapper
launches its kernel or raises; there is no fallback.  `K1_LAUNCHES` and
`K2_LAUNCHES` count kernel launches (never plain-version calls);
`K1_PRECOMPILE_LAUNCHES` and `K1_ECRECOVER_LAUNCHES` count the K1 launches
of the precompile instance (kPrecomp) and of the ecrecover instance (kEc).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import (
    CS_SCALAR_FIELDS, SLOTS_PER_CYCLE, VmConfig, check_slice,
    precompile_queue_slots,
)
from ..isa import params
from ..witness.rolling import rolling_absorb
from . import batched_vm
from .state import BOOL_FIELDS, BatchedVmState

K1_LAUNCHES = 0
K1_PRECOMPILE_LAUNCHES = 0
K1_ECRECOVER_LAUNCHES = 0
K2_LAUNCHES = 0


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
    """(K1Args field, state field, shape) for every state tensor K1 reads
    or writes."""
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
    """Scratch (meta, value, flags) for one chunk's memory-query slots."""
    return tuple(torch.empty(s, dtype=torch.int32, device=device)
                 for s in _slot_block_shapes(config,
                                             k_cycles * SLOTS_PER_CYCLE))


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
    cycle's emit and nslots rows, and row blocks only where a lane emits:
    the splice reads nothing else."""
    if not _pq_rows_in_kernel(config):
        return None
    return tuple(torch.empty(s, dtype=torch.int32, device=device)
                 for s in _pq_block_shapes(config, k_cycles))


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
    the clock advances by the flagged cycles.  Cycles that share a block
    position all write the rows of the last of them, so the scatter's
    duplicates agree.  Torch ops on the state's device; nothing waits for
    the host."""
    meta, value, flags, emit, nslots = (x[:n] for x in pq_block)
    B, ps = config.batch, meta.shape[1]
    cap = config.precompile_queue_capacity
    emitting = emit != 0                                   # [n, B]
    flagged = emitting.any(1).to(torch.int64)              # [n]
    pos = state.pq_blocks.min().to(torch.int64) + torch.cumsum(flagged, 0) \
        - flagged
    overflow = pos * ps > cap - ps
    base = torch.clamp(pos * ps, max=cap - ps)
    last = torch.searchsorted(base, base, right=True) - 1  # last cycle at base
    keep = (emitting & ~overflow[:, None])[last]           # [n, B]
    rows = (base[:, None] + torch.arange(ps, device=base.device)).reshape(-1)
    state.pq_meta[:, rows] = (meta[last] * keep[:, None, None, :]) \
        .permute(3, 0, 1, 2).reshape(B, n * ps, 4)
    state.pq_value[:, rows] = (value[last] * keep[:, None, None, :]) \
        .permute(3, 0, 1, 2).reshape(B, n * ps, 8)
    state.pq_flags[:, rows] = (flags[last] * keep[:, None, :]) \
        .permute(2, 0, 1).reshape(B, n * ps)
    state.lane_error |= (emitting & overflow[:, None]).any(0)
    state.pq_count += (nslots * ~overflow[:, None]).sum(0, dtype=torch.int32)
    state.pq_blocks += flagged.sum().to(torch.int32)


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
        setattr(args, arg_name, _check(getattr(state, field), field, shape,
                                       dtype, device))
    if config.queue_capacity > 0:
        q, emit = (state.wq_meta, state.wq_value, state.wq_flags), 1
        shapes = _slot_block_shapes(config, config.queue_capacity)
    elif config.rolling_commitment:
        q, emit = block, 2
        shapes = _slot_block_shapes(config, block[0].shape[0])
        if block[0].shape[0] < n * SLOTS_PER_CYCLE:
            raise ValueError("slot block shorter than the chunk")
    else:
        q, emit = (state.wq_meta, state.wq_value, state.wq_flags), 0
        shapes = _slot_block_shapes(config, 0)
    for arg_name, t, shape in zip(("q_meta", "q_value", "q_flags"), q, shapes):
        setattr(args, arg_name, _check(t, arg_name, shape, torch.int32,
                                       device))
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
    args.emit_mode = emit
    args.k_cycles = k_cycles
    args.k_stop = n
    return args


def cycle_chunk(state: BatchedVmState, config: VmConfig, k_cycles: int,
                k_stop: int | None = None, block: tuple | None = None,
                pq_block: tuple | None = None) -> BatchedVmState:
    """K1: run min(k_cycles, k_stop) cycles of every lane, in place.

    Mode (a) writes each cycle's 8 memory-query slots into the persistent
    queue (`wq_*`); mode (b) writes them to rows `c * 8` of `block` (see
    `new_slot_block`) for `rolling_fold`.  With the precompile units and
    their queue, the round-witness rows go through `pq_block` (allocated
    here when not given) and `splice_precompile_rows`.
    """
    global K1_LAUNCHES, K1_PRECOMPILE_LAUNCHES, K1_ECRECOVER_LAUNCHES
    check_slice(config)
    n = k_cycles if k_stop is None else min(k_cycles, k_stop)
    if config.rolling_commitment and block is None:
        raise ValueError("rolling mode needs a slot block")
    device = state.done.device
    if device.type == "cpu":
        for c in range(n):
            rows = None if block is None else tuple(
                x[c * SLOTS_PER_CYCLE:(c + 1) * SLOTS_PER_CYCLE]
                for x in block)
            batched_vm.cycle_step(state, config, rows)
        return state
    if device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {device}")

    from .._build import load

    if pq_block is None:
        pq_block = new_pq_block(config, n, device)
    step0 = state.global_step.min()   # stays on the device: no host sync
    args = k1_args(state, config, k_cycles, n, block, step0, pq_block)
    stream = torch.cuda.current_stream(device).cuda_stream
    ec = ecrecover_instance(config)
    rc = load().eravm_k1_launch(ctypes.byref(args), ec,
                                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    K1_LAUNCHES += 1
    K1_PRECOMPILE_LAUNCHES += precompile_instance(config) and not ec
    K1_ECRECOVER_LAUNCHES += ec
    if pq_block is not None:
        splice_precompile_rows(state, config, pq_block, n)
    return state


def rolling_fold(wc_state: torch.Tensor, wc_count: torch.Tensor,
                 block: tuple, n_rows: int) -> None:
    """K2: fold the first `n_rows` slots of `block` into the sponges, in
    place."""
    global K2_LAUNCHES
    meta, value, flags = (x[:n_rows] for x in block)
    device = wc_state.device
    if device.type == "cpu":
        rolling_absorb(wc_state, wc_count, meta, value, flags)
        return
    if device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {device}")
    from .._build import load

    B = wc_state.shape[0]
    ptrs = [_check(wc_state, "wc_state", (B, 25, 2), torch.int32, device),
            _check(wc_count, "wc_count", (B,), torch.int32, device)]
    ptrs = [_check(t, name, (n_rows,) + tuple(t.shape[1:]), torch.int32,
                   device)
            for t, name in ((meta, "meta"), (value, "value"),
                            (flags, "flags"))] + ptrs
    if tuple(meta.shape[1:]) != (4, B) or tuple(value.shape[1:]) != (8, B) \
            or tuple(flags.shape[1:]) != (B,):
        raise ValueError("slot block does not match the batch")
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load().eravm_k2_launch(*ptrs, n_rows, B, ctypes.c_void_p(stream))
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
            rolling_fold(state.wc_state, state.wc_count, block,
                         k * SLOTS_PER_CYCLE)
        done += k
    return state
