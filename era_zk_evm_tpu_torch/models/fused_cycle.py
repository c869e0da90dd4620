"""The dispatcher: chained chunks of the K1 cycle kernel, and K2 in mode (b).

The counterpart of `era_zk_evm_tpu/models/fused_cycle.py::run_cycles_fused`
for the ported slice, storage-enabled configs included (K1 then also reads
and writes the storage, journal, event, code-bank, frame and log / decommit
queue tensors).  `run_cycles` runs `n_cycles` in chunks of `k_inner`:
each chunk is one K1 launch (`cycle_chunk`) and, with the rolling
commitment on, one K2 launch (`rolling_fold`) over the chunk's slot block.

Each wrapper takes its kernel for CUDA tensors and its plain torch version
for CPU tensors: `models/batched_vm.cycle_step` for K1,
`witness/rolling.rolling_absorb` for K2.  On a CUDA tensor a wrapper
launches its kernel or raises; there is no fallback.  `K1_LAUNCHES` and
`K2_LAUNCHES` count kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import CS_SCALAR_FIELDS, SLOTS_PER_CYCLE, VmConfig, check_slice
from ..isa import params
from ..witness.rolling import rolling_absorb
from . import batched_vm
from .state import BOOL_FIELDS, BatchedVmState

K1_LAUNCHES = 0
K2_LAUNCHES = 0


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


def k1_args(state: BatchedVmState, config: VmConfig, k_cycles: int, n: int,
            block: tuple | None, step0: torch.Tensor):
    """The K1Args struct for one launch, after checking every tensor's
    device, dtype, shape and contiguity.  `step0` is a 0-dim int32 tensor
    holding min(global_step), read by the kernel."""
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
                k_stop: int | None = None,
                block: tuple | None = None) -> BatchedVmState:
    """K1: run min(k_cycles, k_stop) cycles of every lane, in place.

    Mode (a) writes each cycle's 8 memory-query slots into the persistent
    queue (`wq_*`); mode (b) writes them to rows `c * 8` of `block` (see
    `new_slot_block`) for `rolling_fold`.
    """
    global K1_LAUNCHES
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

    step0 = state.global_step.min()   # stays on the device: no host sync
    args = k1_args(state, config, k_cycles, n, block, step0)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load().eravm_k1_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    K1_LAUNCHES += 1
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
    the same chunks run the plain versions.
    """
    check_slice(config)
    block = None
    if config.rolling_commitment:
        block = new_slot_block(config, min(k_inner, n_cycles),
                               state.done.device)
    done = 0
    while done < n_cycles:
        k = min(k_inner, n_cycles - done)
        cycle_chunk(state, config, k, k, block)
        if block is not None:
            rolling_fold(state.wc_state, state.wc_count, block,
                         k * SLOTS_PER_CYCLE)
        done += k
    return state
