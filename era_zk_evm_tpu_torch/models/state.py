"""Batched VM state as a dataclass of torch tensors.

The counterpart of `era_zk_evm_tpu/models/state.py`: the same field names,
dtypes and values, so a JAX state and a port state convert field for field
(`state_from_numpy` / `state_to_numpy`).  u32 fields are carried as
`torch.int32` (torch has no arithmetic on `torch.uint32`), i32 fields as
`torch.int32` and bool fields as `torch.bool`.

Layout.  The reference layout (the JAX package's) puts the lane first,
`[B, ...]`, but for the memory-queue arrays `wq_*`, which are batch-last
(`[Q, ., B]`).  The port stores every array that the K1 kernel indexes by
something other than the lane (a word, a frame, a slot, a queue row) with
the lane LAST: `LANE_LAST_FIELDS`, each the reference array with its lane
axis moved to the end (`[B, n, 8]` -> `[n, 8, B]`).  A kernel that runs one
thread per lane then reads one index across a warp as contiguous memory.
`LANE_AXIS` gives every field's lane axis as stored; the converters
(`state_from_numpy`, `state_to_numpy`) and `reference_view` (views of the
stored tensors in the reference layout, which write through) are the only
places that move the axis, so every comparison against the JAX package
runs on the reference layout.

`empty_state`, `make_entry_state`, `populate_storage` and
`populate_code_bank` build the state in numpy exactly as the JAX package
does, then move it to the device.  Every builder puts the state on the card
(`torch.device("cuda")`) unless the caller asks for another device; without
a card, a CUDA build raises.  Uploads to the card go through pinned memory
and do not wait for the work already queued on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BATCH_LAST_FIELDS, CS, CS_SCALAR_FIELDS, VmConfig
from ..isa import params
from ..isa.abi import FatPointer

#: where the builders put a state unless told otherwise
DEFAULT_DEVICE = torch.device("cuda")

#: JAX int32 fields; every other non-bool field is u32 in the JAX package
I32_FIELDS = frozenset({
    "depth", "frame_count", "dq_count", "global_step", "wq_count",
    "st_count", "j_slot", "j_count", "ev_count", "lq_count", "pq_count",
    "pq_blocks",
})
BOOL_FIELDS = frozenset({
    "reg_ptr", "flags", "pending_exception", "stack_ptr_tag", "cb_valid",
    "done", "lane_error", "st_used", "ev_cancelled",
})


@dataclasses.dataclass
class BatchedVmState:
    # register file
    regs: torch.Tensor               # u32[B, 15, 8]
    reg_ptr: torch.Tensor            # bool[B, 15]
    flags: torch.Tensor              # bool[B, 3]: lt/of, eq, gt
    # local scalars
    timestamp: torch.Tensor          # u32[B]
    monotonic_cycle_counter: torch.Tensor  # u32[B]
    spent_pubdata: torch.Tensor      # u32[B]
    ergs_per_pubdata: torch.Tensor   # u32[B]
    tx_number: torch.Tensor          # u32[B]
    pending_exception: torch.Tensor  # bool[B]
    previous_code_word: torch.Tensor  # u32[B, 8]
    previous_super_pc: torch.Tensor  # u32[B]
    previous_code_page: torch.Tensor  # u32[B]
    context_u128: torch.Tensor       # u32[B, 4]
    # callstack (frames[b, d]; current = d == depth)
    depth: torch.Tensor              # i32[B]
    cs_this_address: torch.Tensor    # u32[B, D, 5]
    cs_msg_sender: torch.Tensor      # u32[B, D, 5]
    cs_code_address: torch.Tensor    # u32[B, D, 5]
    cs_context_u128: torch.Tensor    # u32[B, D, 4]
    cs_scalars: torch.Tensor         # u32[B, D, len(CS_SCALAR_FIELDS)]
    # memory arenas, word-major (stack flat [B, SW*8])
    code: torch.Tensor               # u32[B, P*CW, 8]
    stack: torch.Tensor              # u32[B, SW*8]
    stack_ptr_tag: torch.Tensor      # bool[B, SW]
    heap: torch.Tensor               # u32[B, F*HW, 8]
    aux_heap: torch.Tensor           # u32[B, F*AW, 8]
    hp_page: torch.Tensor            # u32[B, F]
    ap_page: torch.Tensor            # u32[B, F]
    frame_count: torch.Tensor        # i32[B]
    page_counter: torch.Tensor       # u32[B]
    # code bank
    cb_hash: torch.Tensor            # u32[B, P, 8]
    cb_len: torch.Tensor             # u32[B, P]
    cb_page: torch.Tensor            # u32[B, P]
    cb_valid: torch.Tensor           # bool[B, P]
    default_aa_hash: torch.Tensor    # u32[B, 8]
    # decommit-witness queue
    dq_hash: torch.Tensor            # u32[B, DQ, 8]
    dq_meta: torch.Tensor            # u32[B, DQ, 4]
    dq_count: torch.Tensor           # i32[B]
    # rolling memory-queue commitment sponge
    wc_state: torch.Tensor           # u32[B, 25, 2] (or [B, 0, 2])
    wc_count: torch.Tensor           # u32[B]
    # lane status
    done: torch.Tensor               # bool[B]
    lane_error: torch.Tensor         # bool[B]
    global_step: torch.Tensor        # i32[B] — batch-uniform queue clock
    # memory witness queue, batch-last
    wq_count: torch.Tensor           # i32[B]
    wq_meta: torch.Tensor            # u32[Q, 4, B]: timestamp, type, page, index
    wq_value: torch.Tensor           # u32[Q, 8, B]
    wq_flags: torch.Tensor           # u32[Q, B]: bit0 rw, bit1 is_ptr, bit2 valid
    # LOG-family state (zero-size in the ported slice)
    st_key: torch.Tensor             # u32[B, S, 14]
    st_val: torch.Tensor             # u32[B, S, 8]
    st_used: torch.Tensor            # bool[B, S]
    st_count: torch.Tensor           # i32[B]
    j_slot: torch.Tensor             # i32[B, J]
    j_prev: torch.Tensor             # u32[B, J, 8]
    j_count: torch.Tensor            # i32[B]
    ev_key: torch.Tensor             # u32[B, E, 8]
    ev_val: torch.Tensor             # u32[B, E, 8]
    ev_meta: torch.Tensor            # u32[B, E, 2]
    ev_cancelled: torch.Tensor       # bool[B, E]
    ev_count: torch.Tensor           # i32[B]
    lq_meta: torch.Tensor            # u32[B, LQ, 4]
    lq_addr: torch.Tensor            # u32[B, LQ, 5]
    lq_key: torch.Tensor             # u32[B, LQ, 8]
    lq_read: torch.Tensor            # u32[B, LQ, 8]
    lq_written: torch.Tensor         # u32[B, LQ, 8]
    lq_count: torch.Tensor           # i32[B]
    pq_meta: torch.Tensor            # u32[B, PQ, 4]
    pq_value: torch.Tensor           # u32[B, PQ, 8]
    pq_flags: torch.Tensor           # u32[B, PQ]
    pq_count: torch.Tensor           # i32[B]
    pq_blocks: torch.Tensor          # i32[B]


FIELD_NAMES = tuple(f.name for f in dataclasses.fields(BatchedVmState))

#: fields stored lane-last: the reference array with its lane axis (0) moved
#: to the end
LANE_LAST_FIELDS = frozenset({
    "code", "stack", "stack_ptr_tag", "heap", "aux_heap", "hp_page",
    "ap_page",
    "cs_this_address", "cs_msg_sender", "cs_code_address",
    "cs_context_u128", "cs_scalars",
    "st_key", "st_val", "st_used", "cb_hash", "cb_page", "cb_valid",
    "lq_meta", "lq_addr", "lq_key", "lq_read", "lq_written",
    "dq_hash", "dq_meta",
    "j_slot", "j_prev", "ev_key", "ev_val", "ev_meta", "ev_cancelled",
})
#: every field's lane axis as stored (0 first, -1 last); the memory-queue
#: arrays (BATCH_LAST_FIELDS) are lane-last in both layouts
LANE_AXIS = {name: -1 if name in LANE_LAST_FIELDS | set(BATCH_LAST_FIELDS)
             else 0 for name in FIELD_NAMES}


def stored_array(name: str, a: np.ndarray) -> np.ndarray:
    """A reference-layout numpy array in the stored layout (a view)."""
    return np.moveaxis(a, 0, -1) if name in LANE_LAST_FIELDS else a


def reference_array(name: str, t: torch.Tensor) -> torch.Tensor:
    """A stored tensor in the reference layout: a view that writes
    through."""
    return t.movedim(-1, 0) if name in LANE_LAST_FIELDS else t


def stored_shape(name: str, shape: tuple) -> tuple:
    """The stored shape of a field whose reference shape is `shape`."""
    shape = tuple(shape)
    return shape[1:] + shape[:1] if name in LANE_LAST_FIELDS else shape


def _empty_numpy(config: VmConfig) -> dict[str, np.ndarray]:
    """Numpy form of `era_zk_evm_tpu.models.state.empty_state`."""
    B, D = config.batch, config.max_depth
    Q = config.queue_capacity
    R = params.REGISTERS_COUNT

    def z(*shape):
        return np.zeros(shape, dtype=np.uint32)

    def zi(*shape):
        return np.zeros(shape, dtype=np.int32)

    def zb(*shape):
        return np.zeros(shape, dtype=bool)

    S, J, E = config.storage_slots, config.journal_slots, config.event_slots
    LQ, DQ = config.log_queue_capacity, config.decommit_queue_capacity
    PQ, P, F = (config.precompile_queue_capacity, config.code_pages,
                config.heap_frames)
    st = dict(
        regs=z(B, R, 8), reg_ptr=zb(B, R), flags=zb(B, 3),
        timestamp=np.full((B,), params.STARTING_TIMESTAMP, dtype=np.uint32),
        monotonic_cycle_counter=z(B), spent_pubdata=z(B),
        ergs_per_pubdata=z(B), tx_number=z(B), pending_exception=zb(B),
        previous_code_word=z(B, 8), previous_super_pc=z(B),
        previous_code_page=z(B), context_u128=z(B, 4),
        depth=zi(B), cs_this_address=z(B, D, 5), cs_msg_sender=z(B, D, 5),
        cs_code_address=z(B, D, 5), cs_context_u128=z(B, D, 4),
        cs_scalars=z(B, D, len(CS_SCALAR_FIELDS)),
        code=z(B, P * config.code_words, 8),
        stack=z(B, config.stack_words * 8),
        stack_ptr_tag=zb(B, config.stack_words),
        heap=z(B, F * config.heap_words, 8),
        aux_heap=z(B, F * config.aux_heap_words, 8),
        hp_page=z(B, F), ap_page=z(B, F),
        frame_count=np.ones((B,), dtype=np.int32),
        page_counter=np.full((B,), params.STARTING_BASE_PAGE, dtype=np.uint32),
        cb_hash=z(B, P, 8), cb_len=z(B, P), cb_page=z(B, P),
        cb_valid=zb(B, P), default_aa_hash=z(B, 8),
        dq_hash=z(B, DQ, 8), dq_meta=z(B, DQ, 4), dq_count=zi(B),
        wc_state=z(B, 25 if config.rolling_commitment else 0, 2),
        wc_count=z(B), done=zb(B), lane_error=zb(B), global_step=zi(B),
        wq_count=zi(B), wq_meta=z(Q, 4, B), wq_value=z(Q, 8, B),
        wq_flags=z(Q, B),
        st_key=z(B, S, 14), st_val=z(B, S, 8), st_used=zb(B, S),
        st_count=zi(B), j_slot=zi(B, J), j_prev=z(B, J, 8), j_count=zi(B),
        ev_key=z(B, E, 8), ev_val=z(B, E, 8), ev_meta=z(B, E, 2),
        ev_cancelled=zb(B, E), ev_count=zi(B),
        lq_meta=z(B, LQ, 4), lq_addr=z(B, LQ, 5), lq_key=z(B, LQ, 8),
        lq_read=z(B, LQ, 8), lq_written=z(B, LQ, 8), lq_count=zi(B),
        pq_meta=z(B, PQ, 4), pq_value=z(B, PQ, 8), pq_flags=z(B, PQ),
        pq_count=zi(B), pq_blocks=zi(B),
    )
    # root frames: empty context with the initial ergs budget
    st["cs_scalars"][:, 0, CS["sp"]] = params.INITIAL_SP_ON_FAR_CALL
    st["cs_scalars"][:, 0, CS["ergs_remaining"]] = params.VM_INITIAL_FRAME_ERGS
    return st


def to_device(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A tensor on `device` with a copy of `a`.  To the card the copy goes
    through pinned memory without waiting for the work queued there (a
    plain `.to` would synchronise the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def state_from_numpy(arrays: dict,
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> BatchedVmState:
    """Tensors on `device` from numpy arrays keyed by field name (the JAX
    state's fields as `np.asarray`).  u32 data is reinterpreted, not
    converted: the int32 tensor holds the same bits."""
    out = {}
    for name in FIELD_NAMES:
        a = np.asarray(arrays[name])
        if name in BOOL_FIELDS:
            a = a.astype(bool)
        elif a.dtype != np.int32:
            a = a.astype(np.uint32).view(np.int32)
        out[name] = to_device(stored_array(name, a), device)
    return BatchedVmState(**out)


def state_to_numpy(state: BatchedVmState) -> dict[str, np.ndarray]:
    """Numpy arrays in the reference layout, with the JAX state's dtypes
    (u32 fields as uint32)."""
    out = {}
    for name in FIELD_NAMES:
        a = np.ascontiguousarray(reference_array(
            name, getattr(state, name)).detach().cpu().numpy())
        if name not in BOOL_FIELDS and name not in I32_FIELDS:
            a = a.view(np.uint32)
        out[name] = a
    return out


def reference_view(state: BatchedVmState) -> BatchedVmState:
    """The state's tensors as views in the reference layout (lane first but
    for `wq_*`); writes through them land in `state`."""
    return BatchedVmState(**{n: reference_array(n, getattr(state, n))
                             for n in FIELD_NAMES})


def arena_word_major(arr, config: VmConfig):
    """An arena in the reference layout as word-major `[B, W, 8]` (numpy
    or torch; a view): the flat stack `[B, SW*8]` is reshaped, the word
    arenas already are.  The port's copy of the JAX helper, without its
    `limb_major_arenas` branch (the port refuses that layout)."""
    return arr.reshape(arr.shape[0], -1, 8) if arr.ndim == 2 else arr


def clone_state(state: BatchedVmState) -> BatchedVmState:
    return BatchedVmState(**{n: getattr(state, n).clone() for n in FIELD_NAMES})


def empty_state(config: VmConfig,
                device: torch.device | str = DEFAULT_DEVICE) -> BatchedVmState:
    return state_from_numpy(_empty_numpy(config), device)


def _limbs(value: int, n: int = 8) -> np.ndarray:
    return np.array([(value >> (32 * i)) & 0xFFFFFFFF for i in range(n)],
                    dtype=np.uint32)


def make_entry_state(config: VmConfig, programs: list[list[int]],
                     ergs: int = 1 << 27,
                     entry_address: int | list[int] = 0x8001,
                     heap_init: list[list[int]] | None = None,
                     is_static: bool = False,
                     base_page: int = 8,
                     calldata: list[list[int] | None] | None = None,
                     context_u128: int | list[int] = 0,
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> BatchedVmState:
    """Load one bytecode (code-word list) per lane and push a
    bootloader-style entry frame; the same arguments and result as
    `era_zk_evm_tpu.models.state.make_entry_state`."""
    return state_from_numpy(entry_arrays(
        config, programs, ergs, entry_address, heap_init, is_static,
        base_page, calldata, context_u128), device)


def entry_arrays(config: VmConfig, programs: list[list[int]],
                 ergs: int = 1 << 27,
                 entry_address: int | list[int] = 0x8001,
                 heap_init: list[list[int]] | None = None,
                 is_static: bool = False,
                 base_page: int = 8,
                 calldata: list[list[int] | None] | None = None,
                 context_u128: int | list[int] = 0) -> dict[str, np.ndarray]:
    """The numpy arrays of `make_entry_state`, by field name."""
    B = config.batch
    assert len(programs) == B
    st = _empty_numpy(config)

    for b, words in enumerate(programs):
        assert len(words) <= config.code_words, "program exceeds code arena"
        for i, w in enumerate(words):
            st["code"][b, i] = _limbs(w)  # bank slot 0 = the entry program
    st["cb_page"][:, 0] = base_page
    st["cb_valid"][:, 0] = True

    heap = st["heap"]
    if heap_init is not None:
        for b, words in enumerate(heap_init):
            for i, w in enumerate(words):
                heap[b, i] = _limbs(w)
    has_calldata = np.zeros((B,), dtype=bool)
    if calldata is not None:
        assert config.heap_frames >= 2, "calldata needs heap-frame slot 1"
        for b, words in enumerate(calldata):
            if words is None:
                continue
            has_calldata[b] = True
            assert len(words) <= config.heap_words, "calldata exceeds arena"
            for i, w in enumerate(words):
                heap[b, config.heap_words + i] = _limbs(w)
    st["hp_page"][:, 0] = base_page + 2
    st["ap_page"][:, 0] = base_page + 3
    if has_calldata.any():
        # only lanes with calldata get the page binding, the second frame
        # slot and the tagged r1 pointer
        st["hp_page"][has_calldata, 1] = params.BOOTLOADER_CALLDATA_PAGE
        st["frame_count"][has_calldata] = 2
        for b, words in enumerate(calldata):
            if words is None:
                continue
            fp = FatPointer(offset=0,
                            memory_page=params.BOOTLOADER_CALLDATA_PAGE,
                            start=0, length=32 * len(words))
            st["regs"][b, 0] = _limbs(fp.to_u256())
        st["reg_ptr"][:, 0] = has_calldata
    st["page_counter"][:] = max(params.STARTING_BASE_PAGE,
                                base_page + params.NEW_MEMORY_PAGES_PER_FAR_CALL)

    entry_list = ([entry_address] * B if isinstance(entry_address, int)
                  else list(entry_address))
    assert len(entry_list) == B
    addr = np.stack([_limbs(e, 5) for e in entry_list])
    st["cs_this_address"][:, 1] = addr
    st["cs_code_address"][:, 1] = addr
    ctx_list = ([context_u128] * B if isinstance(context_u128, int)
                else list(context_u128))
    assert len(ctx_list) == B
    if any(ctx_list):
        assert all(0 <= c < (1 << 128) for c in ctx_list)
        st["cs_context_u128"][:, 1] = np.stack([_limbs(c, 4) for c in ctx_list])
    sc = st["cs_scalars"]
    sc[:, 1, CS["base_memory_page"]] = base_page
    sc[:, 1, CS["code_page"]] = base_page
    sc[:, 1, CS["sp"]] = params.INITIAL_SP_ON_FAR_CALL
    sc[:, 1, CS["pc"]] = 0
    sc[:, 1, CS["exception_handler"]] = (1 << 16) - 1
    sc[:, 1, CS["ergs_remaining"]] = ergs
    sc[:, 1, CS["flags_word"]] = 1 if is_static else 0
    sc[:, 1, CS["heap_bound"]] = params.NEW_FRAME_MEMORY_STIPEND
    sc[:, 1, CS["aux_heap_bound"]] = params.NEW_FRAME_MEMORY_STIPEND
    # root frame keeps VM_INITIAL_FRAME_ERGS - ergs
    sc[:, 0, CS["ergs_remaining"]] = params.VM_INITIAL_FRAME_ERGS - ergs
    st["depth"][:] = 1
    return st


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy with the JAX dtype (u32 data as uint32)."""
    a = t.detach().cpu().numpy().copy()
    return a if a.dtype == bool else a.view(np.uint32)


def _put(t: torch.Tensor, a: np.ndarray) -> None:
    """Overwrite tensor `t` in place with numpy data of the same bits."""
    if a.dtype != bool:
        a = np.ascontiguousarray(a).astype(np.uint32).view(np.int32)
    t.copy_(to_device(a, t.device))


def populate_code_bank(state: BatchedVmState, config: VmConfig,
                       contracts: list[list[tuple[int, list[int]]]],
                       default_aa_hash: int = 0) -> BatchedVmState:
    """Stage known contracts, in place: contracts[b] = [(stored_code_hash,
    words)], as `era_zk_evm_tpu.models.state.populate_code_bank`.

    Bank slot 0 is the entry program; staged contracts fill slots 1..P-1 and
    get bound to VM page numbers on first decommit (far call).
    """
    ref = reference_view(state)
    B, P = config.batch, config.code_pages
    hashes = np.zeros((B, P, 8), dtype=np.uint32)
    lens = np.zeros((B, P), dtype=np.uint32)
    valid = np.zeros((B, P), dtype=bool)
    code = _to_numpy(ref.code)
    for b, lane in enumerate(contracts):
        assert len(lane) <= P - 1, "code bank full"
        for i, (code_hash, words) in enumerate(lane):
            slot = 1 + i
            hashes[b, slot] = _limbs(code_hash)
            lens[b, slot] = len(words)
            valid[b, slot] = True
            assert len(words) <= config.code_words
            for w_i, w in enumerate(words):
                code[b, slot * config.code_words + w_i] = _limbs(w)
    _put(ref.cb_hash, np.where(valid[:, :, None], hashes,
                               _to_numpy(ref.cb_hash)))
    _put(ref.cb_len, np.where(valid, lens, _to_numpy(ref.cb_len)))
    _put(ref.cb_valid, _to_numpy(ref.cb_valid) | valid)
    _put(ref.code, code)
    _put(ref.default_aa_hash,
         np.broadcast_to(_limbs(default_aa_hash), (B, 8)))
    return state


def storage_key_limbs(shard: int, address: int, key: int) -> np.ndarray:
    """(shard, address, key) -> the 14-limb device storage key."""
    out = np.zeros(14, dtype=np.uint32)
    out[:8] = _limbs(key)
    out[8:13] = _limbs(address, 5)
    out[13] = shard
    return out


def populate_storage(state: BatchedVmState, config: VmConfig,
                     entries: list[list[tuple[int, int, int, int]]]
                     ) -> BatchedVmState:
    """Pre-populate per-lane storage, in place: entries[b] = [(shard,
    address, key, value)], as `era_zk_evm_tpu.models.state.populate_storage`
    (which also replaces every lane's previous storage)."""
    B, S = config.batch, config.storage_slots
    keys = np.zeros((B, S, 14), dtype=np.uint32)
    vals = np.zeros((B, S, 8), dtype=np.uint32)
    used = np.zeros((B, S), dtype=bool)
    counts = np.zeros((B,), dtype=np.int32)
    for b, lane_entries in enumerate(entries):
        assert len(lane_entries) <= S
        for i, (shard, address, key, value) in enumerate(lane_entries):
            keys[b, i] = storage_key_limbs(shard, address, key)
            vals[b, i] = _limbs(value)
            used[b, i] = True
        counts[b] = len(lane_entries)
    ref = reference_view(state)
    _put(ref.st_key, keys)
    _put(ref.st_val, vals)
    _put(ref.st_used, used)
    state.st_count.copy_(to_device(counts, state.st_count.device))
    return state
