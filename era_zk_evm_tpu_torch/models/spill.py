"""Spill-to-host protocols: bounded device arenas for unbounded executions.

The port of `era_zk_evm_tpu/models/spill.py`.  Every protocol runs BETWEEN
`run_cycles` segments (the cycle step itself never talks to the host):

1. **Witness-queue draining** (`drain_witness_queues`, `rewind_queues`):
   the dense memory / log / decommit / precompile queues are
   block-positioned by the block clock, so draining reads their contents
   to host query structs and rewinds the clock, and a queue sized for one
   segment serves an unbounded run.  Concatenating per-segment drains
   gives the one-shot stream.
2. **Callstack spill** (`normalize_callstack`, `run_segments`): frames
   below the working window move to host storage when a lane's depth
   nears `max_depth`, and back before the window underflows.
3. **Storage-KV spill** (`spill_storage_kv`, `rehydrate_keys`,
   `run_segments_storage`): the device KV table is a cache of the block's
   storage map; evicted entries live in a host map, and a segment that
   touches an evicted key is replayed from a snapshot after rehydration.
4. **Heap-frame reclamation** (`reclaim_heap_frames`): dead heap / aux-heap
   frame slots are dropped by tag-based liveness and the pool compacts.
5. **Code-bank eviction** (`spill_code_bank`, `rehydrate_code`,
   `run_segments_decommit`): the same evict / detect / replay shape for
   the code bank, keyed by the stored-form code hash.

The protocols' semantics are the JAX module's, field for field and map
for map (`tests/test_torch_spill.py`); the JAX module's comments give the
reasons for each rule.  What differs is how they touch the state.  The
port stores every field these steps touch lane-last (`state.
LANE_LAST_FIELDS`), and the steps work on the reference-layout views of
`state.reference_view`, in torch ops on the state's own device, all lanes
at once; a step copies to the host only what moves there (spilled frames,
evicted entries) and the few columns that a per-key loop reads, and it
writes in place.  The port's engines update their state in place, so a
segment that may be replayed runs on `clone_state` of its snapshot.

The segment loops find cold touches with `_touched_in_log_queue`, which
reads the log queue's packed records with numpy and builds the same key
and hash sets, in the same order, as the stream detectors `_touched_*`
build from `device_log_streams` (the JAX loops' way, and the reference
the tests hold it to): at block width the query structs cost seconds an
attempt.

u32 data is carried as `torch.int32`: a host-map key is built from a
`np.uint32` view, or a limb with bit 31 set would never match the
detectors' keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CS, VmConfig
from ..isa import params
from ..utils import to_limbs
from .compaction import _stable_filter, compact_log_state
from .state import (
    BatchedVmState, arena_word_major, clone_state, reference_view,
    storage_key_limbs, to_device,
)

CS_ARRAYS = ("cs_this_address", "cs_msg_sender", "cs_code_address",
             "cs_context_u128", "cs_scalars")

#: the witness-queue tensors and their clocks, which a rewind zeroes
QUEUE_FIELDS = (
    "global_step",                                   # the block clock
    "wq_count", "wq_meta", "wq_value", "wq_flags",
    "lq_count", "lq_meta", "lq_addr", "lq_key", "lq_read", "lq_written",
    "dq_count", "dq_hash", "dq_meta",
    "pq_count", "pq_blocks", "pq_meta", "pq_value", "pq_flags",
)


def _host(t: torch.Tensor) -> np.ndarray:
    """A private host copy of a tensor."""
    return t.detach().to("cpu", copy=True).numpy()


def _u32(t: torch.Tensor) -> np.ndarray:
    """A private host copy of an int32 tensor that carries u32 data."""
    return _host(t).view(np.uint32)


def _lanes(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def _put_rows(view: torch.Tensor, index: tuple, rows: np.ndarray) -> None:
    """view[index] = rows, in place (the view writes through to the
    stored tensor); u32 rows are reinterpreted as int32."""
    if rows.dtype != bool:
        rows = np.ascontiguousarray(rows, dtype=np.uint32).view(np.int32)
    view[index] = to_device(rows, view.device)


def extend_streams(acc: dict, streams: dict, batch: int) -> None:
    """Append one segment's drained streams (a drain's per-lane lists) to
    the per-lane lists of `acc`, in place."""
    for name, lanes in streams.items():
        if name not in acc:
            acc[name] = [[] for _ in range(batch)]
        for b in range(batch):
            acc[name][b].extend(lanes[b])


# ---------------------------------------------------------------------------
# 1. Witness-queue draining
# ---------------------------------------------------------------------------

def drain_witness_queues(state: BatchedVmState, config: VmConfig):
    """Read every enabled queue family to host query structs, then rewind
    the queues in place.

    Returns (state, streams), streams a dict of per-lane lists: ``memory``
    (MemoryQuery), ``log`` (LogQuery), ``decommit`` (DecommittmentQuery),
    ``precompile`` (MemoryQuery), for the families the config enables.
    Timestamps keep counting, so concatenated drains form the continuous
    stream.
    """
    # the readers serialize through witness/packed, which rewinds with
    # this module's rewind_queues
    from ..witness.commitment import (
        device_decommit_streams, device_log_streams,
        device_precompile_streams, device_queue_streams,
    )

    streams = {}
    if config.queue_capacity > 0:
        streams["memory"] = device_queue_streams(state)
    if config.log_queue_capacity > 0:
        streams["log"] = device_log_streams(state)
    if config.decommit_queue_capacity > 0:
        streams["decommit"] = device_decommit_streams(state)
    if config.precompile_queue_capacity > 0:
        streams["precompile"] = device_precompile_streams(state)
    return rewind_queues(state), streams


def rewind_queues(state: BatchedVmState) -> BatchedVmState:
    """Empty every witness queue and reset the block clocks.

    Updates `state` in place (and returns it): the queue tensors are zeroed
    where they lie, so a chained call reuses their memory.  Timestamps keep
    counting and the rolling sponge (`wc_*`) is kept.
    """
    for name in QUEUE_FIELDS:
        getattr(state, name).zero_()
    return state


# ---------------------------------------------------------------------------
# 2. Callstack spill / unspill
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpilledFrames:
    """Host-side storage of spilled bottom frames, per lane (LIFO order:
    index 0 is the outermost frame, the root sentinel once spilled); a
    frame is a dict of CS_ARRAYS rows (uint32)."""

    frames: list[list[dict]]

    @classmethod
    def empty(cls, batch: int) -> "SpilledFrames":
        return cls(frames=[[] for _ in range(batch)])

    def spilled_depth(self, b: int) -> int:
        return len(self.frames[b])


def normalize_callstack(state: BatchedVmState, config: VmConfig,
                        spilled: SpilledFrames, lo: int, hi: int):
    """Bring every lane's device depth into [lo, hi] by moving frames
    to/from host storage (device slots 0..depth are live, oldest at 0).

    - depth > hi: the (depth - hi) OLDEST device frames spill to host, and
      the rest shift down (the top rows keep their old contents).
    - depth < lo with spilled frames: up to (lo - depth) newest spilled
      frames are restored under the bottom.

    A segment of n cycles is safe with lo >= n + 1 and hi <= max_depth - 2
    - n (depth moves at most 1 a cycle); both hold when n <= (max_depth -
    3) // 2.  Only the lanes that move frames are read and written.
    Returns (state, spilled), the state updated in place.
    """
    D = config.max_depth
    assert 1 <= lo <= hi <= D - 2
    depth = _host(state.depth).astype(np.int64)
    need_spill = np.nonzero(depth > hi)[0]
    need_fill = np.array([b for b in np.nonzero(depth < lo)[0]
                          if spilled.frames[b]], dtype=np.int64)
    if len(need_spill) == 0 and len(need_fill) == 0:
        return state, spilled
    ref = reference_view(state)
    rows = np.arange(D)[None, :, None]
    for lanes, spill in ((need_spill, True), (need_fill, False)):
        if len(lanes) == 0:
            continue
        idx = _lanes(lanes, state.depth.device)
        old = {name: _u32(getattr(ref, name)[idx]) for name in CS_ARRAYS}
        new_depth = depth[lanes].copy()
        if spill:
            s = depth[lanes] - hi
            for j, b in enumerate(lanes):   # oldest first
                spilled.frames[b].extend(
                    {name: old[name][j, i] for name in CS_ARRAYS}
                    for i in range(s[j]))
            # new[i] = old[i + s] below D - s; the top rows keep theirs
            src = np.where(rows < D - s[:, None, None],
                           rows + s[:, None, None], rows)
            new = {name: np.take_along_axis(a, src, 1)
                   for name, a in old.items()}
            new_depth -= s
        else:
            r = np.minimum([len(spilled.frames[b]) for b in lanes],
                           lo - depth[lanes])
            src = np.maximum(rows - r[:, None, None], 0)
            new = {name: np.take_along_axis(a, src, 1)
                   for name, a in old.items()}
            for j, b in enumerate(lanes):   # newest spilled first
                for i in range(r[j]):
                    frame = spilled.frames[b].pop()
                    for name in CS_ARRAYS:
                        new[name][j, r[j] - 1 - i] = frame[name]
            new_depth += r
        for name in CS_ARRAYS:
            _put_rows(getattr(ref, name), (idx,), new[name])
        _put_rows(state.depth, (idx,), new_depth)
    return state, spilled


def run_segments(state: BatchedVmState, config: VmConfig, run_cycles,
                 n_cycles: int, segment: int,
                 spilled: SpilledFrames | None = None):
    """Run in segments, normalizing the callstack window around each so a
    bounded `max_depth` serves unbounded recursion.

    Requires segment <= (max_depth - 3) // 2.  Returns (state, spilled);
    pass `spilled` back in when continuing the same execution across
    several calls: frames that do not fit the device stack stay host-side
    in it.  `run_cycles` is either engine's entry point
    (`fused_cycle.run_cycles`, `batched_vm.run_cycles`).
    """
    assert segment <= (config.max_depth - 3) // 2, "segment too long for D"
    if spilled is None:
        spilled = SpilledFrames.empty(config.batch)
    done = 0
    while done < n_cycles:
        n = min(segment, n_cycles - done)
        state, spilled = normalize_callstack(
            state, config, spilled, lo=n + 1, hi=config.max_depth - 2 - n)
        state = run_cycles(state, config, n)
        done += n
    # one final fill restores what fits (architectural depth beyond
    # max_depth - 2 stays host-side in `spilled`)
    state, spilled = normalize_callstack(
        state, config, spilled, lo=config.max_depth - 2,
        hi=config.max_depth - 2)
    return state, spilled


# ---------------------------------------------------------------------------
# 3. Storage-KV spill (evict / detect / replay)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostStorage:
    """Host overflow map per lane: 14-limb key tuple -> 8-limb value
    (uint32)."""

    maps: list[dict[tuple, np.ndarray]]

    @classmethod
    def empty(cls, batch: int) -> "HostStorage":
        return cls(maps=[{} for _ in range(batch)])


def _evict_mask(valid: torch.Tensor, pinned: torch.Tensor, keep: int):
    """(resident, evicted) masks [B, N]: every pinned valid entry stays,
    and the first `keep` unpinned valid entries of a lane stay too."""
    evictable = valid & ~pinned
    rank = torch.cumsum(evictable, 1) - evictable.to(torch.int64)
    resident = valid & (pinned | (rank < keep))
    return resident, valid & ~resident


def spill_storage_kv(state: BatchedVmState, config: VmConfig,
                     host: HostStorage, keep: int):
    """Evict evictable device KV entries beyond `keep` per lane to host.

    Evictable = used, below `st_count`, and not referenced by a live
    journal entry (`j_slot[:j_count]`).  The first `keep` evictable entries
    stay resident (insertion order; keep=0 evicts everything evictable).
    Every lane's table compacts in place, and `j_slot` is remapped through
    the permutation.  Returns (state, host).
    """
    S, J = config.storage_slots, config.journal_slots
    ref = reference_view(state)
    dev = state.depth.device
    pos = torch.arange(S, device=dev)
    used = ref.st_used & (pos[None, :] < state.st_count[:, None])
    j_live = torch.arange(J, device=dev)[None, :] < state.j_count[:, None]
    pinned = ((ref.j_slot[:, :, None] == pos) & j_live[:, :, None]).any(1)
    resident, evicted = _evict_mask(used, pinned, keep)
    lanes, slots = evicted.nonzero(as_tuple=True)
    if len(lanes):
        keys = _u32(ref.st_key[lanes, slots]).tolist()
        vals = _u32(ref.st_val[lanes, slots])
        for b, key, val in zip(lanes.tolist(), keys, vals):
            host.maps[b][tuple(key)] = val
    newpos = torch.cumsum(resident, 1) - 1
    for name, new in zip(("st_key", "st_val", "st_used"), _stable_filter(
            resident, [ref.st_key, ref.st_val, ref.st_used])):
        getattr(ref, name).copy_(new)
    state.st_count.copy_(resident.sum(1).to(torch.int32))
    remapped = torch.gather(newpos, 1, ref.j_slot.to(torch.int64).clamp(
        0, S - 1)).to(torch.int32)
    ref.j_slot.copy_(torch.where(j_live, remapped, ref.j_slot))
    return state, host


def rehydrate_keys(state: BatchedVmState, config: VmConfig,
                   host: HostStorage, needed: list[set]) -> BatchedVmState:
    """Insert host values for the given per-lane key sets into the free
    slots at `st_count`, in place; in the order each set iterates."""
    S = config.storage_slots
    if not any(needed):
        return state
    count = _host(state.st_count)
    rows = []                                   # (lane, slot, key, value)
    for b, keys in enumerate(needed):
        for key in keys:
            val = host.maps[b].pop(key, None)
            if val is None:
                continue
            slot = int(count[b])
            assert slot < S, "KV table full during rehydration"
            rows.append((b, slot, key, val))
            count[b] += 1
    if rows:
        ref = reference_view(state)
        dev = state.depth.device
        b, s, keys, vals = zip(*rows)
        index = (_lanes(b, dev), _lanes(s, dev))
        _put_rows(ref.st_key, index, np.array(keys, dtype=np.uint32))
        _put_rows(ref.st_val, index, np.stack(vals))
        _put_rows(ref.st_used, index, np.ones(len(rows), dtype=bool))
        state.st_count.copy_(to_device(count, dev))
    return state


def _touched_storage_keys(log_streams) -> list[set]:
    """Per-lane sets of 14-limb key tuples touched by storage log
    queries."""
    out = []
    for lane in log_streams:
        keys = set()
        for q in lane:
            if q.aux_byte == params.STORAGE_AUX_BYTE:
                keys.add(tuple(int(x) for x in storage_key_limbs(
                    q.shard_id, q.address, q.key)))
        out.append(keys)
    return out


def _missing(touched: list[set], maps: list[dict]) -> list[set]:
    """Per lane, the touched keys that sit in the host map."""
    return [set(k for k in t if k in maps[b]) for b, t in enumerate(touched)]


def run_segments_storage(state: BatchedVmState, config: VmConfig,
                         run_cycles, n_cycles: int, segment: int,
                         host: HostStorage | None = None,
                         keep: int = 0, max_replays: int = 8):
    """Run in segments with KV spill between them (see the protocol above).

    Requires `config.log_queue_capacity >= segment` (the drained log
    stream is the cold-touch detector).  Returns (state, host, streams),
    streams every segment's drained queue families concatenated (equal to
    an unsegmented drain).
    """
    if host is None:
        host = HostStorage.empty(config.batch)
    assert config.log_queue_capacity >= segment > 0
    acc: dict[str, list[list]] = {}
    done = 0
    while done < n_cycles:
        n = min(segment, n_cycles - done)
        snapshot = state
        for attempt in range(max_replays + 1):
            # the engines update their argument in place, and a replay
            # must start from the snapshot
            out = run_cycles(clone_state(snapshot), config, n)
            miss = _missing(_touched_in_log_queue(out)[0], host.maps)
            if not any(miss):
                break
            assert attempt < max_replays, "storage replay did not converge"
            snapshot = rehydrate_keys(snapshot, config, host, miss)
        state, streams = drain_witness_queues(out, config)
        extend_streams(acc, streams, config.batch)
        state = compact_log_state_host(state, config)
        state, host = spill_storage_kv(state, config, host, keep=keep)
        done += n
    return state, host, acc


def compact_log_state_host(state: BatchedVmState,
                           config: VmConfig) -> BatchedVmState:
    """Journal / event compaction (`models/compaction.py`) between
    segments."""
    if config.journal_slots == 0:
        return state
    return compact_log_state(state, config)


# ---------------------------------------------------------------------------
# 4. Heap-frame arena reclamation
# ---------------------------------------------------------------------------

def _tagged(pages: torch.Tensor, ref: BatchedVmState,
            config: VmConfig) -> torch.Tensor:
    """[B, F] bool: page `pages[b, s]` is named by a tagged fat pointer in
    lane b's register file or stack arena (limb 1 is the page)."""
    regs = ref.regs[:, :, 1]
    stack = arena_word_major(ref.stack, config)[:, :, 1]
    return (((regs[:, None, :] == pages[:, :, None])
             & ref.reg_ptr[:, None, :]).any(2)
            | ((stack[:, None, :] == pages[:, :, None])
               & ref.stack_ptr_tag[:, None, :]).any(2))


def reclaim_heap_frames(state: BatchedVmState, config: VmConfig):
    """Compact the live heap / aux-heap frame slots, in place; returns the
    state.

    A slot below `frame_count` is live if a live callstack frame's
    `heap_slot` names it or a tagged fat pointer (register file or stack
    arena) names its heap or aux page.  A lane with a dead slot keeps its
    live ones in order, the rest zeroed, and its frames' `heap_slot`s
    remapped; other lanes are untouched.  Memory queries record page
    numbers, which never change, so the witness streams are unchanged.
    """
    F = config.heap_frames
    ref = reference_view(state)
    dev = state.depth.device
    slot = torch.arange(F, device=dev)
    d_live = torch.arange(config.max_depth, device=dev)[None, :] \
        <= state.depth[:, None]
    heap_slot = ref.cs_scalars[:, :, CS["heap_slot"]]
    live = ((heap_slot[:, :, None] == slot) & d_live[:, :, None]).any(1)
    live |= _tagged(ref.hp_page, ref, config) \
        | _tagged(ref.ap_page, ref, config)
    n = state.frame_count.clamp(max=F)
    keep = live & (slot[None, :] < n[:, None])
    count = keep.sum(1)
    changed = count < n
    if not bool(changed.any()):
        return state
    arenas = [ref.hp_page, ref.ap_page,
              ref.heap.unflatten(1, (F, config.heap_words)),
              ref.aux_heap.unflatten(1, (F, config.aux_heap_words))]
    for old, new in zip(arenas, _stable_filter(keep, arenas)):
        sel = changed.reshape(-1, *([1] * (old.dim() - 1)))
        old.copy_(torch.where(sel, new, old))
    newpos = (torch.cumsum(keep, 1) - 1).to(torch.int32)
    remapped = torch.gather(newpos, 1,
                            heap_slot.to(torch.int64).clamp(0, F - 1))
    heap_slot.copy_(torch.where(d_live & changed[:, None], remapped,
                                heap_slot))
    state.frame_count.copy_(torch.where(changed, count.to(torch.int32),
                                        state.frame_count))
    return state


# ---------------------------------------------------------------------------
# 5. Code-bank eviction (evict / detect / replay)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostCodeBank:
    """Host overflow of evicted contracts, per lane: stored-form 8-limb
    hash tuple -> {"page": u32, "len": u32, "words": np.ndarray[CW, 8]}."""

    maps: list[dict[tuple, dict]]

    @classmethod
    def empty(cls, batch: int) -> "HostCodeBank":
        return cls(maps=[{} for _ in range(batch)])


def spill_code_bank(state: BatchedVmState, config: VmConfig,
                    host: HostCodeBank, keep: int = 0,
                    pin_hashes: list[set] | None = None):
    """Evict evictable code-bank slots beyond `keep` per lane to host.

    Evictable = a valid slot but slot 0 (the entry program) whose bound
    page is not a live frame's `code_page` nor the fetch cache's
    (`previous_code_page`), whose hash is not the default-AA hash, and
    whose hash is not in the lane's `pin_hashes` set.  Unbound staged
    slots (`cb_page == 0`) are evictable.  An evicted contract keeps its
    page binding host-side.  A lane with a free or evicted slot compacts
    in place.  Returns (state, host).
    """
    P = config.code_pages
    ref = reference_view(state)
    dev = state.depth.device
    d_live = torch.arange(config.max_depth, device=dev)[None, :] \
        <= state.depth[:, None]
    frame_pages = ref.cs_scalars[:, :, CS["code_page"]]
    cb_page = ref.cb_page
    page_live = ((frame_pages[:, :, None] == cb_page[:, None, :])
                 & d_live[:, :, None]).any(1) \
        | (state.previous_code_page[:, None] == cb_page)
    pinned = (torch.arange(P, device=dev)[None, :] == 0) \
        | ((cb_page != 0) & page_live) \
        | (ref.cb_hash == state.default_aa_hash[:, None, :]).all(2)
    if pin_hashes is not None and any(pin_hashes):
        lanes = [b for b, named in enumerate(pin_hashes) if named]
        idx = _lanes(lanes, dev)
        hashes = _u32(ref.cb_hash[idx]).tolist()
        named = np.array([[tuple(h) in pin_hashes[b] for h in lane]
                          for b, lane in zip(lanes, hashes)])
        pinned[idx] |= to_device(named, dev)
    resident, evicted = _evict_mask(ref.cb_valid, pinned, keep)
    if not bool((resident.sum(1) < P).any()):
        return state, host
    code = ref.code.unflatten(1, (P, config.code_words))
    lanes, slots = evicted.nonzero(as_tuple=True)
    if len(lanes):
        hashes = _u32(ref.cb_hash[lanes, slots]).tolist()
        pages = _u32(cb_page[lanes, slots]).tolist()
        lens = _u32(ref.cb_len[lanes, slots]).tolist()
        words = _u32(code[lanes, slots])
        for j, b in enumerate(lanes.tolist()):
            host.maps[b][tuple(hashes[j])] = {
                "page": pages[j], "len": lens[j], "words": words[j]}
    arenas = [ref.cb_hash, ref.cb_len, cb_page, code]
    for old, new in zip(arenas, _stable_filter(resident, arenas)):
        old.copy_(new)
    ref.cb_valid.copy_(torch.arange(P, device=dev)[None, :]
                       < resident.sum(1)[:, None])
    return state, host


def rehydrate_code(state: BatchedVmState, config: VmConfig,
                   host: HostCodeBank, needed: list[set]) -> BatchedVmState:
    """Re-insert evicted contracts for the given per-lane stored-hash sets
    into each lane's first free bank slots (with their page bindings), in
    place; in the order each set iterates."""
    if not any(needed):
        return state
    ref = reference_view(state)
    dev = state.depth.device
    lanes = [b for b, hashes in enumerate(needed) if hashes]
    valid = _host(ref.cb_valid[_lanes(lanes, dev)])
    rows = []                                   # (lane, slot, hash, entry)
    for j, b in enumerate(lanes):
        for key in needed[b]:
            ent = host.maps[b].pop(key, None)
            if ent is None:
                continue
            free = np.nonzero(~valid[j])[0]
            # capacity contract: code_pages must cover the entry slot +
            # pages live in frames at the segment boundary + every distinct
            # contract one segment touches; shorten segments or grow
            # code_pages if this trips
            assert len(free), ("code bank full during rehydration — the "
                               "segment touches more contracts than "
                               "code_pages can hold")
            s = int(free[0])
            valid[j, s] = True
            rows.append((b, s, key, ent))
    if rows:
        b, s, keys, ents = zip(*rows)
        index = (_lanes(b, dev), _lanes(s, dev))
        _put_rows(ref.cb_hash, index, np.array(keys, dtype=np.uint32))
        _put_rows(ref.cb_len, index, np.array([e["len"] for e in ents]))
        _put_rows(ref.cb_page, index, np.array([e["page"] for e in ents]))
        _put_rows(ref.cb_valid, index, np.ones(len(rows), dtype=bool))
        _put_rows(ref.code.unflatten(1, (config.code_pages,
                                         config.code_words)),
                  index, np.stack([e["words"] for e in ents]))
    return state


def _touched_code_hashes(log_streams) -> list[set]:
    """Per-lane sets of stored-form 8-limb hash tuples requested by far
    calls, from the log stream's code-hash storage reads (reads at the
    deployer system contract).  Stored form = the versioned hash with the
    marker byte cleared."""
    mask = ~(0xFF << 240)
    out = []
    for lane in log_streams:
        hashes = set()
        for q in lane:
            if (q.aux_byte == params.STORAGE_AUX_BYTE and not q.rw_flag
                    and q.address == params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS):
                hashes.add(tuple(int(x)
                                 for x in to_limbs(q.read_value & mask)))
        out.append(hashes)
    return out


def _touched_in_log_queue(state: BatchedVmState) -> tuple[list, list]:
    """Both detectors on the state's log queue: (`_touched_storage_keys`,
    `_touched_code_hashes`) of `device_log_streams(state)`, the same sets
    built in the same order, but read from the packed log records with
    numpy, without building query structs (at block width the structs
    cost seconds a replay attempt)."""
    from ..witness.packed import serialize_all

    words, valid = serialize_all(state, ("log",))["log"]
    rows = _u32(words[valid])               # (lane, slot) order
    lane = _host(valid.nonzero()[:, 0])
    # a record word holds its field big-endian: byteswapped and reversed,
    # the limbs come little-endian
    limbs = rows.byteswap()
    address, key = limbs[:, 7:2:-1], limbs[:, 15:7:-1]
    read = limbs[:, 23:15:-1].copy()
    read[:, 7] &= 0xFF00FFFF                # the marker byte, bits 240..247
    w1 = rows[:, 1]
    storage = (w1 & 0xFF) == params.STORAGE_AUX_BYTE
    keys = np.concatenate([key, address, ((w1 >> 8) & 0xFF)[:, None]], 1)
    deployer = to_limbs(params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS)[:5]
    code = storage & ((w1 >> 16) & 1 == 0) & (address == deployer).all(1)
    t_keys = [set() for _ in range(valid.shape[0])]
    t_hashes = [set() for _ in range(valid.shape[0])]
    for b, k in zip(lane[storage].tolist(), keys[storage].tolist()):
        t_keys[b].add(tuple(k))
    for b, h in zip(lane[code].tolist(), read[code].tolist()):
        t_hashes[b].add(tuple(h))
    return t_keys, t_hashes


def run_segments_decommit(state: BatchedVmState, config: VmConfig,
                          run_cycles, n_cycles: int, segment: int,
                          host: HostCodeBank | None = None,
                          keep: int = 0, max_replays: int = 8):
    """Run in segments with code-bank eviction between them (see the
    protocol above).  Requires `config.log_queue_capacity >= segment`.
    Returns (state, host, streams), streams every segment's drained queue
    families concatenated."""
    if host is None:
        host = HostCodeBank.empty(config.batch)
    assert config.log_queue_capacity >= segment > 0
    acc: dict[str, list[list]] = {}
    done = 0
    while done < n_cycles:
        n = min(segment, n_cycles - done)
        snapshot = state
        for attempt in range(max_replays + 1):
            out = run_cycles(clone_state(snapshot), config, n)
            touched = _touched_in_log_queue(out)[1]
            miss = _missing(touched, host.maps)
            if not any(miss):
                break
            assert attempt < max_replays, "decommit replay did not converge"
            # make room first: evict everything not pinned and not touched
            # by this segment
            snapshot, host = spill_code_bank(snapshot, config, host,
                                             keep=0, pin_hashes=touched)
            snapshot = rehydrate_code(snapshot, config, host, miss)
        state, streams = drain_witness_queues(out, config)
        extend_streams(acc, streams, config.batch)
        state, host = spill_code_bank(state, config, host, keep=keep)
        done += n
    return state, host, acc
