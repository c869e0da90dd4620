"""The engine's state fields of one lane, worked out from the oracle's run.

`expected_lane` takes the configuration as its file states it (the `vm`
object of `configs/<name>.json`), the lane's inputs (code words, ergs) and
the oracle's result (`oracle.run`), and returns every field of the engine's
state for that lane, by the engine's field names, in its reference layout
(lane axis dropped; the memory queue's rows first).  The values follow
EraVM's semantics as the oracle runs them; what the engine keeps beyond
them is modelled here from its documented layout:

- the root frame (frame 0) holds the bootloader's remaining ergs,
  2**32 - 1 - ergs, besides its initial sp;
- the stack arena holds the logical words [0, stack_abs_words) and
  [stack_sp_base, stack_sp_base + stack_words - stack_abs_words) of the
  entry frame's stack page, in that order;
- heap frame slot 0 is the entry frame's heap and aux heap (pages base + 2,
  base + 3); the code bank's slot 0 is the entry program at page base;
- the memory queue and its block clock (`global_step`) count the cycles
  since the last rewind; a rewound queue is all zero.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

from .oracle import ST_DONE, ST_OOB, ST_UNSUPPORTED

BASE_PAGE = 8
INITIAL_FRAME_ERGS = 2**32 - 1
#: the engine's callstack scalar columns, by their names
CS_COLUMNS = ("base_memory_page", "code_page", "sp", "pc",
              "exception_handler", "ergs_remaining", "shard_ids",
              "flags_word", "heap_bound", "aux_heap_bound",
              "journal_snapshot", "event_snapshot", "heap_slot")
#: slots of the memory queue a cycle
SLOTS_PER_CYCLE = 8


def limbs(value: int, n: int = 8) -> np.ndarray:
    return np.array([(value >> (32 * i)) & 0xFFFFFFFF for i in range(n)],
                    dtype=np.uint32)


def stack_logical(vm: dict) -> np.ndarray:
    """The logical stack index that each arena word holds."""
    sw, a = vm["stack_words"], vm.get("stack_abs_words")
    if a is None:
        return np.arange(sw)
    s0 = vm.get("stack_sp_base", 768)
    return np.concatenate([np.arange(a), s0 + np.arange(sw - a)])


def _frames(vm: dict, st: dict, ergs: int) -> dict:
    f = st["frames"].astype(np.uint64)
    D = vm.get("max_depth", 32)
    f = f[:D]

    def addr(col):            # u64 in two words -> 5 limbs
        out = np.zeros((D, 5), dtype=np.uint32)
        out[:, :2] = f[:, col:col + 2]
        return out

    sc = np.zeros((D, len(CS_COLUMNS)), dtype=np.uint64)
    for i, name in enumerate(("base_memory_page", "code_page", "sp", "pc",
                              "exception_handler", "ergs_remaining",
                              "heap_bound", "aux_heap_bound",
                              "journal_snapshot", "event_snapshot")):
        sc[:, CS_COLUMNS.index(name)] = f[:, 10 + i]
    sc[:, CS_COLUMNS.index("shard_ids")] = f[:, 20] | (f[:, 21] << 8) \
        | (f[:, 22] << 16)
    sc[:, CS_COLUMNS.index("flags_word")] = f[:, 23] | (f[:, 24] << 1)
    sc[0, CS_COLUMNS.index("ergs_remaining")] = INITIAL_FRAME_ERGS - ergs
    return {"cs_this_address": addr(0), "cs_msg_sender": addr(2),
            "cs_code_address": addr(4),
            "cs_context_u128": f[:, 6:10].astype(np.uint32),
            "cs_scalars": sc.astype(np.uint32)}


def expected_lane(vm: dict, code_words: list[int], ergs: int, out: dict,
                  clock: int, rewound: bool) -> dict[str, np.ndarray]:
    """Every state field of one lane.  `clock` is the cycles the batch ran
    since the last rewind of its queues (all of them where the config never
    rewinds), `rewound` whether the queues were rewound after them."""
    st = out["state"]
    z = lambda *shape: np.zeros(shape, dtype=np.uint32)   # noqa: E731
    P, CW = vm.get("code_pages", 1), vm.get("code_words", 64)
    F = vm.get("heap_frames", 1)
    HW, AW = vm.get("heap_words", 512), vm.get("aux_heap_words", 64)
    S, J, E = (vm.get(k, 0) for k in ("storage_slots", "journal_slots",
                                      "event_slots"))
    LQ, DQ, PQ = (vm.get(k, 0) for k in ("log_queue_capacity",
                                         "decommit_queue_capacity",
                                         "precompile_queue_capacity"))
    Q = vm.get("queue_capacity", 0)
    rolling = vm.get("rolling_commitment", False)
    status = out["status"]
    code = z(P * CW, 8)
    for i, w in enumerate(code_words):
        code[i] = limbs(w)
    heap = z(F * HW, 8)
    heap[:HW] = out["heap"]
    aux = z(F * AW, 8)
    aux[:AW] = st["aux_heap"]
    logical = stack_logical(vm)
    hp, ap = z(F), z(F)
    hp[0], ap[0] = BASE_PAGE + 2, BASE_PAGE + 3
    cb_page, cb_valid = z(P), np.zeros(P, dtype=bool)
    cb_page[0], cb_valid[0] = BASE_PAGE, True
    queued = 0 if rewound else clock
    return {
        "regs": out["regs"], "reg_ptr": out["reg_ptr"],
        "flags": out["flags"],
        "timestamp": st["timestamp"],
        "monotonic_cycle_counter": np.uint32(out["cycles"]),
        "spent_pubdata": st["spent_pubdata"],
        "ergs_per_pubdata": st["ergs_per_pubdata"],
        "tx_number": st["tx_number"],
        "pending_exception": st["pending_exception"].astype(bool),
        "previous_code_word": st["previous_code_word"],
        "previous_super_pc": st["previous_super_pc"],
        "previous_code_page": st["previous_code_page"],
        "context_u128": st["context_u128"],
        "depth": st["depth"],
        **_frames(vm, st, ergs),
        "code": code,
        "stack": st["stack"][logical].reshape(-1),
        "stack_ptr_tag": st["stack_tag"][logical].astype(bool),
        "heap": heap, "aux_heap": aux, "hp_page": hp, "ap_page": ap,
        "frame_count": np.uint32(1), "page_counter": st["page_counter"],
        "cb_hash": z(P, 8), "cb_len": z(P), "cb_page": cb_page,
        "cb_valid": cb_valid, "default_aa_hash": z(8),
        "dq_hash": z(DQ, 8), "dq_meta": z(DQ, 4), "dq_count": np.uint32(0),
        "wc_state": out["sponge"] if rolling else z(0, 2),
        "wc_count": np.uint32(out["sponge_count"] if rolling else 0),
        "done": np.bool_(status == ST_DONE),
        "lane_error": np.bool_(status in (ST_UNSUPPORTED, ST_OOB)),
        "global_step": np.uint32(queued),
        "wq_count": np.uint32(min(queued * SLOTS_PER_CYCLE, Q)),
        "wq_meta": z(Q, 4), "wq_value": z(Q, 8), "wq_flags": z(Q),
        "st_key": z(S, 14), "st_val": z(S, 8),
        "st_used": np.zeros(S, dtype=bool), "st_count": st["kv_count"],
        "j_slot": z(J), "j_prev": z(J, 8), "j_count": st["j_count"],
        "ev_key": z(E, 8), "ev_val": z(E, 8), "ev_meta": z(E, 2),
        "ev_cancelled": np.zeros(E, dtype=bool), "ev_count": st["ev_count"],
        "lq_meta": z(LQ, 4), "lq_addr": z(LQ, 5), "lq_key": z(LQ, 8),
        "lq_read": z(LQ, 8), "lq_written": z(LQ, 8), "lq_count": np.uint32(0),
        "pq_meta": z(PQ, 4), "pq_value": z(PQ, 8), "pq_flags": z(PQ),
        "pq_count": np.uint32(0), "pq_blocks": np.uint32(0),
    }


def oracle_records(witness: np.ndarray) -> np.ndarray:
    """The oracle's 64-byte memory records -> rows of 13 u32 words: meta
    (timestamp, type, page, index), the value's 8 limbs (least first), and
    the flags (bit 0 rw, bit 1 value is a pointer)."""
    w = witness.astype(np.uint32)
    be32 = lambda b: (w[:, b] << 24) | (w[:, b + 1] << 16) \
        | (w[:, b + 2] << 8) | w[:, b + 3]                 # noqa: E731
    rows = np.zeros((len(w), 13), dtype=np.uint32)
    rows[:, 0] = be32(0)
    rows[:, 1] = w[:, 4]
    rows[:, 2] = (w[:, 5] << 24) | (w[:, 6] << 16) | (w[:, 7] << 8) | w[:, 8]
    rows[:, 3] = (w[:, 9] << 24) | (w[:, 10] << 16) | (w[:, 11] << 8) \
        | w[:, 12]
    for k in range(8):
        rows[:, 4 + k] = be32(32 + 4 * (7 - k))
    rows[:, 12] = w[:, 13] & 3
    return rows


def records_from_rows(meta: np.ndarray, value: np.ndarray,
                      flags: np.ndarray) -> np.ndarray:
    """A lane's captured queue rows ([Q, 4], [Q, 8], [Q]) -> its valid
    records (bit 2 of the flags) in row order, as `oracle_records` gives
    them."""
    valid = (flags >> 2) & 1 != 0
    return np.concatenate([meta[valid], value[valid],
                           (flags[valid] & 3)[:, None]], axis=1)
