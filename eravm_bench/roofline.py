"""The benchmark's frozen yardstick: peaks, and the counts of the work a
kernel must do, whatever its layout.

Copied from the port's measurement scripts when the benchmark was defined,
so that a later change to the program cannot move its own floor:

- `bound_ms` and the op constants from `chip_smoke.py:344-380, 922-927`;
- `k1_bytes` and `changed_bytes` from `chip_smoke.py:930-973`, with K1's
  field list (`models/fused_cycle.py::_k1_fields`) written out as
  `K1_FIELDS`, and in mode (b) the compacted records and their counts that
  K1 writes, as `chip_smoke.py:2747-2748` adds them;
- `k2_bound` from `era_zk_evm_tpu_torch/tools/k1_times.py:130-176`.

The precompile units' work (keccak-f, sha256 compressions, recoveries) and
the round-witness splice's bytes are not here: no cell runs the units.

Peaks of one NVIDIA H100 SXM: HBM at 3.35 TB/s (NVIDIA's data sheet), and
int32 at 132 SMs x 64 int32 lanes an SM x 1980 MHz (the SM's lane count in
NVIDIA's Hopper tuning guide and the card's highest SM clock as
`nvidia-smi --query-gpu=clocks.max.sm` reads it; not a data-sheet figure).
Both assume the card's full 700 W power limit; every share is printed
beside the limit the card reports.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES_PER_SM, SM_MHZ = 132, 64, 1980.0
SECTOR = 32                                    # bytes of one DRAM sector
RECORD_BYTES = 52                              # one compacted memory record

#: a lower count of the int32 operations of one lane-cycle of K1
K1_MIN_OPS = 64
#: int32 operations of one keccak-f[1600], 3-input logic ops counted as
#: one: per round theta 80, rho 48, chi 50, iota 2 (24 rounds)
KECCAK_OPS = 24 * 180
#: the state fields K1 reads or writes (models/fused_cycle.py::_k1_fields)
K1_FIELDS = (
    "regs", "reg_ptr", "flags", "timestamp", "monotonic_cycle_counter",
    "ergs_per_pubdata", "tx_number", "pending_exception",
    "previous_code_word", "previous_super_pc", "previous_code_page",
    "context_u128", "depth", "cs_this_address", "cs_msg_sender",
    "cs_code_address", "cs_context_u128", "cs_scalars", "code", "stack",
    "stack_ptr_tag", "heap", "aux_heap", "hp_page", "ap_page", "cb_page",
    "cb_valid", "j_count", "ev_count", "spent_pubdata", "st_key", "st_val",
    "st_used", "st_count", "j_slot", "j_prev", "ev_key", "ev_val", "ev_meta",
    "ev_cancelled", "lq_meta", "lq_addr", "lq_key", "lq_read", "lq_written",
    "lq_count", "dq_hash", "dq_meta", "dq_count", "cb_hash",
    "default_aa_hash", "frame_count", "page_counter", "done", "lane_error",
    "global_step", "wq_count")
#: K1 arguments it only reads
K1_READ_ONLY = frozenset({"code", "cb_valid", "cb_hash", "default_aa_hash"})
#: K1 outputs whose old contents it never reads: the witness queue rows
K1_WRITE_ONLY = frozenset({
    "lq_meta", "lq_addr", "lq_key", "lq_read", "lq_written", "dq_hash",
    "dq_meta", "wq_meta", "wq_value", "wq_flags", "pq_meta", "pq_value",
    "pq_flags"})


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least time in ms, what sets it): bytes over the HBM rate against
    int32 operations over the card's int32 issue rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (SMS * INT32_LANES_PER_SM * SM_MHZ * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def changed_bytes(a, b) -> int:
    """Bytes of the 32-byte sectors in which two tensors of one shape
    differ."""
    import torch

    x, y = (t.contiguous().reshape(-1).view(torch.uint8) for t in (a, b))
    pad = -x.numel() % SECTOR
    if pad:
        zeros = x.new_zeros(pad)
        x, y = torch.cat([x, zeros]), torch.cat([y, zeros])
    return int((x.view(-1, SECTOR) != y.view(-1, SECTOR)).any(1).sum()) \
        * SECTOR


def k1_bytes(before: dict, after: dict, queue: bool, pq: bool,
             records=None) -> int:
    """A lower count of the bytes one K1 call must move to turn `before`
    into `after` (field name -> tensor, in the reference layout: lane first
    but for the memory queue): each input it only reads, once; of the state
    it writes, each 32-byte sector the call changed, read once and written
    once (a witness queue row only written).  `queue` and `pq` add the
    memory queue and the round-witness queue; `records` (int32 [B], mode
    (b): the call's compacted records a lane) adds the records, 52 bytes
    each, and the counts that K1 writes."""
    import torch

    fields = list(K1_FIELDS)
    if queue:
        fields += ["wq_meta", "wq_value", "wq_flags"]
    if pq:
        fields += ["pq_meta", "pq_value", "pq_flags", "pq_count", "pq_blocks"]
    total = 0
    for field in fields:
        a, b = before[field], after[field]
        if field in K1_READ_ONLY:
            total += a.numel() * a.element_size()
        else:
            total += changed_bytes(a, b) * (1 if field in K1_WRITE_ONLY
                                            else 2)
    if records is not None:
        total += int(records.to(torch.int64).sum()) * RECORD_BYTES \
            + records.numel() * records.element_size()
    return total


def k1_ops(lane_cycles: int) -> int:
    """int32 operations a K1 call must do with its units off: K1_MIN_OPS a
    lane-cycle."""
    return lane_cycles * K1_MIN_OPS


def k2_bound(wc_count, count) -> dict:
    """The least time K2 could take on a block of records: a keccak-f for
    each record that lands at an odd position of its lane's stream (the
    sponges' counts before the fold `wc_count`, the records a lane `count`,
    int32 [B]); the records read (52 bytes each), the counts read, the
    sponges (int32 [B, 25, 2]) and their counts read and written."""
    import torch

    c0 = wc_count.to(torch.int64) & 0xFFFFFFFF
    n_rec = count.to(torch.int64)
    perms = int(((c0 + n_rec) // 2 - c0 // 2).sum())
    B = count.numel()
    n_bytes = int(n_rec.sum()) * RECORD_BYTES + 4 * B + 2 * (B * 25 * 2 * 4 + 4 * B)
    ms, by = bound_ms(n_bytes, perms * KECCAK_OPS)
    return {"records": int(n_rec.sum()), "permutations": perms,
            "bytes": n_bytes, "bound_ms": ms, "bound_by": by}
