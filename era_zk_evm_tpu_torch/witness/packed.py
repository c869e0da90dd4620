"""Packed witness streams: record serializers, drains, digests, grand products.

The port of `era_zk_evm_tpu/witness/packed.py`:

  * the record serializers turn each queue family's tensors into the pinned
    per-record byte layouts of `era_zk_evm_tpu/witness/commitment.py`, as
    little-endian u32 words (int32 tensors holding the bits), with a valid
    mask per queue slot;
  * `drain_witness_queues_packed` serializes every enabled family on the
    device, dense or compacted (valid rows moved to the front in (lane,
    slot) order), then rewinds the queues in place; `fetch_dense_records`
    and `fetch_compacted_rows` bring the records to the host, and
    `split_records_by_lane` / `split_compacted_by_lane` cut them per lane;
  * `drain_witness_queues_packed_async` is the same drain with the copies
    to the host started and nothing waited for (`AsyncDrain`), for the
    scheduler's deferred resolve; `log_join_columns` reads the net-state
    join columns from packed log records;
  * `commit_packed_streams` computes per-stream keccak256 digests with the
    ragged sponge `ops.keccak.keccak256_ragged`: every stream in one word
    buffer, one copy to the device and one launch (`csrc/keccak_sponge.cu`
    on the card); `stream_digests` and `fold_digest_rows` are the same at
    the tensor level, for callers that keep the digests on the device;
  * `packed_grand_products` computes per-stream products of (gamma +
    fingerprint) mod p, the fingerprints through K3 on the card, the
    products on the host as Python ints.

Entry points work on the card unless the caller passes another device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.spill import rewind_queues
from ..models.state import DEFAULT_DEVICE, BatchedVmState, reference_view
from ..ops.goldilocks import GOLDILOCKS_P, gl_reduce64
from ..ops.keccak import RATE_WORDS, keccak256_ragged, keccak_f1600_
from ..ops.u256 import narrow, wide
from .queries import DecommittmentQuery, LogQuery, MemoryQuery, MemoryType

#: record width in u32 words per family (the pinned serializations)
RECORD_WORDS = {"memory": 16, "log": 32, "decommit": 16, "precompile": 16}


def _bswap(x: torch.Tensor) -> torch.Tensor:
    return ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) \
        | ((x >> 8) & 0xFF00) | (x >> 24)


def _words(cols: list[torch.Tensor]) -> torch.Tensor:
    return narrow(torch.stack(cols, dim=-1), torch.int32)


# ---------------------------------------------------------------------------
# Record serializers: (words int32[B, Q, W], valid bool[B, Q])
# ---------------------------------------------------------------------------

def _memory_like_words(meta, value, flag_byte) -> torch.Tensor:
    ts, mtype, page, index = (meta[..., i] for i in range(4))
    z = torch.zeros_like(ts)
    return _words([
        _bswap(ts),
        mtype | ((page >> 24) << 8) | (((page >> 16) & 0xFF) << 16)
        | (((page >> 8) & 0xFF) << 24),
        (page & 0xFF) | ((index >> 24) << 8) | (((index >> 16) & 0xFF) << 16)
        | (((index >> 8) & 0xFF) << 24),
        (index & 0xFF) | (flag_byte << 8),
        z, z, z, z,
    ] + [_bswap(value[..., 7 - i]) for i in range(8)])


def memory_record_words(state: BatchedVmState):
    """serialize_memory_query from the batch-last wq arrays."""
    meta = wide(state.wq_meta).permute(2, 0, 1)     # [B, Q, 4]
    value = wide(state.wq_value).permute(2, 0, 1)   # [B, Q, 8]
    flags = wide(state.wq_flags).T                  # [B, Q]
    return _memory_like_words(meta, value, flags & 3), (flags & 4) != 0


def precompile_record_words(state: BatchedVmState):
    """The precompile queue: the memory queue's 64-byte record
    (value_is_pointer always False; flags bits 3+ hold round counts)."""
    flags = wide(state.pq_flags)
    return (_memory_like_words(wide(state.pq_meta), wide(state.pq_value),
                               flags & 1), (flags & 4) != 0)


def log_record_words(state: BatchedVmState):
    """serialize_log_query (128 bytes)."""
    state = reference_view(state)
    meta = wide(state.lq_meta)
    ts, packed, tx = meta[..., 0], meta[..., 1], meta[..., 2]
    flags = ((packed >> 8) & 1) | (((packed >> 9) & 1) << 2)
    cols = [
        _bswap(ts),
        (packed & 0xFF) | (((packed >> 16) & 0xFF) << 8) | (flags << 16)
        | (((tx >> 8) & 0xFF) << 24),
        tx & 0xFF,
    ]
    addr = wide(state.lq_addr)
    cols += [_bswap(addr[..., 4 - i]) for i in range(5)]
    for arr in (state.lq_key, state.lq_read, state.lq_written):
        a = wide(arr)
        cols += [_bswap(a[..., 7 - i]) for i in range(8)]
    return _words(cols), meta[..., 3] != 0


def decommit_record_words(state: BatchedVmState):
    """serialize_decommittment (64 bytes)."""
    state = reference_view(state)
    meta, h = wide(state.dq_meta), wide(state.dq_hash)
    z = torch.zeros_like(meta[..., 0])
    cols = [_bswap(h[..., 7 - i]) for i in range(8)]
    cols += [_bswap(meta[..., 0]), _bswap(meta[..., 1]), _bswap(meta[..., 2]),
             (meta[..., 3] >> 1) & 1, z, z, z, z]
    return _words(cols), (meta[..., 3] & 1) != 0


_SERIALIZERS = {"memory": memory_record_words, "log": log_record_words,
                "decommit": decommit_record_words,
                "precompile": precompile_record_words}


def queue_families(config) -> tuple:
    """The witness-queue families a config enables, in drain order."""
    return tuple(name for name, cap in (
        ("memory", config.queue_capacity),
        ("log", config.log_queue_capacity),
        ("decommit", config.decommit_queue_capacity),
        ("precompile", config.precompile_queue_capacity)) if cap > 0)


def serialize_all(state: BatchedVmState, families: tuple) -> dict:
    """{family: (words int32[B, Q, W], valid bool[B, Q])} on the state's
    device."""
    return {name: _SERIALIZERS[name](state) for name in families}


def _compact(words: torch.Tensor, valid: torch.Tensor, frac: float):
    """Valid rows to the front in (lane, slot) order: (rows int32[budget, W],
    lane_counts int32[B], count int32[]), budget = max(1, int(B * Q *
    frac)); rows past the budget are dropped (the caller checks count)."""
    B, Q, W = words.shape
    budget = max(1, int(B * Q * frac))
    flat_w = words.reshape(B * Q, W)
    flat_v = valid.reshape(B * Q)
    pos = torch.cumsum(flat_v, 0) - 1
    pos = torch.where(flat_v, pos, budget).clamp(max=budget)
    rows = torch.zeros((budget + 1, W), dtype=words.dtype,
                       device=words.device)
    rows.index_copy_(0, pos, flat_w)    # every dropped row lands on `budget`
    return (rows[:budget], valid.sum(1).to(torch.int32),
            flat_v.sum().to(torch.int32))


def drain_witness_queues_packed(state: BatchedVmState, config,
                                compact_frac: float | dict | None = None):
    """The packed drain: (state, packed) with the queues rewound in place.

    packed is {family: (words, valid)} (dense), or with `compact_frac` set,
    {family: (rows, lane_counts, count)} compacted on the device, with one
    budget fraction for every family or a {family: fraction} dict.  The
    tensors stay on the state's device: `fetch_dense_records` and
    `fetch_compacted_rows` bring them to the host."""
    dense = serialize_all(state, queue_families(config))
    if compact_frac is None:
        packed = dense
    else:
        fracs = (compact_frac if isinstance(compact_frac, dict)
                 else {name: compact_frac for name in dense})
        packed = {name: _compact(words, valid, float(fracs[name]))
                  for name, (words, valid) in dense.items()}
    return rewind_queues(state), packed


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def _valid_rows(name: str, count: int, budget: int) -> int:
    """The rows of a compacted drain to transfer: `count` rounded up to a
    power of two and clipped to the budget; raises on overflow."""
    if count > budget:
        raise RuntimeError(
            f"compacted drain overflow ({name}): {count} valid records "
            f"vs a {budget}-row transfer budget; raise compact_frac")
    n = 1
    while n < max(count, 1):
        n *= 2
    return min(n, budget)


class HostCopy:
    """Tensors ({name: tuple of tensors}) on their way to the host: on the
    card, non_blocking copies into pinned buffers behind one CUDA event;
    on the CPU, the tensors themselves."""

    def __init__(self, tensors: dict):
        self.event = None
        self.host = tensors
        devices = {t.device.type for ts in tensors.values() for t in ts}
        if devices == {"cuda"}:
            self.host = {name: tuple(self._pinned(t) for t in ts)
                         for name, ts in tensors.items()}
            self.event = torch.cuda.Event()
            self.event.record()

    @staticmethod
    def _pinned(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    def wait(self) -> dict:
        """The host tensors, once their copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host


class AsyncDrain:
    """A packed drain on its way to the host.  Dense: the records' copies
    start at once.  Compacted: the per-lane and total counts' copies start
    at once; `start_rows` then copies only the valid rows (once the counts
    are there) and lets the device budget arrays go."""

    def __init__(self, packed: dict, compact: bool):
        self.compact = compact
        self._rows, self._rows_copy = None, None
        if compact:
            self._rows = {name: rows for name, (rows, _, _) in packed.items()}
            self._copy = HostCopy({name: (lc, c) for name, (_, lc, c)
                                   in packed.items()})
        else:
            self._copy = HostCopy(packed)

    def start_rows(self) -> None:
        if not self.compact or self._rows_copy is not None:
            return
        counts = self._copy.wait()
        self._rows_copy = HostCopy({
            name: (rows[:_valid_rows(name, int(counts[name][1]),
                                     rows.shape[0])],)
            for name, rows in self._rows.items()})
        self._rows = None

    def result(self) -> dict:
        """The drain on the host, as `fetch_dense_records` or
        `fetch_compacted_rows` return it."""
        if not self.compact:
            return {name: (words.numpy().view(np.uint32), valid.numpy())
                    for name, (words, valid) in self._copy.wait().items()}
        self.start_rows()
        rows, counts = self._rows_copy.wait(), self._copy.wait()
        return {name: (rows[name][0].numpy().view(np.uint32),
                       counts[name][0].numpy(), np.int32(int(counts[name][1])))
                for name in rows}


def drain_witness_queues_packed_async(state: BatchedVmState, config,
                                      compact_frac: float | dict | None = None
                                      ) -> tuple[BatchedVmState, AsyncDrain]:
    """`drain_witness_queues_packed` without waiting for the host: the
    serialization, compaction and rewind are queued on the device, the
    copies to pinned host buffers started; nothing blocks.  Resolve with
    `AsyncDrain.result()`, which waits for the copies and does not copy
    again."""
    state, packed = drain_witness_queues_packed(state, config, compact_frac)
    return state, AsyncDrain(packed, compact_frac is not None)


def fetch_dense_records(packed: dict) -> dict:
    """A dense drain on the host: {family: (words uint32[B, Q, W], valid
    bool[B, Q])}."""
    return {name: (_u32(words), valid.cpu().numpy())
            for name, (words, valid) in packed.items()}


def fetch_compacted_rows(packed: dict) -> dict:
    """A compacted drain on the host, transferring only the valid rows:
    {family: (rows uint32[>= count, W], lane_counts, count)}.

    The row count is rounded up to a power of two and clipped to the
    budget; a drain whose valid records overflowed the budget raises here.
    """
    out = {}
    for name, (rows, lane_counts, count) in packed.items():
        c = int(count)
        out[name] = (_u32(rows[:_valid_rows(name, c, rows.shape[0])]),
                     lane_counts.cpu().numpy(), np.int32(c))
    return out


def split_records_by_lane(words: np.ndarray, valid: np.ndarray) -> list:
    """[B, Q, W] + [B, Q] -> per-lane [n_b, W] arrays, slot order kept
    (= emission order)."""
    counts = valid.sum(axis=1)
    return np.split(words[valid], np.cumsum(counts)[:-1])


def split_compacted_by_lane(rows: np.ndarray, lane_counts: np.ndarray,
                            count: int) -> list:
    """The compacted counterpart of split_records_by_lane; raises if the
    drain's row budget overflowed."""
    if count > rows.shape[0]:
        raise RuntimeError(
            f"compacted drain overflow: {count} valid records vs a "
            f"{rows.shape[0]}-row transfer budget; raise compact_frac")
    if int(lane_counts.sum()) != count:
        raise ValueError("lane counts do not add up to the record count")
    return np.split(rows[:count], np.cumsum(lane_counts)[:-1])


# ---------------------------------------------------------------------------
# keccak256 digests over ragged packed streams
# ---------------------------------------------------------------------------

def ragged_words(streams: list[np.ndarray],
                 device: torch.device | str = DEFAULT_DEVICE) -> tuple:
    """The sponge's inputs for `streams` (uint32 arrays of any shape, read
    in C order) on `device`: (words int32[W], offsets int64[T + 1], launch
    order int32[T], longest first), made on the host as one buffer and
    copied to the device at once."""
    T = len(streams)
    sizes = np.fromiter((s.size for s in streams), dtype=np.int64, count=T)
    # [offsets as int32 pairs | launch order | words]: the offsets first,
    # so that their int64 view is aligned
    head = 2 * (T + 1) + T
    buf = np.empty(head + int(sizes.sum()), dtype=np.int32)
    offsets = buf[:2 * (T + 1)].view(np.int64)
    offsets[0] = 0
    np.cumsum(sizes, out=offsets[1:])
    # longest first: a warp's threads absorb streams of similar length
    buf[2 * (T + 1):head] = np.argsort(-(sizes // RATE_WORDS), kind="stable")
    if T:
        np.concatenate([np.ascontiguousarray(s, dtype=np.uint32).reshape(-1)
                        for s in streams], out=buf[head:].view(np.uint32))
    dev = torch.from_numpy(buf).to(device)
    return (dev[head:], dev[:2 * (T + 1)].view(torch.int64),
            dev[2 * (T + 1):head])


def stream_digests(streams: list[np.ndarray],
                   device: torch.device | str = DEFAULT_DEVICE
                   ) -> torch.Tensor:
    """keccak256 of each stream's words -> int32[T, 8] digest words on
    `device`: one copy to the device (`ragged_words`) and one launch of the
    sponge."""
    return keccak256_ragged(*ragged_words(streams, device))


def fold_digest_rows(digests: torch.Tensor) -> torch.Tensor:
    """int32[F, T, 8] digest words -> int32[F, 8]: for each f, keccak256
    over its T digests concatenated in order (keccak256 of nothing when T =
    0); one launch of the sponge, the digests read where they are."""
    F, T, _ = digests.shape
    offsets = torch.arange(F + 1, dtype=torch.int64,
                           device=digests.device) * (8 * T)
    order = torch.arange(F, dtype=torch.int32, device=digests.device)
    return keccak256_ragged(digests.contiguous().reshape(-1), offsets, order)


def digest_bytes(rows: torch.Tensor) -> list[bytes]:
    """int32[T, 8] digest words -> T 32-byte digests (one copy to the
    host)."""
    flat = _u32(rows).astype("<u4").tobytes()
    return [flat[i:i + 32] for i in range(0, len(flat), 32)]


def commit_packed_streams(streams: list[np.ndarray],
                          device: torch.device | str = DEFAULT_DEVICE
                          ) -> list[bytes]:
    """Per-stream keccak256 over the concatenated records (uint32 words),
    equal to `era_zk_evm_tpu.witness.packed.commit_packed_streams`: one
    ragged sponge on `device` (`stream_digests`)."""
    return digest_bytes(stream_digests(streams, device))


def fold_digests_device(digests: list[bytes],
                        device: torch.device | str = DEFAULT_DEVICE) -> bytes:
    """block_commitment: keccak256 over the concatenated 32-byte digests
    (keccak256 of nothing when there are none), one sponge launch."""
    rows = (np.stack([np.frombuffer(d, dtype="<u4") for d in digests])
            if digests else np.zeros((0, 8), dtype=np.uint32))
    rows = torch.from_numpy(rows.view(np.int32)).to(device)
    return digest_bytes(fold_digest_rows(rows[None]))[0]


# ---------------------------------------------------------------------------
# Per-stream grand products from packed log records
# ---------------------------------------------------------------------------

def fingerprints(records: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32[N, 32] packed log records -> Goldilocks fingerprints (lo, hi),
    int64[N] each: keccak of the 128-byte record (one padded rate block,
    one K3 permutation on the card), its first 8 digest bytes as a
    little-endian u64, reduced mod p."""
    n = records.shape[0]
    lanes = torch.zeros((n, 25, 2), dtype=torch.int32, device=records.device)
    lanes.view(n, 50)[:, :32] = records
    lanes[:, 16, 0] = 0x01
    lanes[:, 16, 1] = -(1 << 31)          # 0x80000000
    st = keccak_f1600_(lanes, 1)
    return gl_reduce64(wide(st[:, 0, 0]), wide(st[:, 0, 1]))


def log_fingerprints(streams: list[np.ndarray],
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> np.ndarray:
    """The fingerprints of every record of the streams, in order, as one
    uint64 array (computed on `device`)."""
    if not any(s.shape[0] for s in streams):
        return np.zeros((0,), dtype=np.uint64)
    allrec = np.concatenate([s.reshape(-1, 32) for s in streams if s.shape[0]])
    recs = torch.from_numpy(
        np.ascontiguousarray(allrec, dtype=np.uint32).view(np.int32)).to(device)
    lo, hi = fingerprints(recs)
    return (lo.cpu().numpy().astype(np.uint64)
            | (hi.cpu().numpy().astype(np.uint64) << np.uint64(32)))


def grand_products_from_fingerprints(fp: np.ndarray, counts: list[int],
                                     gamma: int | None = None) -> list[int]:
    """Per-stream prod(gamma + fingerprint) mod p, the streams' records
    being consecutive runs of `counts` entries of `fp`; Python ints on the
    host; `gamma` None is `sorted_queue.DEFAULT_GAMMA`."""
    if gamma is None:
        from .sorted_queue import DEFAULT_GAMMA    # it imports this module
        gamma = DEFAULT_GAMMA
    out = []
    pos = 0
    for c in counts:
        acc = 1
        for v in fp[pos:pos + c].tolist():
            acc = acc * ((gamma + v) % GOLDILOCKS_P) % GOLDILOCKS_P
        out.append(acc)
        pos += c
    return out


def packed_grand_products(streams: list[np.ndarray], gamma: int | None = None,
                          device: torch.device | str = DEFAULT_DEVICE
                          ) -> list[int]:
    """Per-stream prod(gamma + fingerprint) mod p over packed log records,
    equal to `era_zk_evm_tpu.witness.packed.packed_grand_products` (the
    product does not depend on the record order)."""
    return grand_products_from_fingerprints(
        log_fingerprints(streams, device), [s.shape[0] for s in streams],
        gamma)


def block_grand_product(products: list[int]) -> int:
    """The block's product over its per-tx products, mod p."""
    acc = 1
    for gp in products:
        acc = acc * gp % GOLDILOCKS_P
    return acc


def log_join_columns(words: np.ndarray):
    """Vectorized (timestamp, address, shard) columns from packed log
    records, the net-state join inputs (models/net_states), without query
    objects."""
    def bsv(col):
        c = col.astype(np.uint32)
        return ((c & 0xFF) << 24) | ((c & 0xFF00) << 8) \
            | ((c >> 8) & 0xFF00) | (c >> 24)

    ts = bsv(words[:, 0])
    shard = (words[:, 1] >> 8) & 0xFF
    address = np.zeros(words.shape[0], dtype=object)
    for i in range(5):
        address = address + (bsv(words[:, 3 + i]).astype(object)
                             << (32 * (4 - i)))
    return ts, address, shard


# ---------------------------------------------------------------------------
# Query structs from packed records
# ---------------------------------------------------------------------------

def _bs(x) -> int:
    """A little-endian u32 record word -> the big-endian field it holds."""
    return int.from_bytes(int(x).to_bytes(4, "little"), "big")


def queries_from_packed(family: str, words: np.ndarray) -> list:
    """Packed records (uint32[n, W]) -> the reference-shaped query objects,
    equal to `era_zk_evm_tpu.witness.packed.queries_from_packed`; the
    precompile family reads as the memory family."""
    out = []
    if family in ("memory", "precompile"):
        for r in words.tolist():
            w1, w2, w3 = r[1], r[2], r[3]
            out.append(MemoryQuery(
                timestamp=_bs(r[0]), memory_type=MemoryType(w1 & 0xFF),
                page=(((w1 >> 8) & 0xFF) << 24) | (((w1 >> 16) & 0xFF) << 16)
                | (((w1 >> 24) & 0xFF) << 8) | (w2 & 0xFF),
                index=(((w2 >> 8) & 0xFF) << 24) | (((w2 >> 16) & 0xFF) << 16)
                | (((w2 >> 24) & 0xFF) << 8) | (w3 & 0xFF),
                value=sum(_bs(r[8 + i]) << (32 * (7 - i)) for i in range(8)),
                rw_flag=bool((w3 >> 8) & 1),
                value_is_pointer=bool((w3 >> 9) & 1)))
    elif family == "log":
        for r in words.tolist():
            w1 = r[1]
            out.append(LogQuery(
                timestamp=_bs(r[0]),
                tx_number_in_block=((w1 >> 24) << 8) | (r[2] & 0xFF),
                aux_byte=w1 & 0xFF, shard_id=(w1 >> 8) & 0xFF,
                address=sum(_bs(r[3 + i]) << (32 * (4 - i))
                            for i in range(5)),
                key=sum(_bs(r[8 + i]) << (32 * (7 - i)) for i in range(8)),
                read_value=sum(_bs(r[16 + i]) << (32 * (7 - i))
                               for i in range(8)),
                written_value=sum(_bs(r[24 + i]) << (32 * (7 - i))
                                  for i in range(8)),
                rw_flag=bool((w1 >> 16) & 1), rollback=False,
                is_service=bool((w1 >> 18) & 1)))
    elif family == "decommit":
        for r in words.tolist():
            out.append(DecommittmentQuery(
                hash=sum(_bs(r[i]) << (32 * (7 - i)) for i in range(8)),
                timestamp=_bs(r[8]), memory_page=_bs(r[9]),
                decommitted_length=_bs(r[10]), is_fresh=bool(r[11] & 1)))
    else:
        raise ValueError(f"unknown queue family {family!r}")
    return out
