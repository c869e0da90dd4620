"""The plain PyTorch cycle step: the reference version of the K1 kernel.

A vectorised translation of `era_zk_evm_tpu/models/batched_vm.py::cycle_step`
for the ported slice: NOP, ADD, SUB, MUL, DIV, JUMP, CONTEXT, SHIFT, BINOP,
PTR, NEAR_CALL, RET and UMA, with register, stack and code addressing, the
heap and aux heap, the memory witness queue and the rolling commitment; and,
with `storage_slots > 0` (the JAX engine's `log_enabled`), the LOG family
(storage reads and writes with pubdata ergs, events and L1 messages, the
journal and its rollback on a panicked pop) and FAR_CALL (code-hash storage
read, decommit from the code bank, far frames with their heap pages), with
the log and decommit witness queues; and, with `precompile_keccak_blocks >
0` as well, the keccak256 and sha256 precompile units with the
round-witness queue at its batch-global block clock, and with
`precompile_ecrecover` the ecrecover unit (`ops/secp256k1.py`, run on the
calling lanes only, in the cycles that have one).  `log.precompile` sets
`lane_error` while the units are off, as the JAX engine does, and so do LOG
and FAR_CALL when `storage_slots == 0`.

Every value is computed in int64 holding a u32 (or a bool), and the state
fields are written back as int32.  `cycle_step` updates the state in place
and returns it; it reads and writes the arrays through their
reference-layout views (`state.reference_view`), so its indexing is the
JAX engine's whatever the stored layout.  The CUDA kernel
`csrc/cycle_kernel.cu` computes the same function one lane per thread;
`models/fused_cycle.py` dispatches between the two by the device of the
state.
"""

from __future__ import annotations

import torch

from ..isa import params
from ..isa.encoding import VARIANT_MASK, exception_revert_encoding
from ..isa.opcodes import (
    ContextOp, FarCallOp, LogOp, Opcode, OperandMode, PtrOp, RetOp, ShiftOp,
    UMAOp, decode_consts,
)

from ..config import (
    CS, SLOTS_PER_CYCLE, VmConfig, check_slice, precompile_queue_slots,
)
from ..ops import u256
from ..ops.keccak import keccak_f1600_lanes
from ..ops.secp256k1 import ecrecover_batched
from ..ops.sha256 import sha256_compress_batched, sha256_iv
from ..ops.u256 import M32, narrow, wide
from ..witness.rolling import rolling_absorb
from .state import BatchedVmState, reference_view

_PANIC_ENC = exception_revert_encoding()
I64 = torch.int64
M16 = 0xFFFF


def _rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[b, idx[b]] per lane; an index outside [0, N) reads zeros (N may
    be 0: a config without journal or event slots)."""
    n = arr.shape[1]
    if n == 0:
        return arr.new_zeros((arr.shape[0],) + arr.shape[2:])
    ok = (idx >= 0) & (idx < n)
    lanes = torch.arange(arr.shape[0], device=arr.device)
    got = arr[lanes, idx.clamp(0, n - 1)]
    ok = ok.view(ok.shape + (1,) * (got.dim() - 1))
    return torch.where(ok, got, torch.zeros_like(got))


def _put_rows(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              mask: torch.Tensor) -> None:
    """arr[b, idx[b]] = val[b] in place where mask[b]; an index outside
    [0, N) writes nothing."""
    n = arr.shape[1]
    if n == 0:
        return
    m = mask & (idx >= 0) & (idx < n)
    lanes = torch.arange(arr.shape[0], device=arr.device)
    i = idx.clamp(0, n - 1)
    if arr.dtype != torch.bool:
        val = narrow(val, arr.dtype)
    old = arr[lanes, i]
    m = m.view(m.shape + (1,) * (old.dim() - 1))
    arr[lanes, i] = torch.where(m, val.expand_as(old), old)


def _word(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """u256 word gather from a word arena ([B, W, 8] or flat [B, W*8])."""
    if arr.dim() == 2:
        arr = arr.view(arr.shape[0], -1, 8)
    return wide(_rows(arr, idx))


def _put_word(arr, idx, val, mask) -> None:
    if arr.dim() == 2:
        arr = arr.view(arr.shape[0], -1, 8)
    _put_rows(arr, idx, val, mask)


def _map_stack_index(config: VmConfig, idx: torch.Tensor):
    """Logical stack index -> physical arena slot + in-window flag (the
    two-window map of the JAX engine)."""
    if config.stack_abs_words is None:
        return idx, idx < config.stack_words
    a = config.stack_abs_words
    s0 = config.stack_sp_base
    w = config.stack_words - a
    in_abs = idx < a
    in_sp = (idx >= s0) & (idx < s0 + w)
    phys = torch.where(in_abs, idx, a + (idx - s0))
    ok = in_abs | in_sp
    return torch.where(ok, phys, torch.full_like(idx, config.stack_words)), ok


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values (in int64) read as int32, as the JAX engine's astype."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _sel(mask, a, b):
    """where with mask broadcast over trailing dims."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - mask.dim())),
                       a, b)


def _cat_zero(x: torch.Tensor) -> torch.Tensor:
    """[B, k] limbs -> [B, 8] with the high limbs zero."""
    z = torch.zeros((x.shape[0], 8 - x.shape[1]), dtype=x.dtype,
                    device=x.device)
    return torch.cat([x, z], dim=1)


def _addr_is_kernel(addr5: torch.Tensor) -> torch.Tensor:
    return (addr5[:, 0] < params.KERNEL_SPACE_BOUND) \
        & (addr5[:, 1:] == 0).all(1)


def _deployer5(like: torch.Tensor) -> torch.Tensor:
    d = torch.zeros((like.shape[0], 5), dtype=I64, device=like.device)
    d[:, 0] = params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS
    return d


def far_call(state, config, src0, src0_tag, src1, vflag0, vflag1,
             sub_variant, is_far_call, active, is_kernel, this_addr,
             msg_sender, frame_u128, shard_this, ergs_after, heap_bound0,
             aux_bound0, heap_page, aux_page) -> dict:
    """The far-call unit of one cycle (far_call.rs:35-613), before any
    frame is pushed: the code-hash storage read, default-AA masking, the
    versioned-hash checks, ABI forwarding, memory growth, decommit cost and
    refund, the code-bank binding (written to `state.cb_page` in place),
    the 63/64 rule and the callee frame's addressing.  Returns the values
    the rest of the cycle reads, by name."""
    lane_error = torch.zeros_like(active)
    fc_delegate = is_far_call & (sub_variant == FarCallOp.DELEGATE)
    fc_mimic = is_far_call & (sub_variant == FarCallOp.MIMIC)
    addr5 = src1[:, :5]
    dst_kernel = _addr_is_kernel(addr5)
    off, page_f, start, length = (src0[:, i] for i in range(4))
    abi7 = src0[:, 7]
    mode = (abi7 >> 8) & 0xFF
    mode = torch.where(mode > 2, 0, mode)
    ctor = (((abi7 >> 16) & 0xFF) != 0) & is_kernel
    to_system = (((abi7 >> 24) & 0xFF) != 0) & dst_kernel
    code_shard = torch.where(vflag1, abi7 & 0xFF, shard_this)
    this_shard = torch.where(fc_delegate, shard_this, code_shard)
    new_base = wide(state.page_counter)

    # code-hash storage read (skipped for the unavailable-shard mapping)
    trivial = code_shard != 0
    do_sread = is_far_call & active & ~trivial
    key14 = torch.cat([_cat_zero(addr5), _deployer5(src0),
                       code_shard[:, None]], dim=1)
    match = (wide(state.st_key) == key14[:, None, :]).all(2) & state.st_used
    hash_storage = torch.where(match[:, :, None], wide(state.st_val),
                               0).sum(1) & M32
    hash_storage = _sel(trivial, torch.zeros_like(hash_storage), hash_storage)
    # default-AA masking for empty slots of user-space targets
    aa = wide(state.default_aa_hash)
    mask_aa = u256.is_zero(hash_storage) & ~dst_kernel & ~trivial
    hash_raw = _sel(mask_aa, aa, hash_storage)

    # versioned-hash validation (the BE byte layout lives in limb 7)
    h7 = hash_raw[:, 7]
    vh_ok = (h7 >> 24) == params.CODE_HASH_VERSION_BYTE
    marker = (h7 >> 16) & 0xFF
    marker_rest = marker == params.CODE_AT_REST_MARKER
    marker_valid = marker_rest | (marker == params.YET_CONSTRUCTED_MARKER)
    can_call = (~ctor & marker_rest) \
        | (ctor & (marker == params.YET_CONSTRUCTED_MARKER))
    callable_direct = vh_ok & marker_valid & can_call
    degrade_aa = vh_ok & marker_valid & ~can_call & ~dst_kernel
    bad_hash = ~vh_ok | ~marker_valid
    ctor_system = vh_ok & marker_valid & ~can_call & dst_kernel
    stored_hash = hash_raw.clone()
    stored_hash[:, 7] = h7 & 0xFF00FFFF          # marker byte -> at rest
    z8 = torch.zeros_like(hash_raw)
    code_hash = _sel(callable_direct, stored_hash, _sel(degrade_aa, aa, z8))
    code_len = torch.where(callable_direct, h7 & 0xFFFF,
                           torch.where(degrade_aa, aa[:, 7] & 0xFFFF, 0))

    # ABI quasi-pointer validation and forwarding (as in ret, vs the caller)
    fwd = mode == 1
    use_aux = mode == 2
    deref = ((start + length) & M32) < start
    exc0 = is_far_call & (bad_hash | ctor_system | (fwd & ~src0_tag) | deref
                          | (~fwd & (off != 0)) | (off > length))
    start2 = torch.where(fwd, (start + off) & M32, start)
    len2 = torch.where(fwd, (length - off) & M32, length)
    off2 = torch.where(fwd, 0, off)
    page2 = torch.where(fwd, page_f, torch.where(use_aux, aux_page, heap_page))
    calldata = _cat_zero(torch.stack(
        [torch.where(exc0, 0, x) for x in (off2, page2, start2, len2)], 1))

    # memory growth paid against the caller frame's bounds
    upper = (calldata[:, 2] + calldata[:, 3]) & M32
    upper = torch.where(is_far_call & deref, M32, upper)
    bound = torch.where(use_aux, aux_bound0, heap_bound0)
    growth_uf = upper < bound
    growth = torch.where(growth_uf | fwd, 0, upper - bound)
    bound_update = is_far_call & ~fwd & ~growth_uf
    new_heap_bound = torch.where(bound_update & ~use_aux, upper, heap_bound0)
    new_aux_bound = torch.where(bound_update & use_aux, upper, aux_bound0)
    cost_growth = (torch.where(is_far_call, growth, 0)
                   * params.MEMORY_GROWTH_ERGS_PER_BYTE) & M32
    no_ergs_grow = ergs_after < cost_growth
    exc1 = exc0 | (is_far_call & no_ergs_grow)
    ergs_a = torch.where(no_ergs_grow, 0, ergs_after - cost_growth)
    cost_decommit = (params.ERGS_PER_CODE_WORD_DECOMMITTMENT * code_len) & M32
    no_ergs_dec = ergs_a < cost_decommit
    exc = exc1 | (is_far_call & no_ergs_dec)
    ergs_b = torch.where(no_ergs_dec, ergs_a, ergs_a - cost_decommit)

    # decommit: bind a pre-staged code-bank slot to the candidate page
    do_decommit = is_far_call & active & ~exc
    bank_match = (wide(state.cb_hash) == code_hash[:, None, :]).all(2) \
        & state.cb_valid
    # an unknown code hash is the VM's single hard error (decommitter.rs)
    lane_error |= do_decommit & ~bank_match.any(1)
    cb_page = wide(state.cb_page)
    bound_page = torch.where(bank_match, cb_page, 0).sum(1) & M32
    fresh = bound_page == 0
    code_page = torch.where(fresh, new_base, bound_page)
    bind = bank_match & (do_decommit & fresh)[:, None]
    state.cb_page.copy_(narrow(torch.where(bind, new_base[:, None], cb_page),
                               torch.int32))
    # a repeat decommit refunds its cost (far_call.rs:450-453)
    ergs_c = torch.where(do_decommit & ~fresh, (ergs_b + cost_decommit) & M32,
                         ergs_b)
    code_page = torch.where(exc, params.UNMAPPED_PAGE, code_page)

    # the 63/64 rule
    max_passable = (ergs_c // 64) * 63
    leftover = ergs_c - max_passable
    want = src0[:, 6]
    over = want > max_passable
    passed = torch.where(over, max_passable, want)
    left = torch.where(over, leftover, leftover + max_passable - want)

    # the callee frame's addresses and context
    mimic_sender = wide(state.regs[:, 14, :5])
    next_sender = _sel(fc_delegate, msg_sender,
                       _sel(fc_mimic, mimic_sender, this_addr))
    heap_slot = state.frame_count.to(I64)
    lane_error |= is_far_call & active & (heap_slot >= config.heap_frames)
    return dict(
        lane_error=lane_error, do_sread=do_sread, do_decommit=do_decommit,
        exc=exc, fresh=fresh, addr5=addr5, code_shard=code_shard,
        this_shard=this_shard, new_base=new_base, hash_storage=hash_storage,
        code_hash=code_hash, code_len=code_len, code_page=code_page,
        calldata=calldata, ctor=ctor, to_system=to_system,
        new_heap_bound=new_heap_bound, new_aux_bound=new_aux_bound,
        passed=passed, left=left, heap_slot=heap_slot,
        next_this=_sel(fc_delegate, this_addr, addr5),
        next_sender=next_sender,
        next_u128=_sel(fc_delegate, frame_u128, wide(state.context_u128)))


def _page_slot(state, config, page):
    """(on the heap, on the aux heap, frame slot) of a page number: the
    heap frames are matched first."""
    frames = torch.arange(config.heap_frames, device=page.device)[None, :]
    hm = wide(state.hp_page) == page[:, None]
    am = wide(state.ap_page) == page[:, None]
    on_h = hm.any(1)
    slot = torch.where(on_h, (hm.to(I64) * frames).sum(1),
                       (am.to(I64) * frames).sum(1))
    return on_h, ~on_h & am.any(1), slot


def _frame_word(state, config, on_h, slot, idx):
    """Word `idx` of a lane's heap frame (on_h) or aux-heap frame `slot`;
    an index outside the arena reads zeros."""
    return _sel(on_h,
                _word(state.heap, (slot * config.heap_words + idx) & M32),
                _word(state.aux_heap, (slot * config.aux_heap_words + idx)
                      & M32))


def _keccak_unit(word, mk, on, in_off, in_len, kc_blocks, kc_last):
    """keccak256 of each `on` lane's input bytes, whose words `word(idx)`
    reads (int64 [B, 8] limbs): a byte-stream sponge over at most `mk`
    136-byte blocks with the padding XORed in; the digest as one big-endian
    u256 (int64 limbs)."""
    B, dev = in_off.shape[0], in_off.device
    lanes = torch.zeros((25, B), dtype=I64, device=dev)
    j = torch.arange(136, device=dev)[None, :]
    for k in range(mk):
        blk_on = on & (k < kc_blocks)
        base_byte = (in_off + k * 136) & M32
        base_word = base_byte >> 5
        window = torch.stack([word((base_word + w) & M32)
                              for w in range(6)], dim=1).flip(-1)  # high first
        window_bytes = torch.stack([(window >> (8 * (3 - t))) & 0xFF
                                    for t in range(4)], dim=-1).reshape(B, 192)
        aligned = torch.gather(window_bytes, 1, (base_byte & 31)[:, None] + j)
        g = j + k * 136
        blk = torch.where(g < in_len[:, None], aligned, 0) \
            ^ torch.where(g == in_len[:, None], 0x01, 0) \
            ^ torch.where(g == kc_last[:, None], 0x80, 0)
        b8 = blk.view(B, 17, 8)
        rate = b8[:, :, 0]
        for t in range(1, 8):
            rate = rate | (b8[:, :, t] << (8 * t))      # u64 bit patterns
        absorbed = lanes.clone()
        absorbed[:17] ^= rate.T
        lanes = torch.where(blk_on[None, :], keccak_f1600_lanes(absorbed),
                            lanes)
    digest = torch.stack([(lanes[i // 8] >> (8 * (i % 8))) & 0xFF
                          for i in range(32)], dim=1)
    return torch.stack([(digest[:, 28 - 4 * w] << 24)
                        | (digest[:, 29 - 4 * w] << 16)
                        | (digest[:, 30 - 4 * w] << 8) | digest[:, 31 - 4 * w]
                        for w in range(8)], dim=1)


def _sha_unit(word, ms, on, in_off, rounds):
    """The sha256 state after each `on` lane's rounds (at most `ms`), two
    input words per round, which `word(idx)` reads, as one big-endian u256
    (int64 limbs)."""
    st = sha256_iv(in_off.shape[0], in_off.device)
    for k in range(ms):
        r_on = on & (k < rounds)
        w0 = word((in_off + 2 * k) & M32)
        w1 = word((in_off + 2 * k + 1) & M32)
        blk = narrow(torch.cat([w0.flip(1), w1.flip(1)], dim=1), torch.int32)
        st = torch.where(r_on[:, None], sha256_compress_batched(st, blk), st)
    return wide(st.flip(1))


def _ec_unit(state, config, on, r_on_h, r_slot, in_off):
    """ecrecover of each `on` lane's four input words (digest, v as the low
    bit of word 1, r, s), on those lanes only: the ok word and the address
    (int64 limbs, zero on the other lanes)."""
    idx = on.nonzero().squeeze(1)
    digest, v_word, r, s = (
        _frame_word(state, config, r_on_h, r_slot, (in_off + i) & M32)[idx]
        for i in range(4))
    ok, addr = ecrecover_batched(digest, v_word[:, 0] & 1, r, s)
    ok_word = torch.zeros((config.batch, 8), dtype=I64, device=on.device)
    ok_word[idx, 0] = ok.to(I64)
    full = torch.zeros_like(ok_word)
    full[idx] = addr
    return ok_word, full


def precompile_unit(state, config, src0, this_addr, do_precomp, heap_page,
                    ts_log) -> dict:
    """The keccak256 / sha256 / ecrecover precompile unit of one cycle
    (log.rs:252-328 and the reference's precompile processor), before any
    write: ABI decode, the page-slot lookups, the sponge, the rounds or the
    recovery, the output word (ecrecover: two) and the lane's row block of
    the round-witness queue.  The heavy parts run only when some lane calls
    a unit.  Returns the values the rest of the cycle reads, by name;
    `pq_rows` is None without a queue."""
    B, dev = config.batch, src0.device
    lane_error = torch.zeros_like(do_precomp)
    in_off, in_len, out_off = src0[:, 0], src0[:, 1], src0[:, 2]
    page_r = torch.where(src0[:, 4] == 0, heap_page, src0[:, 4])
    page_w = torch.where(src0[:, 5] == 0, heap_page, src0[:, 5])
    rounds = src0[:, 6]
    addr16 = this_addr[:, 0] & M16
    is_keccak = do_precomp & (
        addr16 == params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS)
    is_sha = do_precomp & (
        addr16 == params.SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS)
    is_ec = do_precomp & (
        addr16 == params.ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS) \
        & config.precompile_ecrecover
    pp_any = is_keccak | is_sha | is_ec
    key = src0.clone()
    key[:, 4], key[:, 5] = page_r, page_w
    out = dict(lane_error=lane_error, key=key, any=bool(pp_any.any()),
               pq_rows=None)

    kc_blocks = in_len // 136 + 1
    r_on_h, r_on_a, r_slot = _page_slot(state, config, page_r)
    w_on_h, w_on_a, w_slot = _page_slot(state, config, page_w)
    z8 = torch.zeros((B, 8), dtype=I64, device=dev)
    out_val = out_val2 = z8
    if out["any"]:
        lane_error |= pp_any & ~(r_on_h | r_on_a)
        lane_error |= pp_any & ~(w_on_h | w_on_a)
        lane_error |= is_keccak & (kc_blocks > config.precompile_keccak_blocks)
        lane_error |= is_sha & (rounds > max(config.precompile_sha_rounds, 1))
        def word(idx):
            return _frame_word(state, config, r_on_h, r_slot, idx)

        if bool(is_keccak.any()):
            out_val = _keccak_unit(word, config.precompile_keccak_blocks,
                                   is_keccak, in_off, in_len, kc_blocks,
                                   (kc_blocks * 136 - 1) & M32)
        if bool(is_sha.any()):
            out_val = _sel(is_sha, _sha_unit(
                word, max(config.precompile_sha_rounds, 1), is_sha, in_off,
                rounds), out_val)
        if bool(is_ec.any()):
            ok_word, out_val2 = _ec_unit(state, config, is_ec, r_on_h,
                                         r_slot, in_off)
            out_val = _sel(is_ec, ok_word, out_val)
        hw_ok = ((out_off + is_ec) & M32) < torch.where(
            w_on_h, config.heap_words, config.aux_heap_words)
        lane_error |= pp_any & ~hw_ok
        out.update(out_val=out_val, out_val2=out_val2, out_off=out_off,
                   w_slot=w_slot, write_h=pp_any & w_on_h & hw_ok,
                   write_a=pp_any & w_on_a & hw_ok, is_ec=is_ec)

    cap = config.precompile_queue_capacity
    if cap:
        # the round-witness rows, at the batch-global block clock: every
        # cycle writes its block (all zero when no lane emitted) at
        # min(blocks * PS, cap - PS), and advances the clock when any lane
        # ran a unit
        ps_in, ps_out = precompile_queue_slots(config)
        ps = ps_in + ps_out
        blocks0 = int(state.pq_blocks.min())
        overflow = blocks0 * ps > cap - ps
        emit = pp_any & (not overflow)
        lane_error |= pp_any & overflow
        meta = torch.zeros((B, ps, 4), dtype=I64, device=dev)
        value = torch.zeros((B, ps, 8), dtype=I64, device=dev)
        flags = torch.zeros((B, ps), dtype=I64, device=dev)
        first_word = torch.where(is_keccak, in_off >> 5, in_off)
        kq_words = torch.where(
            in_len == 0, 0,
            ((((in_off + in_len - 1) & M32) >> 5) - (in_off >> 5) + 1) & M32)
        n_words = torch.where(is_keccak, kq_words,
                              torch.where(is_sha, (2 * rounds) & M32, 4))
        rounds_q = torch.where(is_keccak, kc_blocks,
                               torch.where(is_sha, rounds, 1))
        lane_error |= emit & (n_words > ps_in)
        if bool(emit.any()):
            for i in range(ps_in):
                v = emit & (i < n_words)
                idx = (first_word + i) & M32
                meta[:, i] = torch.stack([ts_log, torch.full_like(ts_log, 3),
                                          page_r, idx], dim=1) * v[:, None]
                value[:, i] = _frame_word(state, config, r_on_h, r_slot,
                                          idx) * v[:, None]
                flags[:, i] = 4 * v
            for j, (v, val) in enumerate(((emit, out_val),
                                          (emit & is_ec, out_val2))[:ps_out]):
                meta[:, ps_in + j] = torch.stack(
                    [(ts_log + 1) & M32, torch.ones_like(ts_log), page_w,
                     (out_off + j) & M32], dim=1) * v[:, None]
                value[:, ps_in + j] = val * v[:, None]
                # the round count rides on the first out row
                rq = 0 if j else (rounds_q << 3) & M32
                flags[:, ps_in + j] = (5 | rq) * v
        out.update(pq_rows=(meta, value, flags),
                   pq_base=min(blocks0 * ps, cap - ps),
                   pq_count=torch.where(emit, n_words + 1 + is_ec, 0),
                   pq_blocks=int(out["any"]))
    return out


def cycle_step(state: BatchedVmState, config: VmConfig,
               block: tuple | None = None) -> BatchedVmState:
    """Advance every lane by one cycle, in place.

    With the memory queue on, the cycle's 8 memory-query slots go into the
    queue at its block clock.  With the rolling commitment on (beside the
    queue or alone), they are folded into `wc_state` — or, when `block` is
    given as the `(meta, value, flags)` views of 8 rows of a chunk slot
    block, written there for a later fold (the layout the K2 kernel
    reads).
    """
    check_slice(config)
    # every array through its reference-layout view (lane first): writes
    # land in the stored tensors
    stored, state = state, reference_view(state)
    dev = state.done.device
    B, D = config.batch, config.max_depth
    step = int(state.global_step.min())

    def zeros(*shape):
        return torch.zeros(shape, dtype=I64, device=dev)

    frozen = state.done
    active = ~frozen
    lane_error = state.lane_error.clone()

    depth = state.depth.to(I64)
    scal = wide(_rows(state.cs_scalars, depth))             # [B, F]
    this_addr = wide(_rows(state.cs_this_address, depth))
    msg_sender = wide(_rows(state.cs_msg_sender, depth))
    code_addr = wide(_rows(state.cs_code_address, depth))
    frame_u128 = wide(_rows(state.cs_context_u128, depth))

    pc = scal[:, CS["pc"]]
    code_page = scal[:, CS["code_page"]]
    ergs0 = scal[:, CS["ergs_remaining"]]
    flags_word = scal[:, CS["flags_word"]]
    is_static = (flags_word & 1) != 0
    is_local_frame = ((flags_word >> 1) & 1) != 0
    base_page = scal[:, CS["base_memory_page"]]
    heap_bound0 = scal[:, CS["heap_bound"]]
    aux_bound0 = scal[:, CS["aux_heap_bound"]]

    # ---------------------------------------------------------------- fetch
    pending = state.pending_exception
    super_pc = pc >> 2
    sub_pc = pc & 3
    prev_super_pc = wide(state.previous_super_pc)
    pages_differ = code_page != wide(state.previous_code_page)
    code_read_needed = ~pending & (pages_differ | (super_pc != prev_super_pc))

    P = config.code_pages
    cb_match = (wide(state.cb_page) == code_page[:, None]) & state.cb_valid
    code_slot = (cb_match.to(I64)
                 * torch.arange(P, device=dev)[None, :]).sum(1)
    code_page_found = cb_match.any(1)
    fetched = _word(state.code, code_slot * config.code_words + super_pc)
    lane_error |= active & code_read_needed & (
        ~code_page_found | (super_pc >= config.code_words))

    code_word = _sel(code_read_needed, fetched,
                     wide(state.previous_code_word))
    new_prev_super_pc = torch.where(code_read_needed | pending, super_pc,
                                    prev_super_pc)
    new_prev_code_page = code_page

    lo_idx = 6 - 2 * sub_pc
    insn_lo = torch.gather(code_word, 1, lo_idx[:, None])[:, 0]
    insn_hi = torch.gather(code_word, 1, lo_idx[:, None] + 1)[:, 0]
    insn_lo = torch.where(pending, _PANIC_ENC & M32, insn_lo)
    insn_hi = torch.where(pending, _PANIC_ENC >> 32, insn_hi)
    new_pending = torch.zeros_like(pending)

    # ------------------------------------------------- decode + masking
    raw_variant = insn_lo & VARIANT_MASK
    condition = (insn_lo >> 11) & 7
    src0_reg = (insn_lo >> 16) & 0xF
    src1_reg = (insn_lo >> 20) & 0xF
    dst0_reg = (insn_lo >> 24) & 0xF
    dst1_reg = (insn_lo >> 28) & 0xF
    imm0 = insn_hi & M16
    imm1 = (insn_hi >> 16) & M16

    dc = {k: torch.as_tensor(v.astype("int64"), device=dev)
          for k, v in decode_consts().items()}
    fam16 = (raw_variant[:, None] >= dc["start"][None, :]).sum(1) - 1
    f_start, f_nflags, f_ndst, f_nsrc, f_srcbase, f_dstbase = (
        dc[k][fam16] for k in ("start", "n_flags", "n_dst", "n_src",
                               "src_base", "dst_base"))
    rr = raw_variant - f_start
    combo = rr % f_nflags
    rr = rr // f_nflags
    dst_i = rr % f_ndst
    rr = rr // f_ndst
    src_i = rr % f_nsrc
    sub_raw = rr // f_nsrc
    src0_mode_raw = f_srcbase + src_i
    dst0_mode_raw = f_dstbase + dst_i
    flag0_raw = (combo & 1) != 0
    flag1_raw = ((combo >> 1) & 1) != 0

    OP = Opcode
    invalid = fam16 == OP.INVALID
    requires_kernel = ((fam16 == OP.CONTEXT)
                       & (sub_raw >= ContextOp.SET_CONTEXT_U128)) \
        | ((fam16 == OP.LOG) & (sub_raw == LogOp.PRECOMPILE_CALL)) \
        | ((fam16 == OP.FAR_CALL) & (sub_raw == FarCallOp.MIMIC))
    allowed_in_static = ~(
        ((fam16 == OP.LOG) & (sub_raw >= LogOp.STORAGE_WRITE)
         & (sub_raw <= LogOp.TO_L1_MESSAGE))
        | ((fam16 == OP.CONTEXT) & (sub_raw == ContextOp.SET_CONTEXT_U128)))

    M = OperandMode
    rich = ((src0_mode_raw >= M.FULL_STACK_PUSH_POP)
            & (src0_mode_raw != M.FULL_IMM16)) \
        | ((dst0_mode_raw >= M.FULL_STACK_PUSH_POP)
           & (dst0_mode_raw <= M.FULL_ABS_STACK))
    p = params
    alu_like = (fam16 <= OP.JUMP) | (fam16 == OP.SHIFT) \
        | (fam16 == OP.BINOP) | (fam16 == OP.PTR)
    price = torch.where(rich, p.RICH_ADDRESSING_OPCODE_ERGS,
                        p.AVERAGE_OPCODE_ERGS)
    log_prices = torch.tensor([p.STORAGE_READ_IO_PRICE,
                               p.STORAGE_WRITE_IO_PRICE, p.EVENT_IO_PRICE,
                               p.L1_MESSAGE_IO_PRICE,
                               p.PRECOMPILE_CALL_BASE_PRICE], device=dev)
    log_price = torch.where(sub_raw < 5, log_prices[sub_raw.clamp(0, 4)], 0)
    price = torch.where(
        alu_like | (fam16 == OP.CONTEXT), price,
        torch.where(fam16 == OP.LOG, log_price,
        torch.where(fam16 == OP.NEAR_CALL, p.NEAR_CALL_ERGS,
        torch.where(fam16 == OP.FAR_CALL, p.FAR_CALL_ERGS,
        torch.where(fam16 == OP.RET, p.RET_ERGS,
        torch.where(fam16 == OP.UMA, p.UMA_ERGS,
                    p.INVALID_OPCODE_ERGS))))))

    not_enough = ergs0 < price
    ergs1 = torch.where(not_enough, 0, ergs0 - price)

    is_kernel = _addr_is_kernel(this_addr)
    callstack_full = depth >= params.VM_MAX_STACK_DEPTH
    mask_panic = invalid | not_enough | (requires_kernel & ~is_kernel) \
        | (~allowed_in_static & is_static) | callstack_full

    lt_f, eq_f, gt_f = state.flags[:, 0], state.flags[:, 1], state.flags[:, 2]
    cond_table = torch.stack([
        torch.ones_like(lt_f), gt_f, lt_f, eq_f, gt_f | eq_f, lt_f | eq_f,
        ~eq_f, gt_f | lt_f], dim=1)
    cond_met = torch.gather(cond_table, 1, condition[:, None])[:, 0]
    mask_nop = ~cond_met & ~mask_panic

    zeroed = mask_panic | mask_nop
    src0_reg, src1_reg, dst0_reg, dst1_reg, imm0, imm1 = (
        torch.where(zeroed, 0, x)
        for x in (src0_reg, src1_reg, dst0_reg, dst1_reg, imm0, imm1))

    def ov(raw_field, panic_const, nop_const):
        return torch.where(mask_panic, int(panic_const),
                           torch.where(mask_nop, int(nop_const), raw_field))

    opcode = ov(fam16, OP.RET, OP.NOP)
    sub_variant = ov(sub_raw, RetOp.PANIC, 0)
    src0_mode = ov(src0_mode_raw, M.REG_ONLY, M.FULL_REG)
    dst0_mode = ov(dst0_mode_raw, M.REG_ONLY, M.FULL_REG)
    vflag0 = flag0_raw & ~zeroed
    vflag1 = flag1_raw & ~zeroed
    set_flags = vflag0 & (((opcode >= OP.ADD) & (opcode <= OP.DIV))
                          | (opcode == OP.SHIFT) | (opcode == OP.BINOP))
    swap_operands = (vflag1 & ((opcode == OP.SUB) | (opcode == OP.DIV)
                               | (opcode == OP.SHIFT))) \
        | (vflag0 & (opcode == OP.PTR))
    src0_can_ptr = (opcode == OP.PTR) | (opcode == OP.RET) \
        | (opcode == OP.FAR_CALL) \
        | ((opcode == OP.UMA) & (sub_variant == UMAOp.FAT_POINTER_READ))
    src1_can_ptr = opcode == OP.PTR

    def read_reg(idx):
        # r0 reads as zero: index -1 lies outside the register file
        return wide(_rows(state.regs, idx - 1)), _rows(state.reg_ptr, idx - 1)

    # ------------------------------------------------ operand addressing
    sp0 = scal[:, CS["sp"]]
    src0_reg_val, src0_reg_tag = read_reg(src0_reg)
    vaddr0 = ((src0_reg_val[:, 0] & M16) + imm0) & M16
    src0_pushpop = src0_mode == M.FULL_STACK_PUSH_POP
    src0_stack_off = src0_mode == M.FULL_STACK_OFFSET
    src0_abs = src0_mode == M.FULL_ABS_STACK
    src0_code = src0_mode == M.FULL_CODE_PAGE
    sp1 = torch.where(src0_pushpop, (sp0 - vaddr0) & M16, sp0)
    src0_loc = torch.where(src0_pushpop, sp1,
                           torch.where(src0_stack_off, (sp1 - vaddr0) & M16,
                                       vaddr0))
    src0_is_stack_mem = src0_pushpop | src0_stack_off | src0_abs

    dst0_reg_val, _ = read_reg(dst0_reg)
    vaddr1 = ((dst0_reg_val[:, 0] & M16) + imm1) & M16
    dst0_pushpop = dst0_mode == M.FULL_STACK_PUSH_POP
    dst0_stack_off = dst0_mode == M.FULL_STACK_OFFSET
    dst0_abs = dst0_mode == M.FULL_ABS_STACK
    sp2 = torch.where(dst0_pushpop, (sp1 + vaddr1) & M16, sp1)
    dst0_loc = torch.where(dst0_pushpop, sp1,
                           torch.where(dst0_stack_off, (sp2 - vaddr1) & M16,
                                       vaddr1))
    dst0_is_stack_mem = dst0_pushpop | dst0_stack_off | dst0_abs

    is_nop_op = opcode == OP.NOP
    do_src0_mem_read = (src0_is_stack_mem | src0_code) & ~is_nop_op

    src0_phys, src0_in_window = _map_stack_index(config, src0_loc)
    stack_val = _word(state.stack, src0_phys)
    stack_tag = _rows(state.stack_ptr_tag, src0_phys)
    code_val = _word(state.code, code_slot * config.code_words + src0_loc)
    lane_error |= active & do_src0_mem_read & src0_is_stack_mem \
        & ~src0_in_window
    lane_error |= active & do_src0_mem_read & src0_code \
        & (src0_loc >= config.code_words)

    src0_mem_val = _sel(src0_code, code_val, stack_val)
    src0_mem_tag = ~src0_code & stack_tag & do_src0_mem_read

    use_reg = (src0_mode == M.REG_ONLY) | (src0_mode == M.FULL_REG) \
        | (src0_mode == M.REG_OR_IMM_REG)
    use_imm = (src0_mode == M.FULL_IMM16) | (src0_mode == M.REG_OR_IMM_IMM)
    src0 = _sel(use_reg, src0_reg_val,
                _sel(use_imm, u256.from_u32_scalar(imm0), src0_mem_val))
    src0_tag = torch.where(use_reg, src0_reg_tag, ~use_imm & src0_mem_tag)
    src1, src1_tag = read_reg(src1_reg)

    src0, src1 = (_sel(swap_operands, src1, src0),
                  _sel(swap_operands, src0, src1))
    src0_tag, src1_tag = (torch.where(swap_operands, src1_tag, src0_tag),
                          torch.where(swap_operands, src0_tag, src1_tag))

    new_pc_lin = (pc + 1) & M16

    # pointer-taint erasure: clear page/start/length limbs
    def erase(val, tag, can_ptr):
        do = tag & ~can_ptr & ~is_kernel
        erased = val.clone()
        erased[:, 1:4] = 0
        return _sel(do, erased, val), tag & ~do

    src0, src0_tag = erase(src0, src0_tag, src0_can_ptr)
    src1, src1_tag = erase(src1, src1_tag, src1_can_ptr)

    # ================================================== opcode semantics
    is_add = opcode == OP.ADD
    is_sub = opcode == OP.SUB
    is_mul = opcode == OP.MUL
    is_div = opcode == OP.DIV
    is_jump = opcode == OP.JUMP
    is_ctx = opcode == OP.CONTEXT
    is_shift = opcode == OP.SHIFT
    is_binop = opcode == OP.BINOP
    is_ptr = opcode == OP.PTR
    is_near_call = opcode == OP.NEAR_CALL
    is_ret = opcode == OP.RET
    is_uma = opcode == OP.UMA
    is_log = opcode == OP.LOG
    # without their units, LOG / FAR_CALL and log.precompile are errors
    log_enabled = config.storage_slots > 0
    precompile_enabled = log_enabled and config.precompile_keccak_blocks > 0
    if not log_enabled:
        unsupported = (opcode == OP.FAR_CALL) | is_log
    elif not precompile_enabled:
        unsupported = is_log & (sub_variant == LogOp.PRECOMPILE_CALL)
    else:
        unsupported = torch.zeros_like(is_log)
    lane_error |= active & unsupported

    sum_val, carry = u256.add(src0, src1)
    diff_val, borrow = u256.sub(src0, src1)
    if bool(is_mul.any()):
        mul_lo, mul_hi = u256.mul_full(src0, src1)
    else:
        mul_lo = mul_hi = torch.zeros_like(src0)
    if bool(is_div.any()):
        div_q, div_r = u256.div_mod(src0, src1)
    else:
        div_q = div_r = torch.zeros_like(src0)
    div_by_zero = u256.is_zero(src1)

    shift_amount = src1[:, 0] & 0xFF
    if bool(is_shift.any()):
        s = sub_variant
        shift_val = _sel(s == ShiftOp.SHL, u256.shl(src0, shift_amount),
                    _sel(s == ShiftOp.SHR, u256.shr(src0, shift_amount),
                    _sel(s == ShiftOp.ROL, u256.rol(src0, shift_amount),
                         u256.ror(src0, shift_amount))))
    else:
        shift_val = torch.zeros_like(src0)

    binop_val = _sel(sub_variant == 0, src0 ^ src1,
                     _sel(sub_variant == 1, src0 & src1, src0 | src1))

    # ---------------------------------------------------------- context
    ctx_sub = sub_variant
    meta = zeros(B, 8)
    meta[:, 0] = wide(state.ergs_per_pubdata)
    meta[:, 2] = heap_bound0
    meta[:, 3] = aux_bound0
    sid = scal[:, CS["shard_ids"]]
    meta[:, 7] = (sid & 0xFF) | (((sid >> 8) & 0xFF) << 8) \
        | (((sid >> 16) & 0xFF) << 16)
    ctx_val = _sel(ctx_sub == ContextOp.THIS, _cat_zero(this_addr),
              _sel(ctx_sub == ContextOp.CALLER, _cat_zero(msg_sender),
              _sel(ctx_sub == ContextOp.CODE_ADDRESS, _cat_zero(code_addr),
              _sel(ctx_sub == ContextOp.META, meta,
              _sel(ctx_sub == ContextOp.ERGS_LEFT, u256.from_u32_scalar(ergs1),
              _sel(ctx_sub == ContextOp.SP, u256.from_u32_scalar(sp2),
                   _cat_zero(frame_u128)))))))
    ctx_writes_dst = is_ctx & (ctx_sub <= ContextOp.GET_CONTEXT_U128)
    ctx_set_u128 = is_ctx & (ctx_sub == ContextOp.SET_CONTEXT_U128)
    ctx_set_pubdata = is_ctx & (ctx_sub == ContextOp.SET_ERGS_PER_PUBDATA_BYTE)
    ctx_inc_tx = is_ctx & (ctx_sub == ContextOp.INCREMENT_TX_NUMBER)

    new_context_u128 = _sel(ctx_set_u128, src0[:, :4],
                            wide(state.context_u128))
    new_ergs_per_pubdata = torch.where(ctx_set_pubdata, src0[:, 0],
                                       wide(state.ergs_per_pubdata))
    tx = wide(state.tx_number)
    new_tx_number = torch.where(ctx_inc_tx, (tx + 1) & M16, tx)

    # ---------------------------------------------------------- ptr ops
    ptr_sub = sub_variant
    fp_offset = src0[:, 0]
    fp_length = src0[:, 3]
    src1_low32 = src1[:, 0]
    src1_ge_2_32 = (src1[:, 1:] != 0).any(1)
    ptr_basic_panic = is_ptr & (~src0_tag | src1_tag)
    ptr_addsub = is_ptr & (ptr_sub <= PtrOp.SUB)
    ptr_range_panic = ptr_addsub & src1_ge_2_32
    new_off_add = (fp_offset + src1_low32) & M32
    add_of = new_off_add < fp_offset
    new_off_sub = (fp_offset - src1_low32) & M32
    sub_uf = fp_offset < src1_low32
    ptr_off_panic = is_ptr & (((ptr_sub == PtrOp.ADD) & add_of)
                              | ((ptr_sub == PtrOp.SUB) & sub_uf))
    src1_low128_nz = (src1[:, :4] != 0).any(1)
    ptr_pack_panic = is_ptr & (ptr_sub == PtrOp.PACK) & src1_low128_nz
    new_len = (fp_length - src1_low32) & M32
    shrink_uf = fp_length < src1_low32
    ptr_shrink_panic = is_ptr & (ptr_sub == PtrOp.SHRINK) & shrink_uf
    ptr_panic = ptr_basic_panic | ptr_range_panic | ptr_off_panic \
        | ptr_pack_panic | ptr_shrink_panic

    ptr_result = src0.clone()
    ptr_result[:, 0] = torch.where(
        ptr_sub == PtrOp.ADD, new_off_add,
        torch.where(ptr_sub == PtrOp.SUB, new_off_sub, src0[:, 0]))
    ptr_result[:, 3] = torch.where(ptr_sub == PtrOp.SHRINK, new_len,
                                   src0[:, 3])
    pack_result = torch.cat([src0[:, :4], src1[:, 4:]], dim=1)
    ptr_result = _sel(ptr_sub == PtrOp.PACK, pack_result, ptr_result)
    ptr_writes = is_ptr & ~ptr_panic

    # -------------------------------------------------------------- UMA
    uma_sub = sub_variant
    uma_is_heap = is_uma & ((uma_sub == UMAOp.HEAP_READ)
                            | (uma_sub == UMAOp.HEAP_WRITE))
    uma_is_aux = is_uma & ((uma_sub == UMAOp.AUX_HEAP_READ)
                           | (uma_sub == UMAOp.AUX_HEAP_WRITE))
    uma_is_ptr_read = is_uma & (uma_sub == UMAOp.FAT_POINTER_READ)
    uma_is_read = (is_uma & ((uma_sub == UMAOp.HEAP_READ)
                             | (uma_sub == UMAOp.AUX_HEAP_READ))) \
        | uma_is_ptr_read
    uma_is_write = is_uma & ~uma_is_read
    uma_increment = is_uma & vflag0

    u_offset = src0[:, 0]
    u_page_field = src0[:, 1]
    u_start = src0[:, 2]
    u_length = src0[:, 3]

    heap_page = (base_page + 2) & M32
    aux_page = (base_page + 3) & M32
    cur_heap_slot = scal[:, CS["heap_slot"]]

    uma_exc_not_ptr = uma_is_ptr_read & ~src0_tag
    uma_skip_oob_ptr = uma_is_ptr_read & ~(u_offset < u_length)
    src0_gt_max = (src0[:, 1:] != 0).any(1) \
        | (u_offset > params.MAX_OFFSET_TO_DEREF)
    uma_exc_deref = (uma_is_heap | uma_is_aux) & src0_gt_max
    src_byte_off = torch.where(uma_is_ptr_read, (u_start + u_offset) & M32,
                               u_offset)

    incremented = (u_offset + 32) & M32
    uma_exc_incr = is_uma & (incremented < u_offset)

    # heap growth (uma.rs:152-217)
    cur_bound = torch.where(uma_is_heap, heap_bound0, aux_bound0)
    growth_uf = incremented < cur_bound
    growth = torch.where(growth_uf | ~(uma_is_heap | uma_is_aux), 0,
                         incremented - cur_bound)
    new_heap_bound_u = torch.where(uma_is_heap & ~growth_uf, incremented,
                                   heap_bound0)
    new_aux_bound_u = torch.where(uma_is_aux & ~growth_uf, incremented,
                                  aux_bound0)

    uma_cost = (growth * params.MEMORY_GROWTH_ERGS_PER_BYTE) & M32
    uma_cost = torch.where(uma_exc_deref, M32, uma_cost)
    uma_cost = torch.where(is_uma, uma_cost, 0)
    uma_no_ergs = ergs1 < uma_cost
    ergs2 = torch.where(uma_no_ergs, 0, ergs1 - uma_cost)

    uma_set_panic = is_uma & (uma_exc_not_ptr | uma_exc_deref | uma_exc_incr
                              | uma_no_ergs)
    uma_skip_mem = uma_skip_oob_ptr | uma_set_panic

    word0 = src_byte_off >> 5
    word1 = word0 + 1
    unalign = src_byte_off & 31
    is_unaligned = unalign != 0

    F = config.heap_frames
    frames = torch.arange(F, device=dev)[None, :]
    hp_match = wide(state.hp_page) == u_page_field[:, None]
    ap_match = wide(state.ap_page) == u_page_field[:, None]
    ptr_heap_slot = (hp_match.to(I64) * frames).sum(1)
    ptr_aux_slot = (ap_match.to(I64) * frames).sum(1)
    ptr_page_is_heap = uma_is_ptr_read & hp_match.any(1)
    ptr_page_is_aux = uma_is_ptr_read & ~ptr_page_is_heap & ap_match.any(1)
    lane_error |= active & uma_is_ptr_read & ~uma_skip_mem \
        & ~(ptr_page_is_heap | ptr_page_is_aux)
    use_heap_arena = uma_is_heap | ptr_page_is_heap
    use_aux_arena = uma_is_aux | ptr_page_is_aux
    uma_slot = torch.where(uma_is_ptr_read,
                           torch.where(ptr_page_is_heap, ptr_heap_slot,
                                       ptr_aux_slot),
                           cur_heap_slot)

    do_mem = is_uma & ~uma_skip_mem
    hw_err = do_mem & use_heap_arena & (word1 >= config.heap_words)
    aw_err = do_mem & use_aux_arena & (word1 >= config.aux_heap_words)
    lane_error |= active & (hw_err | aw_err)

    h_base = (uma_slot * config.heap_words) & M32
    a_base = (uma_slot * config.aux_heap_words) & M32
    z8 = zeros(B, 8)
    w0 = _sel(do_mem, _sel(use_heap_arena,
                           _word(state.heap, (h_base + word0) & M32),
                           _word(state.aux_heap, (a_base + word0) & M32)), z8)
    w1 = _sel(do_mem & is_unaligned,
              _sel(use_heap_arena,
                   _word(state.heap, (h_base + word1) & M32),
                   _word(state.aux_heap, (a_base + word1) & M32)), z8)

    una_bits = unalign * 8
    read_val = u256.shl(w0, una_bits) | u256.shr(w1, 256 - una_bits)
    # fat-pointer tail cleanup (uma.rs:305-320)
    beyond_uf = incremented < u_length
    beyond = torch.where(beyond_uf | uma_skip_mem, 0,
                         incremented - u_length) & 31
    bb = beyond * 8
    read_val = _sel(uma_is_ptr_read, u256.shl(u256.shr(read_val, bb), bb),
                    read_val)

    keep_hi_bits = (32 - unalign) * 8
    new_w0 = u256.shl(u256.shr(w0, keep_hi_bits), keep_hi_bits) \
        | u256.shr(src1, una_bits)
    new_w1 = u256.shr(u256.shl(w1, una_bits), una_bits) \
        | u256.shl(src1, keep_hi_bits)

    uma_do_write = uma_is_write & ~uma_skip_mem
    uma_do_read_mem = is_uma & ~uma_skip_mem
    incremented_src0 = src0.clone()
    incremented_src0[:, 0] = incremented

    # ------------------------------------------------------ log family
    # pubdata ergs first, then the storage / event action (log.rs)
    shard_this = scal[:, CS["shard_ids"]] & 0xFF
    ts_log = (wide(state.timestamp) + 1) & M32
    no_lane = torch.zeros_like(active)
    do_sread = do_swrite = do_event = do_precomp = l_precomp = no_lane
    ergs_after = ergs2
    if log_enabled:
        S = config.storage_slots
        l_sread = is_log & (sub_variant == LogOp.STORAGE_READ)
        l_swrite = is_log & (sub_variant == LogOp.STORAGE_WRITE)
        l_event = is_log & (sub_variant == LogOp.EVENT)
        l_tol1 = is_log & (sub_variant == LogOp.TO_L1_MESSAGE)
        l_precomp = is_log & (sub_variant == LogOp.PRECOMPILE_CALL)
        epp = wide(state.ergs_per_pubdata)
        ergs_on_pubdata = torch.where(
            l_swrite & (shard_this == 0),
            (epp * params.INITIAL_STORAGE_WRITE_PUBDATA_BYTES) & M32,
            torch.where(l_tol1, (epp * params.L1_MESSAGE_PUBDATA_BYTES) & M32,
                        0))
        log_total_cost = (ergs_on_pubdata
                          + torch.where(l_precomp, src1[:, 0], 0)) & M32
        log_not_enough = log_total_cost > ergs2
        ergs_after = torch.where(
            is_log & log_not_enough, 0,
            (ergs2 - torch.where(is_log, log_total_cost, 0)) & M32)
        spent = torch.where(log_not_enough,
                            torch.minimum(ergs2, ergs_on_pubdata),
                            ergs_on_pubdata)
        new_spent_pubdata = (wide(state.spent_pubdata)
                             + torch.where(active & is_log, spent, 0)) & M32

        # compare-all lookup over the lane's KV slots
        key14 = torch.cat([src0, this_addr, shard_this[:, None]], dim=1)
        slot_match = (wide(state.st_key) == key14[:, None, :]).all(2) \
            & state.st_used                                   # [B, S]
        slot_found = slot_match.any(1)
        current_val = torch.where(slot_match[:, :, None], wide(state.st_val),
                                  0).sum(1) & M32

        do_sread = l_sread & active
        do_swrite = l_swrite & active & ~log_not_enough
        do_event = (l_event | l_tol1) & active & ~log_not_enough
        do_precomp = l_precomp & active & ~log_not_enough

        # write target: the match, or a fresh slot at st_count
        st_count = state.st_count.to(I64)
        fresh = do_swrite & ~slot_found
        lane_error |= fresh & (st_count >= S)
        slots_iota = torch.arange(S, device=dev)[None, :]
        fresh_oh = (slots_iota == st_count[:, None]) & fresh[:, None]
        write_oh = (slot_match & do_swrite[:, None]) | fresh_oh
        state.st_key.copy_(_sel(fresh_oh, narrow(key14, torch.int32)[:, None],
                                state.st_key))
        state.st_val.copy_(_sel(write_oh, narrow(src1, torch.int32)[:, None],
                                state.st_val))
        state.st_used |= fresh_oh
        new_st_count = st_count + fresh.to(I64)
        write_slot = (write_oh.to(I64) * slots_iota).sum(1)

        # journal (slot, previous value) for rollback; events
        j_count = state.j_count.to(I64)
        lane_error |= do_swrite & (j_count >= config.journal_slots)
        _put_rows(state.j_slot, j_count, write_slot, do_swrite)
        _put_rows(state.j_prev, j_count, current_val, do_swrite)
        new_j_count = j_count + do_swrite.to(I64)

        ev_count = state.ev_count.to(I64)
        lane_error |= do_event & (ev_count >= config.event_slots)
        aux_byte = torch.where(l_event, params.EVENT_AUX_BYTE,
                               params.L1_MESSAGE_AUX_BYTE)
        ev_meta_row = torch.stack(
            [ts_log, aux_byte | (vflag0.to(I64) << 8)
             | ((wide(state.tx_number) << 16) & M32)], dim=1)
        _put_rows(state.ev_key, ev_count, src0, do_event)
        _put_rows(state.ev_val, ev_count, src1, do_event)
        _put_rows(state.ev_meta, ev_count, ev_meta_row, do_event)
        new_ev_count = ev_count + do_event.to(I64)

    # -------------------------------------------------- precompile units
    pp = None
    if precompile_enabled:
        pp = precompile_unit(state, config, src0, this_addr, do_precomp,
                             heap_page, ts_log)
        lane_error |= pp["lane_error"]

    # -------------------------------------------------------- near call
    nc_abi = src0[:, 0]
    nc_pass_all = (nc_abi == 0) | (nc_abi > ergs_after)
    nc_passed = torch.where(nc_pass_all, ergs_after, nc_abi)
    nc_left = torch.where(nc_pass_all, 0, ergs_after - nc_abi)

    # -------------------------------------------------------------- ret
    ret_sub = sub_variant
    ret_is_panic0 = is_ret & (ret_sub == RetOp.PANIC)
    ret_src0 = _sel(ret_is_panic0, torch.zeros_like(src0), src0)
    ret_src0_tag = src0_tag & ~ret_is_panic0
    r_off = ret_src0[:, 0]
    r_page = ret_src0[:, 1]
    r_start = ret_src0[:, 2]
    r_len = ret_src0[:, 3]
    r_mode = (ret_src0[:, 7] >> 8) & 0xFF
    r_mode = torch.where(r_mode > 2, 0, r_mode)
    r_fwd = r_mode == 1
    r_use_aux = r_mode == 2

    nonlocal_ret = is_ret & ~is_local_frame
    rp_not_ptr = r_fwd & ~ret_src0_tag
    rp_back_fwd = r_fwd & (r_page < base_page)
    r_deref_exc = ((r_start + r_len) & M32) < r_start
    r_off_exc = ~r_fwd & (r_off != 0)
    rp_slice = r_off > r_len
    ret_panic1 = nonlocal_ret & (rp_not_ptr | rp_back_fwd | r_deref_exc
                                 | r_off_exc | rp_slice)
    ret_escalated = ret_is_panic0 | ret_panic1
    r_off, r_page, r_start, r_len = (torch.where(ret_escalated, 0, x)
                                     for x in (r_off, r_page, r_start, r_len))
    fwd_now = nonlocal_ret & ~ret_escalated & r_fwd
    r_start = torch.where(fwd_now, (r_start + r_off) & M32, r_start)
    r_len = torch.where(fwd_now, (r_len - r_off) & M32, r_len)
    r_off = torch.where(fwd_now, 0, r_off)
    r_page = torch.where(nonlocal_ret & ~ret_escalated & ~r_fwd,
                         torch.where(r_use_aux, aux_page, heap_page), r_page)
    r_upper = (r_start + r_len) & M32
    r_upper = torch.where(nonlocal_ret & r_deref_exc, M32, r_upper)
    r_bound = torch.where(r_use_aux, aux_bound0, heap_bound0)
    r_growth = torch.where((r_upper < r_bound) | ~(nonlocal_ret & ~r_fwd), 0,
                           r_upper - r_bound)
    r_cost = (r_growth * params.MEMORY_GROWTH_ERGS_PER_BYTE) & M32
    r_no_ergs = ergs_after < r_cost
    ergs3 = torch.where(is_ret & ~r_no_ergs, ergs_after - r_cost,
                        torch.where(is_ret & r_no_ergs, 0, ergs_after))
    ret_panic2 = nonlocal_ret & r_no_ergs
    ret_final_panic = ret_escalated | ret_panic2
    r_off, r_page, r_start, r_len = (torch.where(ret_panic2, 0, x)
                                     for x in (r_off, r_page, r_start, r_len))
    ret_panicked = is_ret & ((ret_sub == RetOp.REVERT) | ret_final_panic)
    is_to_label = is_ret & vflag0

    returndata_u256 = _cat_zero(torch.stack([r_off, r_page, r_start, r_len],
                                            dim=1))

    # ------------------------------------------- far call (far_call.rs)
    is_far_call = (opcode == OP.FAR_CALL) & log_enabled
    fc_do_sread = fc_do_decommit = no_lane
    if log_enabled:
        fc = far_call(state, config, src0, src0_tag, src1, vflag0, vflag1,
                      sub_variant, is_far_call, active, is_kernel, this_addr,
                      msg_sender, frame_u128, shard_this, ergs_after,
                      heap_bound0, aux_bound0, heap_page, aux_page)
        lane_error |= fc["lane_error"]
        fc_do_sread, fc_do_decommit = fc["do_sread"], fc["do_decommit"]

    # =================================================== flags writeback
    cb_ = carry != 0
    bb_ = borrow != 0
    add_eq = u256.is_zero(sum_val)
    sub_eq = u256.is_zero(diff_val)
    mul_of = ~u256.is_zero(mul_hi)
    mul_eq = u256.is_zero(mul_lo)
    div_eq = u256.is_zero(div_q)
    div_gt = u256.is_zero(div_r)
    f_ = torch.zeros_like(cb_)
    new_lt = torch.where(is_add, cb_, torch.where(is_sub, bb_, f_))
    new_eq = torch.where(is_add, add_eq, torch.where(is_sub, sub_eq, f_))
    new_gt = torch.where(is_add, ~add_eq & ~cb_,
                         torch.where(is_sub, ~sub_eq & ~bb_, f_))
    new_lt = torch.where(is_mul, mul_of, new_lt)
    new_eq = torch.where(is_mul, mul_eq, new_eq)
    new_gt = torch.where(is_mul, ~mul_of & ~mul_eq, new_gt)
    new_lt = torch.where(is_div, div_by_zero, new_lt)
    new_eq = torch.where(is_div, div_eq & ~div_by_zero, new_eq)
    new_gt = torch.where(is_div, div_gt & ~div_by_zero, new_gt)
    new_eq = torch.where(is_shift, u256.is_zero(shift_val), new_eq)
    new_lt = new_lt & ~(is_shift | is_binop)
    new_gt = new_gt & ~(is_shift | is_binop)
    new_eq = torch.where(is_binop, u256.is_zero(binop_val), new_eq)

    writes_flags = set_flags & (is_add | is_sub | is_mul | is_div
                                | is_shift | is_binop)
    resets_flags = is_near_call | is_ret | is_far_call
    ret_sets_lt = is_ret & ret_final_panic
    new_flags = torch.stack([
        torch.where(writes_flags, new_lt,
                    torch.where(resets_flags, ret_sets_lt, lt_f)),
        torch.where(writes_flags, new_eq, ~resets_flags & eq_f),
        torch.where(writes_flags, new_gt, ~resets_flags & gt_f)], dim=1)

    # ============================================= dst0 / dst1 selection
    dst0_val = _sel(is_add, sum_val, z8)
    dst0_val = _sel(is_sub, diff_val, dst0_val)
    dst0_val = _sel(is_mul, mul_lo, dst0_val)
    dst0_val = _sel(is_div & ~div_by_zero, div_q,
                    _sel(is_div, z8, dst0_val))
    dst0_val = _sel(is_shift, shift_val, dst0_val)
    dst0_val = _sel(is_binop, binop_val, dst0_val)
    dst0_val = _sel(is_ctx, ctx_val, dst0_val)
    dst0_val = _sel(ptr_writes, ptr_result, dst0_val)
    dst0_val = _sel(uma_is_read, read_val, dst0_val)
    dst0_val = _sel(uma_is_write & uma_increment, incremented_src0, dst0_val)
    if log_enabled:
        dst0_val = _sel(do_sread, current_val, dst0_val)
        dst0_val = _sel(l_precomp & active, u256.from_u32_scalar(
            do_precomp.to(I64)), dst0_val)
    dst0_is_ptr = ptr_writes

    dst0_write = is_add | is_sub | is_mul | is_div | is_shift | is_binop \
        | ctx_writes_dst | ptr_writes | do_sread | (l_precomp & active) \
        | (uma_is_read & ~uma_set_panic) \
        | (uma_is_write & uma_increment & ~uma_set_panic)

    dst1_val = _sel(is_mul, mul_hi, z8)
    dst1_val = _sel(is_div & ~div_by_zero, div_r, _sel(is_div, z8, dst1_val))
    dst1_val = _sel(uma_is_read & uma_increment, incremented_src0, dst1_val)
    dst1_is_ptr = uma_is_read & uma_increment & src0_tag
    dst1_write = is_mul | is_div \
        | (uma_is_read & uma_increment & ~uma_set_panic)

    new_pending = new_pending | (is_ptr & ptr_panic) | uma_set_panic
    if log_enabled:
        new_pending |= is_far_call & fc["exc"]

    # ============================================ pc + frame machinery
    cur_pc_new = torch.where(is_jump, src0[:, 0] & M16, new_pc_lin)
    cur_scal = scal.clone()
    cur_scal[:, CS["pc"]] = cur_pc_new
    cur_scal[:, CS["sp"]] = sp2
    cur_ergs = torch.where(is_near_call, nc_left, torch.where(is_ret, 0,
                                                              ergs3))
    cur_heap_bound = torch.where(is_uma, new_heap_bound_u, heap_bound0)
    cur_aux_bound = torch.where(is_uma, new_aux_bound_u, aux_bound0)
    if log_enabled:
        cur_ergs = torch.where(is_far_call, fc["left"], cur_ergs)
        cur_heap_bound = torch.where(is_far_call, fc["new_heap_bound"],
                                     cur_heap_bound)
        cur_aux_bound = torch.where(is_far_call, fc["new_aux_bound"],
                                    cur_aux_bound)
    cur_scal[:, CS["ergs_remaining"]] = cur_ergs
    cur_scal[:, CS["heap_bound"]] = cur_heap_bound
    cur_scal[:, CS["aux_heap_bound"]] = cur_aux_bound
    _put_rows(state.cs_scalars, depth, cur_scal, active)

    # push (near call, far call)
    push_mask = (is_near_call | is_far_call) & active
    pushed = cur_scal.clone()
    pushed[:, CS["pc"]] = imm0
    pushed[:, CS["exception_handler"]] = imm1
    pushed[:, CS["ergs_remaining"]] = nc_passed
    pushed[:, CS["flags_word"]] = flags_word | 2
    pushed[:, CS["journal_snapshot"]] = \
        new_j_count if log_enabled else wide(state.j_count)
    pushed[:, CS["event_snapshot"]] = \
        new_ev_count if log_enabled else wide(state.ev_count)
    push_this, push_sender = this_addr, msg_sender
    push_code_addr, push_u128 = code_addr, frame_u128
    if log_enabled:
        far = {
            "pc": 0, "exception_handler": imm0,
            "ergs_remaining": fc["passed"],
            # far frames keep only the static bit
            "flags_word": (flags_word & 1) | vflag0.to(I64),
            "base_memory_page": fc["new_base"],
            "code_page": fc["code_page"],
            "sp": params.INITIAL_SP_ON_FAR_CALL,
            "shard_ids": fc["this_shard"] | (shard_this << 8)
            | (fc["code_shard"] << 16),
            "heap_bound": params.NEW_FRAME_MEMORY_STIPEND,
            "aux_heap_bound": params.NEW_FRAME_MEMORY_STIPEND,
            "heap_slot": fc["heap_slot"],
        }
        for name, value in far.items():
            pushed[:, CS[name]] = torch.where(is_far_call, value,
                                              pushed[:, CS[name]])
        push_this = _sel(is_far_call, fc["next_this"], this_addr)
        push_sender = _sel(is_far_call, fc["next_sender"], msg_sender)
        push_code_addr = _sel(is_far_call, fc["addr5"], code_addr)
        push_u128 = _sel(is_far_call, fc["next_u128"], frame_u128)
    push_idx = torch.clamp(depth + 1, max=D - 1)
    lane_error |= active & push_mask & (depth + 1 >= D)
    _put_rows(state.cs_scalars, push_idx, pushed, push_mask)
    _put_rows(state.cs_this_address, push_idx, push_this, push_mask)
    _put_rows(state.cs_msg_sender, push_idx, push_sender, push_mask)
    _put_rows(state.cs_code_address, push_idx, push_code_addr, push_mask)
    _put_rows(state.cs_context_u128, push_idx, push_u128, push_mask)
    far_on = is_far_call & active
    if log_enabled:
        # the context register is consumed by the call (far_call.rs:558);
        # a fresh heap / aux-heap frame slot and page range for the callee
        new_context_u128 = _sel(far_on, torch.zeros_like(new_context_u128),
                                new_context_u128)
        _put_rows(state.hp_page, fc["heap_slot"], fc["new_base"] + 2, far_on)
        _put_rows(state.ap_page, fc["heap_slot"], fc["new_base"] + 3, far_on)

    # pop (ret): update the parent frame
    pop_mask = is_ret & active
    parent_idx = torch.clamp(depth - 1, min=0)
    parent = wide(_rows(state.cs_scalars, parent_idx))
    parent[:, CS["ergs_remaining"]] = \
        (parent[:, CS["ergs_remaining"]] + ergs3) & M32
    parent[:, CS["pc"]] = torch.where(
        is_to_label & is_local_frame, imm0,
        torch.where(ret_panicked, scal[:, CS["exception_handler"]],
                    parent[:, CS["pc"]]))
    # local frames propagate heap bounds up
    parent[:, CS["heap_bound"]] = torch.where(
        is_local_frame, torch.where(is_uma, new_heap_bound_u, heap_bound0),
        parent[:, CS["heap_bound"]])
    parent[:, CS["aux_heap_bound"]] = torch.where(
        is_local_frame, torch.where(is_uma, new_aux_bound_u, aux_bound0),
        parent[:, CS["aux_heap_bound"]])
    _put_rows(state.cs_scalars, parent_idx, parent, pop_mask)

    if log_enabled:
        # storage rollback and event cancel on a panicked pop: replay the
        # journal newest-first down to the frame's snapshot
        j_snap = _as_i32(scal[:, CS["journal_snapshot"]])
        ev_snap = _as_i32(scal[:, CS["event_snapshot"]])
        panic_pop = pop_mask & ret_panicked
        idx = new_j_count
        while True:
            lane_on = panic_pop & (idx > j_snap)
            if not bool(lane_on.any()):
                break
            e = torch.clamp(idx - 1, min=0)
            slot = wide(_rows(state.j_slot, e))
            prev = wide(_rows(state.j_prev, e))
            _put_rows(state.st_val, slot, prev, lane_on)
            idx = idx - lane_on.to(I64)
        new_j_count = torch.where(panic_pop, j_snap, new_j_count)
        ev_pos = torch.arange(config.event_slots, device=dev)[None, :]
        state.ev_cancelled |= panic_pop[:, None] \
            & (ev_pos >= ev_snap[:, None]) & (ev_pos < new_ev_count[:, None])

    new_depth = torch.clamp(depth + push_mask.to(I64) - pop_mask.to(I64),
                            min=0)
    new_done = new_depth == 0

    # =============================================== register writebacks
    dst0_to_reg = dst0_write & ~dst0_is_stack_mem & (dst0_reg > 0) & active
    r0i = torch.clamp(dst0_reg - 1, min=0)
    _put_rows(state.regs, r0i, dst0_val, dst0_to_reg)
    _put_rows(state.reg_ptr, r0i, dst0_is_ptr, dst0_to_reg)
    dst1_to_reg = dst1_write & (dst1_reg > 0) & active
    r1i = torch.clamp(dst1_reg - 1, min=0)
    _put_rows(state.regs, r1i, dst1_val, dst1_to_reg)
    _put_rows(state.reg_ptr, r1i, dst1_is_ptr, dst1_to_reg)

    # non-local ret register-file protocol: r1 = returndata ptr, rest wiped
    wipe = nonlocal_ret & active
    wiped = torch.zeros_like(state.regs)
    wiped[:, 0] = narrow(returndata_u256, torch.int32)
    state.regs.copy_(_sel(wipe, wiped, state.regs))
    wiped_ptr = torch.zeros_like(state.reg_ptr)
    wiped_ptr[:, 0] = True
    state.reg_ptr.copy_(_sel(wipe, wiped_ptr, state.reg_ptr))
    new_context_u128 = _sel(wipe, torch.zeros_like(new_context_u128),
                            new_context_u128)
    if log_enabled:
        # far-call register protocol (far_call.rs:571-610): r1 = calldata
        # pointer, r2 = ctor | system markers, r3..r12 kept (tags cleared)
        # only for system calls, r13..r15 zeroed
        regs_pos = torch.arange(params.REGISTERS_COUNT, device=dev)[None, :]
        keep_sys = (regs_pos >= 2) & (regs_pos <= 11) \
            & fc["to_system"][:, None]
        far_file = torch.where(keep_sys[:, :, None], state.regs, 0)
        far_file[:, 0] = narrow(fc["calldata"], torch.int32)
        far_file[:, 1] = narrow(u256.from_u32_scalar(
            fc["ctor"].to(I64) | (fc["to_system"].to(I64) << 1)), torch.int32)
        state.regs.copy_(_sel(far_on, far_file, state.regs))
        state.reg_ptr.copy_(_sel(far_on, wiped_ptr, state.reg_ptr))

    # ================================================= memory writebacks
    dst0_to_stack = dst0_write & dst0_is_stack_mem & active
    dst0_phys, dst0_in_window = _map_stack_index(config, dst0_loc)
    lane_error |= dst0_to_stack & ~dst0_in_window
    _put_word(state.stack, dst0_phys, dst0_val, dst0_to_stack)
    _put_rows(state.stack_ptr_tag, dst0_phys, dst0_is_ptr, dst0_to_stack)

    w_heap0 = uma_do_write & use_heap_arena & active
    w_aux0 = uma_do_write & use_aux_arena & active
    _put_word(state.heap, (h_base + word0) & M32, new_w0, w_heap0)
    _put_word(state.heap, (h_base + word1) & M32, new_w1,
              w_heap0 & is_unaligned)
    _put_word(state.aux_heap, (a_base + word0) & M32, new_w0, w_aux0)
    _put_word(state.aux_heap, (a_base + word1) & M32, new_w1,
              w_aux0 & is_unaligned)
    if pp is not None and pp["any"]:
        # the precompile's output word, and an ecrecover call's second
        for j, val in enumerate((pp["out_val"], pp["out_val2"])):
            on = pp["is_ec"] if j else torch.ones_like(pp["is_ec"])
            _put_word(state.heap, (pp["w_slot"] * config.heap_words
                                   + pp["out_off"] + j) & M32, val,
                      pp["write_h"] & on)
            _put_word(state.aux_heap, (pp["w_slot"] * config.aux_heap_words
                                       + pp["out_off"] + j) & M32, val,
                      pp["write_a"] & on)
    if pp is not None and pp["pq_rows"] is not None:
        base, ps = pp["pq_base"], pp["pq_rows"][2].shape[1]
        for arr, rows in zip((state.pq_meta, state.pq_value, state.pq_flags),
                             pp["pq_rows"]):
            arr[:, base:base + ps] = narrow(rows, torch.int32)
        state.pq_count.copy_(narrow((wide(state.pq_count) + pp["pq_count"])
                                    & M32, torch.int32))
        state.pq_blocks += pp["pq_blocks"]

    # ============================================= memory witness slots
    if config.queue_capacity > 0 or config.rolling_commitment:
        ts0 = wide(state.timestamp)
        ts3 = (ts0 + 3) & M32
        stack_page = (base_page + 1) & M32
        uma_page = torch.where(uma_is_ptr_read, u_page_field,
                               torch.where(uma_is_heap, heap_page, aux_page))
        uma_type = torch.where(uma_is_ptr_read, 3,
                               torch.where(uma_is_aux, 2, 1))
        four = torch.full_like(ts0, 4)
        nul = torch.zeros_like(ts0)
        no = torch.zeros_like(active)
        # (valid, type, page, index, value, is_ptr, rw, timestamp), in the
        # golden emission order
        slots = [
            (code_read_needed & ~frozen, four, code_page, super_pc,
             code_word, no, 0, ts0),
            (do_src0_mem_read & src0_is_stack_mem, nul, stack_page,
             src0_loc, stack_val, stack_tag, 0, ts0),
            (do_src0_mem_read & src0_code, four, code_page, src0_loc,
             code_val, no, 0, ts0),
            (uma_do_read_mem, uma_type, uma_page, word0, w0, no, 0, ts0),
            (uma_do_read_mem & is_unaligned, uma_type, uma_page, word1, w1,
             no, 0, ts0),
            (dst0_to_stack, nul, stack_page, dst0_loc, dst0_val,
             dst0_is_ptr, 1, ts3),
            (uma_do_write, uma_type, uma_page, word0, new_w0, no, 1, ts3),
            (uma_do_write & is_unaligned, uma_type, uma_page, word1, new_w1,
             no, 1, ts3),
        ]
        overflow = config.queue_capacity > 0 and \
            step * SLOTS_PER_CYCLE > config.queue_capacity - SLOTS_PER_CYCLE
        live = [valid & active for valid, *_ in slots]

        def slot_rows(masks):
            """The cycle's 8 rows ([8, 4, B], [8, 8, B], [8, B]) with the
            slots `masks` keeps; the others all-zero rows, rw bit
            included."""
            meta_rows, value_rows, flag_rows = [], [], []
            for m, (_, mtype, mpage, midx, mval, mptr, rw, ts) in zip(
                    masks, slots):
                vm = m.to(I64)
                meta_rows.append(torch.stack([ts, mtype, mpage, midx]) * vm)
                value_rows.append(mval.T * vm)
                flag_rows.append((rw | (mptr.to(I64) << 1) | 4) * vm)
            return tuple(narrow(torch.stack(r), torch.int32)
                         for r in (meta_rows, value_rows, flag_rows))

        if config.queue_capacity > 0:
            # an overflowing cycle keeps none of its slots in the queue
            if overflow:
                for m in live:
                    lane_error |= m
            kept = [no] * SLOTS_PER_CYCLE if overflow else live
            meta_b, value_b, flag_b = slot_rows(kept)
            base = min(step * SLOTS_PER_CYCLE,
                       config.queue_capacity - SLOTS_PER_CYCLE)
            state.wq_meta[base:base + SLOTS_PER_CYCLE] = meta_b
            state.wq_value[base:base + SLOTS_PER_CYCLE] = value_b
            state.wq_flags[base:base + SLOTS_PER_CYCLE] = flag_b
            state.wq_count += sum(m.to(torch.int32) for m in kept)
        if config.rolling_commitment:
            # the sponge absorbs every live slot, past a queue overflow too
            # (the JAX engine's rolling block takes valid & active)
            rows = slot_rows(live)
            if block is not None:
                for dst, src in zip(block, rows):
                    dst.copy_(src)
            else:
                rolling_absorb(state.wc_state, state.wc_count, *rows)

    # ======================= log and decommit witness queues (1 row/cycle)
    # every lane writes its row at the cycle's position, done lanes too: a
    # lane that emitted nothing writes zeros
    if log_enabled and config.log_queue_capacity > 0:
        lpos = min(step, config.log_queue_capacity - 1)
        emits = do_sread | do_swrite | do_event | do_precomp | fc_do_sread
        lvalid = emits & (step < config.log_queue_capacity)
        lane_error |= emits & ~lvalid
        l_aux = torch.where(
            do_precomp, params.PRECOMPILE_AUX_BYTE,
            torch.where(do_sread | do_swrite | fc_do_sread,
                        params.STORAGE_AUX_BYTE, aux_byte))
        l_svc = vflag0 & ~fc_do_sread
        l_shard = torch.where(fc_do_sread, fc["code_shard"], shard_this)
        packed_meta = l_aux | ((do_swrite | do_event).to(I64) << 8) \
            | (l_svc.to(I64) << 9) | (l_shard << 16)
        meta_row = torch.stack([ts_log, packed_meta, wide(state.tx_number),
                                torch.ones_like(ts_log)], dim=1)
        # reads copy read_value into written_value (helpers.rs:145-148)
        read_row = _sel(do_sread | do_swrite, current_val, z8)
        read_row = _sel(do_precomp, z8, read_row)
        written_row = _sel(do_sread, current_val,
                           _sel(do_swrite | do_event, src1, z8))
        addr_row = _sel(fc_do_sread, _deployer5(src0), this_addr)
        key_row = _sel(fc_do_sread, _cat_zero(fc["addr5"]),
                       src0 if pp is None else _sel(do_precomp, pp["key"],
                                                    src0))
        read_row = _sel(fc_do_sread, fc["hash_storage"], read_row)
        written_row = _sel(fc_do_sread, fc["hash_storage"], written_row)
        for arr, row in ((state.lq_meta, meta_row), (state.lq_addr, addr_row),
                         (state.lq_key, key_row), (state.lq_read, read_row),
                         (state.lq_written, written_row)):
            arr[:, lpos] = narrow(_sel(lvalid, row, torch.zeros_like(row)),
                                  torch.int32)
        state.lq_count += lvalid.to(torch.int32)
    if log_enabled and config.decommit_queue_capacity > 0:
        dpos = min(step, config.decommit_queue_capacity - 1)
        dvalid = fc_do_decommit & (step < config.decommit_queue_capacity)
        lane_error |= fc_do_decommit & ~dvalid
        drow = torch.stack(
            [(wide(state.timestamp) + 1) & M32, fc["code_page"],
             fc["code_len"], 1 | (fc["fresh"].to(I64) << 1)], dim=1)
        state.dq_hash[:, dpos] = narrow(_sel(dvalid, fc["code_hash"], z8),
                                        torch.int32)
        state.dq_meta[:, dpos] = narrow(
            _sel(dvalid, drow, torch.zeros_like(drow)), torch.int32)
        state.dq_count += dvalid.to(torch.int32)

    # ============================ lane scalars; lanes already done freeze
    def put(name, new):
        old = getattr(state, name)
        if old.dtype != torch.bool:
            new = narrow(new, old.dtype)
        old.copy_(_sel(frozen, old, new))

    put("flags", new_flags)
    put("timestamp", (wide(state.timestamp) + params.TIME_DELTA_PER_CYCLE)
        & M32)
    put("monotonic_cycle_counter",
        (wide(state.monotonic_cycle_counter) + 1) & M32)
    put("ergs_per_pubdata", new_ergs_per_pubdata)
    put("tx_number", new_tx_number)
    put("pending_exception", new_pending)
    put("previous_code_word", code_word)
    put("previous_super_pc", new_prev_super_pc)
    put("previous_code_page", new_prev_code_page)
    put("context_u128", new_context_u128)
    put("depth", new_depth)
    if log_enabled:
        put("spent_pubdata", new_spent_pubdata)
        put("st_count", new_st_count)
        put("j_count", new_j_count)
        put("ev_count", new_ev_count)
        put("frame_count", wide(state.frame_count) + far_on.to(I64))
        put("page_counter", (wide(state.page_counter) + far_on.to(I64)
                             * params.NEW_MEMORY_PAGES_PER_FAR_CALL) & M32)
    put("done", new_done)
    state.lane_error.copy_(lane_error)
    state.global_step += 1
    return stored


def run_cycles(state: BatchedVmState, config: VmConfig,
               n_cycles: int) -> BatchedVmState:
    """Advance all lanes by n_cycles with the plain cycle step, in place."""
    for _ in range(n_cycles):
        cycle_step(state, config)
    return state
