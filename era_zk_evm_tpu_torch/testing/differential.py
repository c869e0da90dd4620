"""Differential testing: the port's batched engine vs the golden oracle.

The port of `era_zk_evm_tpu/testing/differential.py`.  Runs the same
programs through the port's engine (`fused_cycle.run_cycles`: K1 on a
card, its plain torch version on the CPU) and the port's copy of the
golden sequential VM (`golden/`), and compares every observable: final
register file (incl. pointer tags), flags, root-frame ergs, timestamps,
heap/stack arenas, storage, net events, the ordered log, decommit,
precompile and memory-witness query streams.  No JAX is needed.  The
device state is read in the reference layout (`state.state_to_numpy`).
"""

from __future__ import annotations


import torch

from ..config import VmConfig, check_slice
from ..isa import params
from ..isa.assembler import assemble_to_code_words
from ..models import fused_cycle
from ..models.state import (
    DEFAULT_DEVICE, arena_word_major, make_entry_state, populate_code_bank,
    populate_storage, state_to_numpy,
)
from ..utils import from_limbs
from . import harness


class DifferentialMismatch(AssertionError):
    pass


def _flatten_copy(tools):
    """Flatten the event sink non-destructively (flatten() is consuming)."""
    import copy

    return copy.deepcopy(tools.event_sink).flatten()


def _check(cond, lane, what, got, want):
    if not cond:
        raise DifferentialMismatch(
            f"lane {lane}: {what}: device={got!r} golden={want!r}")


def run_golden(source: str, max_cycles: int, **kwargs):
    tools = harness.create_default_tools()
    vm = harness.build_vm(assemble_to_code_words(source), tools=tools, **kwargs)
    cycles = harness.run(vm, max_cycles)
    return vm, tools, cycles


def diff_run(sources: list[str], config: VmConfig | None = None,
             max_cycles: int = 256, ergs: int = 1 << 20,
             compare_witness: bool = True,
             contracts: list[tuple[int, str]] | None = None,
             default_aa_source: str | None = None,
             entry_address: int = harness.ENTRY_ADDRESS,
             config_overrides: dict | None = None,
             calldata: list[int] | None = None,
             device: torch.device | str = DEFAULT_DEVICE) -> None:
    """Run each program on both engines and compare exhaustively; raise
    `DifferentialMismatch` at the first difference.

    `contracts` registers callable contracts (address, asm source) on both
    engines — the deployer-space code-hash slot, the decommitter/code bank,
    and (if given) the default-AA bytecode.  `config_overrides` replaces
    fields of the default VmConfig (layout/gating variants;
    `limb_major_arenas`, a TPU-only layout, raises NotImplementedError).
    The device engine runs on `device`, the card unless the caller asks
    for another.
    """
    import dataclasses

    from ..golden import BlockProperties
    from ..isa.abi import code_hash_for_bytecode

    B = len(sources)
    config = config or VmConfig(
        batch=B, queue_capacity=max_cycles * 8, heap_words=64,
        stack_words=2048, code_words=64, max_depth=8,
        storage_slots=16, journal_slots=32, event_slots=32,
        log_queue_capacity=max_cycles,
        heap_frames=4, code_pages=4,
        decommit_queue_capacity=max_cycles)
    if config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    check_slice(config)

    contract_entries: list[tuple[int, int, int, int]] = []
    bank: list[tuple[int, list[int]]] = []
    for address, c_src in contracts or []:
        words = assemble_to_code_words(c_src)
        h = code_hash_for_bytecode(words)
        contract_entries.append(
            (0, params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, address, h))
        bank.append((h, words))
    aa_hash = 0
    if default_aa_source is not None:
        aa_words = assemble_to_code_words(default_aa_source)
        aa_hash = code_hash_for_bytecode(aa_words)
        bank.append((aa_hash, aa_words))
    block_properties = BlockProperties(default_aa_code_hash=aa_hash)

    def golden_with_setup(src):
        tools = harness.create_default_tools()
        if contract_entries:
            tools.storage.populate(list(contract_entries))
        if bank:
            tools.decommitter.populate(
                [(h, list(w)) for h, w in bank])
        vm = harness.build_vm(assemble_to_code_words(src), tools=tools,
                              ergs=ergs, block_properties=block_properties,
                              entry_address=entry_address)
        if calldata is not None:
            # bootloader calldata page + tagged r1 fat pointer (the entry
            # counterpart of memory.rs:293-298 + far_call.rs:571-577)
            from ..golden.state import PrimitiveValue
            from ..isa.abi import FatPointer

            tools.memory.populate_bootloader_calldata(list(calldata))
            fp = FatPointer(offset=0,
                            memory_page=params.BOOTLOADER_CALLDATA_PAGE,
                            start=0, length=32 * len(calldata))
            vm.local_state.registers[0] = PrimitiveValue(
                value=fp.to_u256(), is_pointer=True)
        cycles = harness.run(vm, max_cycles)
        return vm, tools, cycles

    goldens = [golden_with_setup(src) for src in sources]

    programs = [assemble_to_code_words(src) for src in sources]
    state = make_entry_state(config, programs, ergs=ergs,
                             entry_address=entry_address,
                             calldata=[list(calldata)] * B
                             if calldata is not None else None,
                             device=device)
    if contract_entries:
        populate_storage(state, config, [contract_entries] * B)
    if bank:
        populate_code_bank(state, config, [list(bank)] * B,
                           default_aa_hash=aa_hash)
    fused_cycle.run_cycles(state, config, max_cycles)
    arrays = state_to_numpy(state)

    done = arrays["done"]
    err = arrays["lane_error"]
    regs = arrays["regs"]
    reg_ptr = arrays["reg_ptr"]
    flags = arrays["flags"]
    ts = arrays["timestamp"]
    mcc = arrays["monotonic_cycle_counter"]
    cs = arrays["cs_scalars"]
    heap = arena_word_major(arrays["heap"], config)
    stack = arena_word_major(arrays["stack"], config)
    wq_count = arrays["wq_count"]
    # the memory queue is batch-last ([Q, ..., B]); view as [B, Q, ...]
    wq_meta = arrays["wq_meta"].transpose(2, 0, 1)
    wq_value = arrays["wq_value"].transpose(2, 0, 1)
    wq_flags = arrays["wq_flags"].T

    from .harness import ENTRY_BASE_PAGE
    heap_page = ENTRY_BASE_PAGE + 2
    stack_page = ENTRY_BASE_PAGE + 1

    for b, (vm, tools, cycles) in enumerate(goldens):
        _check(bool(done[b]), b, "done", bool(done[b]), True)
        _check(not bool(err[b]), b, "lane_error", bool(err[b]), False)
        _check(int(mcc[b]) == cycles, b, "cycle count", int(mcc[b]), cycles)
        _check(int(ts[b]) == vm.local_state.timestamp, b, "timestamp",
               int(ts[b]), vm.local_state.timestamp)

        for r in range(params.REGISTERS_COUNT):
            want = vm.local_state.registers[r]
            got = from_limbs(regs[b, r])
            _check(got == want.value, b, f"r{r+1}", hex(got), hex(want.value))
            _check(bool(reg_ptr[b, r]) == want.is_pointer, b, f"r{r+1}.ptr",
                   bool(reg_ptr[b, r]), want.is_pointer)

        f = vm.local_state.flags
        _check(bool(flags[b, 0]) == f.overflow_or_less_than, b, "flag.lt",
               bool(flags[b, 0]), f.overflow_or_less_than)
        _check(bool(flags[b, 1]) == f.equality, b, "flag.eq",
               bool(flags[b, 1]), f.equality)
        _check(bool(flags[b, 2]) == f.greater_than, b, "flag.gt",
               bool(flags[b, 2]), f.greater_than)

        root_ergs = int(cs[b, 0, 5])  # CS["ergs_remaining"] == 5
        want_root = vm.local_state.callstack.current.ergs_remaining
        _check(root_ergs == want_root, b, "root ergs", root_ergs, want_root)

        heap_words = vm.memory.dump_page(heap_page, 0, config.heap_words)
        got_heap = [from_limbs(heap[b, i]) for i in range(config.heap_words)]
        _check(got_heap == heap_words, b, "heap contents",
               got_heap[:8], heap_words[:8])

        # compare a slice of the stack around the SP region + low absolutes
        lo = vm.memory.dump_page(stack_page, 0, 256)
        got_lo = [from_limbs(stack[b, i]) for i in range(256)]
        _check(got_lo == lo, b, "stack[0:256]", None, None)
        sp0 = params.INITIAL_SP_ON_FAR_CALL
        hi = vm.memory.dump_page(stack_page, sp0 - 64, sp0 + 256)
        got_hi = [from_limbs(stack[b, i]) for i in range(sp0 - 64, sp0 + 256)]
        _check(got_hi == hi, b, "stack around sp", None, None)

        # -- LOG-family observables --
        if config.storage_slots > 0:
            st_key = arrays["st_key"]
            st_val = arrays["st_val"]
            st_used = arrays["st_used"]
            # every device slot must match golden storage (missing == 0)
            for s in range(config.storage_slots):
                if not st_used[b, s]:
                    continue
                key = from_limbs(st_key[b, s, :8])
                address = sum(int(st_key[b, s, 8 + i]) << (32 * i)
                              for i in range(5))
                shard = int(st_key[b, s, 13])
                got_v = from_limbs(st_val[b, s])
                want_v = vm.storage.inner[shard].get(address, {}).get(key, 0)
                _check(got_v == want_v, b, f"storage[{shard},{address:#x},{key}]",
                       got_v, want_v)
            # and every golden entry must be present on device
            for shard in range(len(vm.storage.inner)):
                for address, slots in vm.storage.inner[shard].items():
                    for key, want_v in slots.items():
                        found = 0
                        for s in range(config.storage_slots):
                            if st_used[b, s] and \
                                    from_limbs(st_key[b, s, :8]) == key and \
                                    int(st_key[b, s, 13]) == shard:
                                found = from_limbs(st_val[b, s])
                                break
                        _check(found == want_v, b,
                               f"golden storage[{shard},{address:#x},{key}]",
                               found, want_v)
            # net events: uncancelled journal entries in order
            _, want_events, want_l1 = _flatten_copy(tools)
            ev_meta = arrays["ev_meta"]
            ev_key = arrays["ev_key"]
            ev_val = arrays["ev_val"]
            ev_cancelled = arrays["ev_cancelled"]
            ev_count = int(arrays["ev_count"][b])
            got_events, got_l1 = [], []
            for i in range(ev_count):
                if ev_cancelled[b, i]:
                    continue
                aux = int(ev_meta[b, i, 1]) & 0xFF
                entry = (from_limbs(ev_key[b, i]), from_limbs(ev_val[b, i]),
                         bool((int(ev_meta[b, i, 1]) >> 8) & 1),
                         (int(ev_meta[b, i, 1]) >> 16) & 0xFFFF)
                (got_events if aux == params.EVENT_AUX_BYTE else got_l1).append(entry)
            want_ev_tuples = [(e.key, e.value, e.is_first, e.tx_number_in_block)
                              for e in want_events]
            want_l1_tuples = [(e.key, e.value, e.is_first, e.tx_number_in_block)
                              for e in want_l1]
            _check(got_events == want_ev_tuples, b, "net events",
                   got_events, want_ev_tuples)
            _check(got_l1 == want_l1_tuples, b, "net l1 messages",
                   got_l1, want_l1_tuples)
            # spent pubdata counter
            got_spent = int(arrays["spent_pubdata"][b])
            _check(got_spent == vm.local_state.spent_pubdata_counter, b,
                   "spent_pubdata", got_spent,
                   vm.local_state.spent_pubdata_counter)
            # log query stream
            if config.log_queue_capacity > 0:
                lq_meta = arrays["lq_meta"]
                lq_addr = arrays["lq_addr"]
                lq_key = arrays["lq_key"]
                lq_read = arrays["lq_read"]
                lq_written = arrays["lq_written"]
                want_logs = [q for _, q in tools.witness.log_queries]
                got_slots = [s for s in range(config.log_queue_capacity)
                             if lq_meta[b, s, 3]]
                _check(len(got_slots) == len(want_logs), b, "log query count",
                       len(got_slots), len(want_logs))
                for i, q in enumerate(want_logs):
                    s = got_slots[i]
                    packed = int(lq_meta[b, s, 1])
                    tag = f"log[{i}]"
                    _check(int(lq_meta[b, s, 0]) == q.timestamp, b, tag + ".ts",
                           int(lq_meta[b, s, 0]), q.timestamp)
                    _check(packed & 0xFF == q.aux_byte, b, tag + ".aux",
                           packed & 0xFF, q.aux_byte)
                    _check(bool((packed >> 8) & 1) == q.rw_flag, b, tag + ".rw",
                           bool((packed >> 8) & 1), q.rw_flag)
                    _check(bool((packed >> 9) & 1) == q.is_service, b,
                           tag + ".svc", bool((packed >> 9) & 1), q.is_service)
                    _check((packed >> 16) & 0xFF == q.shard_id, b, tag + ".shard",
                           (packed >> 16) & 0xFF, q.shard_id)
                    _check(int(lq_meta[b, s, 2]) == q.tx_number_in_block, b,
                           tag + ".tx", int(lq_meta[b, s, 2]),
                           q.tx_number_in_block)
                    got_address = sum(int(lq_addr[b, s, i]) << (32 * i)
                                      for i in range(5))
                    _check(got_address == q.address, b, tag + ".addr",
                           hex(got_address), hex(q.address))
                    _check(from_limbs(lq_key[b, s]) == q.key, b, tag + ".key",
                           from_limbs(lq_key[b, s]), q.key)
                    _check(from_limbs(lq_read[b, s]) == q.read_value, b,
                           tag + ".read", from_limbs(lq_read[b, s]),
                           q.read_value)
                    _check(from_limbs(lq_written[b, s]) == q.written_value, b,
                           tag + ".written", from_limbs(lq_written[b, s]),
                           q.written_value)

        if config.decommit_queue_capacity > 0:
            dq_meta = arrays["dq_meta"]
            dq_hash = arrays["dq_hash"]
            want_dec = tools.witness.decommittments
            got_slots = [s for s in range(config.decommit_queue_capacity)
                         if dq_meta[b, s, 3] & 1]
            _check(len(got_slots) == len(want_dec), b, "decommit count",
                   len(got_slots), len(want_dec))
            for i, (mcc_w, q, words) in enumerate(want_dec):
                s = got_slots[i]
                tag = f"decommit[{i}]"
                _check(int(dq_meta[b, s, 0]) == q.timestamp, b, tag + ".ts",
                       int(dq_meta[b, s, 0]), q.timestamp)
                _check(int(dq_meta[b, s, 1]) == q.memory_page, b, tag + ".page",
                       int(dq_meta[b, s, 1]), q.memory_page)
                _check(int(dq_meta[b, s, 2]) == q.decommitted_length, b,
                       tag + ".len", int(dq_meta[b, s, 2]),
                       q.decommitted_length)
                _check(bool(dq_meta[b, s, 3] & 2) == q.is_fresh, b,
                       tag + ".fresh", bool(dq_meta[b, s, 3] & 2), q.is_fresh)
                _check(from_limbs(dq_hash[b, s]) == q.hash, b, tag + ".hash",
                       hex(from_limbs(dq_hash[b, s])), hex(q.hash))

        if config.precompile_queue_capacity > 0:
            from ..witness.commitment import (
                device_precompile_rounds, device_precompile_streams,
                flatten_precompile_calls,
            )

            want_pre = flatten_precompile_calls(tools.witness.precompile_calls)
            got_pre = device_precompile_streams(state)[b]
            _check(len(got_pre) == len(want_pre), b, "precompile query count",
                   len(got_pre), len(want_pre))
            for i, (g, q) in enumerate(zip(got_pre, want_pre)):
                tag = f"precompile[{i}]"
                _check(g.timestamp == q.timestamp, b, tag + ".ts",
                       g.timestamp, q.timestamp)
                _check(int(g.memory_type) == int(q.memory_type), b,
                       tag + ".type", int(g.memory_type), int(q.memory_type))
                _check(g.page == q.page, b, tag + ".page", g.page, q.page)
                _check(g.index == q.index, b, tag + ".index", g.index, q.index)
                _check(g.value == q.value, b, tag + ".value",
                       hex(g.value), hex(q.value))
                _check(g.rw_flag == q.rw_flag, b, tag + ".rw",
                       g.rw_flag, q.rw_flag)
            want_rounds = [c.round_witness.rounds
                           for c in tools.witness.precompile_calls]
            got_rounds = device_precompile_rounds(state, config)[b]
            _check(got_rounds == want_rounds, b, "precompile rounds",
                   got_rounds, want_rounds)

        if compare_witness:
            want_stream = [q for _, q in tools.witness.memory_queries]
            n = int(wq_count[b])
            # reconstruct the dense stream: valid slots (flag bit2) in order
            valid_slots = [s for s in range(wq_flags.shape[1])
                           if wq_flags[b, s] & 4]
            _check(n == len(want_stream), b, "witness query count",
                   n, len(want_stream))
            _check(len(valid_slots) == n, b, "valid slot count",
                   len(valid_slots), n)
            for i, q in enumerate(want_stream):
                s = valid_slots[i]
                got_ts, got_type, got_page, got_idx = (int(x) for x in wq_meta[b, s])
                got_val = from_limbs(wq_value[b, s])
                got_rw = bool(wq_flags[b, s] & 1)
                got_ptr = bool(wq_flags[b, s] & 2)
                tag = f"witness[{i}]"
                _check(got_ts == q.timestamp, b, tag + ".ts", got_ts, q.timestamp)
                _check(got_type == int(q.memory_type), b, tag + ".type",
                       got_type, int(q.memory_type))
                _check(got_page == q.page, b, tag + ".page", got_page, q.page)
                _check(got_idx == q.index, b, tag + ".index", got_idx, q.index)
                _check(got_val == q.value, b, tag + ".value",
                       hex(got_val), hex(q.value))
                _check(got_rw == q.rw_flag, b, tag + ".rw", got_rw, q.rw_flag)
                _check(got_ptr == q.value_is_pointer, b, tag + ".is_ptr",
                       got_ptr, q.value_is_pointer)
