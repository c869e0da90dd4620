"""The port's copy of the native C++ oracle (`era_zk_evm_tpu_torch.native`).

  * drift: the C++ source is byte-equal to the JAX package's, the decode
    tables generated from the port's `isa` equal the JAX generator's line
    for line after the header comment, and the status codes and
    `run_oracle`'s signature are the same; the library is the port's own,
    built under `_build/`, and builds racing each other leave one library;
  * the 27 cases of `tests/test_native_oracle.py`,
    `tests/test_native_far_call.py` and `tests/test_native_precompiles.py`
    replayed through the port's oracle against the port's golden model
    (`testing/harness.py`) on the same observables: status and cycles,
    registers and pointer tags, flags and heap, the memory, log and
    decommit records, storage, events and entry ergs, and the precompile
    digests against `hashlib` and golden.  The programs of
    `test_native_oracle.py` are imported as data; the cases written inline
    in the other two files are copied here with their ids;
  * the two oracles on the same inputs, in one process: the JAX package's
    `run_oracle` and the port's on the two fuzz campaigns of
    `testing/fuzz_programs.py`, their result dicts equal but for
    `run_seconds`.
  * the port's plain engine on `chip_smoke.py`'s K1-precompile-small
    lanes held to the oracle by `native.compare.compare_lanes`, as the
    card holds K1 there.

No XLA program is compiled.
"""

import dataclasses
import hashlib
import inspect
import random
import threading

import pytest

from era_zk_evm_tpu import native as jax_native
from era_zk_evm_tpu.native import gen_tables as jax_gen_tables
from era_zk_evm_tpu_torch import native
from era_zk_evm_tpu_torch.golden import BlockProperties
from era_zk_evm_tpu_torch.golden.precompiles import keccak256
from era_zk_evm_tpu_torch.isa import params
from era_zk_evm_tpu_torch.isa.abi import (
    FarCallABI, FatPointer, ForwardingMode, PrecompileCallABI, RetABI,
    code_hash_for_bytecode,
)
from era_zk_evm_tpu_torch.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu_torch.native import (
    ST_DONE, gen_tables, run_oracle,
)
from era_zk_evm_tpu_torch.testing import fuzz_programs as fz
from era_zk_evm_tpu_torch.testing import harness
from era_zk_evm_tpu_torch.testing.differential import _flatten_copy
from era_zk_evm_tpu_torch.witness.commitment import (
    serialize_log_query, serialize_memory_query,
)

from test_native_oracle import PROGRAMS
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

CALLEE_ADDR = 0x30055
ERGS = 1 << 20


# ---------------------------------------------------------------------------
# drift against the JAX package's oracle
# ---------------------------------------------------------------------------

def test_source_is_byte_equal():
    assert native.SOURCE.read_bytes() == (
        jax_native._DIR / "eravm_oracle.cpp").read_bytes()


def test_tables_equal_the_jax_generators(tmp_path):
    jax_gen_tables.generate(tmp_path / "tables.h")
    want = (tmp_path / "tables.h").read_text().splitlines()
    got = gen_tables.tables_text().splitlines()
    assert got[0] == ("// generated by era_zk_evm_tpu_torch.native.gen_tables"
                      " — do not edit")
    assert got[1:] == want[1:]


def test_status_codes_and_signature_equal():
    for name in ("ST_DONE", "ST_MAX_CYCLES", "ST_UNSUPPORTED", "ST_OOB"):
        assert getattr(native, name) == getattr(jax_native, name), name
    assert inspect.signature(native.run_oracle) \
        == inspect.signature(jax_native.run_oracle)


def test_builds_its_own_library_once_under_racing_builds(tmp_path,
                                                        monkeypatch):
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT
    assert lib.parent.name.startswith("oracle-")
    assert "era_zk_evm_tpu_torch" in lib.parts
    assert lib.resolve() != jax_native._LIB_PATH.resolve()
    # two builds into an empty root at once: one keyed directory, no
    # temporary left, every caller handed the same complete library
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    paths = [None] * 2

    def one(i):
        paths[i] = native.build()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert paths == [tmp_path / lib.parent.name / lib.name] * 2
    assert [p.name for p in tmp_path.iterdir()] == [lib.parent.name]
    assert paths[0].read_bytes()[:4] == b"\x7fELF"


# ---------------------------------------------------------------------------
# tests/test_native_oracle.py: the oracle against golden
# ---------------------------------------------------------------------------

def _compare(src: str, max_cycles: int = 256) -> None:
    vm, tools, cycles = harness.run_golden_like(src, max_cycles)
    out = run_oracle(assemble_to_code_words(src), max_cycles=max_cycles)
    assert out["status"] == ST_DONE, out["status"]
    assert out["cycles"] == cycles
    # final register file (post-exit wipe incl. the returndata pointer in r1)
    for i in range(15):
        want = vm.local_state.registers[i]
        assert out["registers"][i] == want.value, f"r{i+1}"
        assert out["reg_ptr"][i] == want.is_pointer, f"r{i+1}.ptr"
    lt, eq, gt = out["flags"]
    f = vm.local_state.flags
    assert (lt, eq, gt) == (f.overflow_or_less_than, f.equality,
                            f.greater_than)
    # heap contents
    heap_page = 10
    assert out["heap"] == vm.memory.dump_page(heap_page, 0, 64)
    # witness stream: byte-identical to the pinned record serialization
    want_records = [serialize_memory_query(q)
                    for _, q in tools.witness.memory_queries]
    assert out["witness_count"] == len(want_records)
    assert out["witness_records"] == want_records
    # LOG-family observables
    want_logs = [serialize_log_query(q) for _, q in tools.witness.log_queries]
    assert out["log_records"] == want_logs
    for shard in range(len(vm.storage.inner)):
        for address, slots in vm.storage.inner[shard].items():
            for key, val in slots.items():
                assert out["storage"].get((address, key), 0) == val
    _, want_events, want_l1 = _flatten_copy(tools)
    want_all = [(2, e.is_first, e.key, e.value) for e in want_events] \
        + [(3, e.is_first, e.key, e.value) for e in want_l1]
    got_all = [(e["aux"], e["is_first"], e["key"], e["value"])
               for e in out["events"]]
    assert sorted(got_all) == sorted(want_all)
    # entry-frame leftover ergs returned to the root (the golden root frame
    # started at VM_INITIAL_FRAME_ERGS - ergs; the native root starts at 0)
    root = vm.local_state.callstack.current
    leftover = root.ergs_remaining - (params.VM_INITIAL_FRAME_ERGS - (1 << 20))
    assert out["entry_ergs"] == leftover


class TestNativeOracle:
    @pytest.mark.parametrize("idx", range(len(PROGRAMS)))
    def test_programs(self, idx):
        _compare(PROGRAMS[idx])

    def test_random_fuzz(self):
        rng = random.Random(0xBEEF)
        for _ in range(20):
            _compare(fz.random_program(rng), max_cycles=192)


# ---------------------------------------------------------------------------
# tests/test_native_far_call.py: FAR_CALL, decommit, returndata, UMA
# ---------------------------------------------------------------------------

def _fc_abi(length=32, mode=ForwardingMode.USE_HEAP, ergs=(1 << 32) - 1,
            ctor=False, system=False, start=0):
    return FarCallABI(FatPointer(0, 0, start, length), ergs, 0, mode,
                      ctor, system).to_u256()


def _ret_abi(length=32, mode=ForwardingMode.USE_HEAP, start=0):
    return RetABI(FatPointer(0, 0, start, length), mode).to_u256()


def _compare_fc(src: str, contracts: list[tuple[int, str]],
                default_aa_source: str | None = None,
                max_cycles: int = 256,
                entry_address: int = harness.ENTRY_ADDRESS) -> None:
    bank = []
    storage_entries = []
    for address, c_src in contracts:
        words = assemble_to_code_words(c_src)
        h = code_hash_for_bytecode(words)
        bank.append((h, words))
        storage_entries.append(
            (params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, address, h))
    aa_hash = 0
    if default_aa_source is not None:
        aa_words = assemble_to_code_words(default_aa_source)
        aa_hash = code_hash_for_bytecode(aa_words)
        bank.append((aa_hash, aa_words))

    # golden run with the same staging
    tools = harness.create_default_tools()
    if storage_entries:
        tools.storage.populate([(0, a, k, v) for a, k, v in storage_entries])
    tools.decommitter.populate([(h, list(w)) for h, w in bank])
    vm = harness.build_vm(
        assemble_to_code_words(src), tools=tools, ergs=ERGS,
        block_properties=BlockProperties(default_aa_code_hash=aa_hash),
        entry_address=entry_address)
    cycles = harness.run(vm, max_cycles)

    out = run_oracle(
        assemble_to_code_words(src), entry_address=entry_address, ergs=ERGS,
        max_cycles=max_cycles, contracts=bank,
        storage_entries=[(a, k, v) for a, k, v in storage_entries],
        default_aa_hash=aa_hash)

    assert out["status"] == ST_DONE, out["status"]
    assert out["cycles"] == cycles
    for i in range(15):
        want = vm.local_state.registers[i]
        assert out["registers"][i] == want.value, f"r{i+1}"
        assert out["reg_ptr"][i] == want.is_pointer, f"r{i+1}.ptr"
    lt, eq, gt = out["flags"]
    f = vm.local_state.flags
    assert (lt, eq, gt) == (f.overflow_or_less_than, f.equality,
                            f.greater_than)
    want_heap = vm.memory.dump_page(harness.ENTRY_BASE_PAGE + 2, 0, 64)
    assert out["heap"] == want_heap
    want_records = [serialize_memory_query(q)
                    for _, q in tools.witness.memory_queries]
    assert out["witness_count"] == len(want_records)
    assert out["witness_records"] == want_records
    want_logs = [serialize_log_query(q) for _, q in tools.witness.log_queries]
    assert out["log_records"] == want_logs
    # decommit-witness stream
    want_dec = tools.witness.decommittments
    assert len(out["decommit_records"]) == len(want_dec)
    for got, (_, q, _words) in zip(out["decommit_records"], want_dec):
        assert got["hash"] == q.hash
        assert got["timestamp"] == q.timestamp
        assert got["page"] == q.memory_page
        assert got["length"] == q.decommitted_length
        assert got["is_fresh"] == q.is_fresh
    root = vm.local_state.callstack.current
    leftover = root.ergs_remaining - (params.VM_INITIAL_FRAME_ERGS - ERGS)
    assert out["entry_ergs"] == leftover


CALLEE_ECHO = f"""
    ld.ptr r1, r5
    add 1, r0, r6
    add r5, r6, r5
    st.h 0, r5
    add code[@rabi], r0, r7
    ret r7
    rabi: .word {_ret_abi(32)}
"""


class TestNativeFarCall:
    def test_basic_call_and_returndata(self):
        src = f"""
            add 41, r0, r3
            st.h 0, r3
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call r4, r2, @fail
            ld.ptr r1, r8
            ret r0
            fail:
            panic
            abi: .word {_fc_abi(32)}
            dest: .word {CALLEE_ADDR}
        """
        _compare_fc(src, [(CALLEE_ADDR, CALLEE_ECHO)])

    def test_repeat_decommit_refund(self):
        src = f"""
            add 10, r0, r3
            st.h 0, r3
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call r4, r2, @fail
            ld.ptr r1, r5
            far_call r4, r2, @fail
            ld.ptr r1, r6
            ret r0
            fail:
            panic
            abi: .word {_fc_abi(32)}
            dest: .word {CALLEE_ADDR}
        """
        _compare_fc(src, [(CALLEE_ADDR, CALLEE_ECHO)])

    def test_callee_revert_rolls_back_storage(self):
        callee = f"""
            add 5, r0, r1
            add 123, r0, r2
            log.swrite r1, r2
            log.event r1, r2
            add code[@rabi], r0, r7
            revert r7
            rabi: .word {_ret_abi(0)}
        """
        src = f"""
            add 5, r0, r1
            add 7, r0, r2
            log.swrite r1, r2
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call r4, r2, @handler
            add 1, r0, r9
            jump @out
            handler:
            log.sread r1, r10
            out:
            ret r0
            abi: .word {_fc_abi(0)}
            dest: .word {CALLEE_ADDR}
        """
        _compare_fc(src, [(CALLEE_ADDR, callee)])

    def test_delegate_preserves_sender_and_storage_context(self):
        callee = """
            ctx.this r5
            ctx.caller r6
            ctx.code_addr r7
            add 9, r0, r1
            add 55, r0, r2
            log.swrite r1, r2
            ret r0
        """
        src = f"""
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            delegate_call r4, r2, @fail
            add 9, r0, r1
            log.sread r1, r8
            ret r0
            fail:
            panic
            abi: .word {_fc_abi(0)}
            dest: .word {CALLEE_ADDR}
        """
        _compare_fc(src, [(CALLEE_ADDR, callee)])

    def test_mimic_call_sender_from_r15(self):
        callee = """
            ctx.caller r5
            st.h 0, r5
            ret r0
        """
        src = f"""
            add 0xDEAD, r0, r15
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            mimic_call r4, r2, @fail
            ret r0
            fail:
            panic
            abi: .word {_fc_abi(0)}
            dest: .word {CALLEE_ADDR}
        """
        # mimic requires kernel mode: run from a kernel entry address
        _compare_fc(src, [(CALLEE_ADDR, callee)], entry_address=0x8001)

    def test_default_aa_fallback(self):
        aa = """
            add 777, r0, r5
            st.h 0, r5
            ret r0
        """
        src = f"""
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call r4, r2, @fail
            add 3, r0, r9
            ret r0
            fail:
            panic
            abi: .word {_fc_abi(0)}
            dest: .word 0x99999
        """
        _compare_fc(src, [], default_aa_source=aa)

    def test_far_call_out_of_ergs_unwinds_to_handler(self):
        # unknown dest hash in kernel space: bad-hash exception -> pending
        # panic -> handler; no decommit
        src = f"""
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call r4, r2, @handler
            panic
            handler:
            add 11, r0, r9
            ret r0
            abi: .word {_fc_abi(0)}
            dest: .word 0x7777
        """
        _compare_fc(src, [(CALLEE_ADDR, CALLEE_ECHO)])

    def test_fat_pointer_arithmetic_on_calldata(self):
        callee = """
            add 4, r0, r6
            ptr.add r1, r6, r2
            ld.ptr r2, r5
            st.h 0, r5
            ptr.shrink r1, r6, r3
            ptr.pack r1, r0, r4
            ret r0
        """
        src = f"""
            add code[@w], r0, r3
            st.h 0, r3
            st.h 32, r3
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call r4, r2, @fail
            ret r0
            fail:
            panic
            abi: .word {_fc_abi(64)}
            dest: .word {CALLEE_ADDR}
            w: .word {int.from_bytes(bytes(range(32)), 'big')}
        """
        _compare_fc(src, [(CALLEE_ADDR, callee)])

    def test_static_far_call_write_panics(self):
        callee = """
            add 5, r0, r1
            log.swrite r1, r1
            ret r0
        """
        src = f"""
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call.static r4, r2, @handler
            panic
            handler:
            add 21, r0, r9
            ret r0
            abi: .word {_fc_abi(0)}
            dest: .word {CALLEE_ADDR}
        """
        _compare_fc(src, [(CALLEE_ADDR, callee)])

    def test_context_setters_and_pubdata(self):
        # kernel entry: set ergs_per_pubdata + tx number, then pay pubdata
        src = """
            add 3, r0, r7
            ctx.set_pubdata r7
            ctx.inc_tx
            ctx.meta r5
            add 5, r0, r1
            add 70, r0, r2
            log.swrite r1, r2
            log.to_l1 r1, r2
            ctx.get_u128 r6
            ret r0
        """
        _compare_fc(src, [], entry_address=0x8001)

    def test_context_u128_flows_into_callee(self):
        callee = """
            ctx.get_u128 r5
            st.h 0, r5
            ret r0
        """
        src = f"""
            add 77, r0, r7
            ctx.set_u128 r7
            add code[@abi], r0, r4
            add code[@dest], r0, r2
            far_call r4, r2, @fail
            ctx.get_u128 r9
            ret r0
            fail:
            panic
            abi: .word {_fc_abi(0)}
            dest: .word {CALLEE_ADDR}
        """
        _compare_fc(src, [(CALLEE_ADDR, callee)], entry_address=0x8001)


class TestNativeFarCallFuzz:
    def test_random_scenarios(self):
        """Random callees (ret/revert/plain-exit) x random callers
        (pass-all / zero / partial ergs), the port's copy of the device
        fuzz scenario generator, oracle against golden on every
        observable."""
        for seed in (0xC01, 0xC02, 0xC03, 0xC04):
            callers, contracts = fz.random_far_call_scenario(seed)
            for src in callers:
                _compare_fc(src, contracts, max_cycles=192)


# ---------------------------------------------------------------------------
# tests/test_native_precompiles.py: keccak256, sha256, ecrecover
# ---------------------------------------------------------------------------

def _abi(offset, length, out_word, rounds=0, out_len=0):
    return PrecompileCallABI(
        input_memory_offset=offset, input_memory_length=length,
        output_memory_offset=out_word, output_memory_length=out_len,
        memory_page_to_read=0, memory_page_to_write=0,
        precompile_interpreted_data=rounds).to_u256()


def _heap_word(out, idx):
    return out["heap"][idx]


class TestNativeKeccak:
    def test_unaligned_window(self):
        prog = f"""
        add code[@w0], r0, r2
        st.h 0, r2
        add code[@w1], r0, r3
        st.h 32, r3
        add code[@abi], r0, r4
        log.precompile r4, r0, r5
        ret r0
        abi: .word {_abi(3, 40, 3)}
        w0: .word {int.from_bytes(bytes(range(32)), 'big')}
        w1: .word {int.from_bytes(bytes(range(32, 64)), 'big')}
        """
        out = run_oracle(
            assemble_to_code_words(prog),
            entry_address=params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS)
        assert out["status"] == ST_DONE
        want = int.from_bytes(keccak256(bytes(range(3, 43))), "big")
        assert _heap_word(out, 3) == want
        # dst0 protocol: r5 == 1 before the exit wipe; check via log record
        assert len(out["log_records"]) == 1

    def test_empty_and_exact_rate(self):
        for length, fill in ((0, 0), (136, 0x41)):
            words = []
            stores = []
            n_words = (length + 31) // 32
            for i in range(n_words):
                chunk = bytes([fill] * min(32, length - 32 * i))
                chunk = chunk + bytes(32 - len(chunk))
                words.append(f"w{i}: .word {int.from_bytes(chunk, 'big')}")
                stores.append(f"add code[@w{i}], r0, r2\nst.h {32*i}, r2")
            prog = "\n".join(stores) + f"""
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            ret r0
            abi: .word {_abi(0, length, 8)}
            """ + "\n".join(words)
            out = run_oracle(
                assemble_to_code_words(prog),
                entry_address=
                params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS)
            assert out["status"] == ST_DONE, length
            want = int.from_bytes(keccak256(bytes([fill] * length)), "big")
            assert _heap_word(out, 8) == want, length


class TestNativeSha256:
    def test_one_round(self):
        msg = b"abc"
        padded = msg + b"\x80" + bytes(52) + (len(msg) * 8).to_bytes(8, "big")
        w0 = int.from_bytes(padded[:32], "big")
        w1 = int.from_bytes(padded[32:], "big")
        prog = f"""
        add code[@w0], r0, r2
        st.h 0, r2
        add code[@w1], r0, r3
        st.h 32, r3
        add code[@abi], r0, r4
        log.precompile r4, r0, r5
        ret r0
        abi: .word {_abi(0, 2, 3, rounds=1, out_len=1)}
        w0: .word {w0}
        w1: .word {w1}
        """
        out = run_oracle(
            assemble_to_code_words(prog),
            entry_address=params.SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS)
        assert out["status"] == ST_DONE
        assert _heap_word(out, 3) == int.from_bytes(
            hashlib.sha256(msg).digest(), "big")


class TestNativeEcrecoverUnsupported:
    def test_ecrecover_recovers_vs_golden(self):
        """The oracle's secp256k1 recovery == golden ecrecover_inner (plus
        the invalid-signature zero path)."""
        from era_zk_evm_tpu_torch.golden.precompiles import (
            SECP_GX, SECP_GY, SECP_N, _ec_mul, _inv_mod, ecrecover_inner,
        )

        d = 0xC0FFEE0DDF00DC0FFEE0DDF00DC0FFEE0DDF00DC0FFEE0DDF00DC0FFEE0DD01
        k = 0x8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D
        digest = int.from_bytes(keccak256(b"native recovery"), "big")
        R = _ec_mul(k, (SECP_GX, SECP_GY))
        r = R[0] % SECP_N
        s = _inv_mod(k, SECP_N) * (digest + r * d) % SECP_N
        v = R[1] & 1
        if s > SECP_N // 2:
            s = SECP_N - s
            v ^= 1
        want = ecrecover_inner(digest, v, r, s)
        assert want is not None

        prog = f"""
        add code[@dg], r0, r2
        st.h 0, r2
        add {v}, r0, r3
        st.h 32, r3
        add code[@sr], r0, r4
        st.h 64, r4
        add code[@ss], r0, r5
        st.h 96, r5
        add code[@abi], r0, r6
        log.precompile r6, r0, r7
        ret r0
        abi: .word {_abi(0, 4, 4)}
        dg: .word {digest}
        sr: .word {r}
        ss: .word {s}
        """
        out = run_oracle(
            assemble_to_code_words(prog),
            entry_address=params.ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS)
        assert out["status"] == ST_DONE
        assert _heap_word(out, 4) == 1
        assert _heap_word(out, 5) == want

        # invalid signature (r = 0): ok flag and address both zero
        bad = f"""
        add code[@dg], r0, r2
        st.h 0, r2
        add {v}, r0, r3
        st.h 32, r3
        add 0, r0, r4
        st.h 64, r4
        add code[@ss], r0, r5
        st.h 96, r5
        add code[@abi], r0, r6
        log.precompile r6, r0, r7
        ret r0
        abi: .word {_abi(0, 4, 4)}
        dg: .word {digest}
        ss: .word {s}
        """
        out = run_oracle(
            assemble_to_code_words(bad),
            entry_address=params.ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS)
        assert out["status"] == ST_DONE
        assert _heap_word(out, 4) == 0
        assert _heap_word(out, 5) == 0


class TestNativeVsGoldenPrecompileRecords:
    def test_log_record_parity(self):
        """The precompile Log-query record serializes byte-identically
        across the golden and native engines (cross-engine contract)."""
        prog = f"""
        add code[@w0], r0, r2
        st.h 0, r2
        add code[@abi], r0, r4
        log.precompile r4, r0, r5
        ret r0
        abi: .word {_abi(0, 17, 5)}
        w0: .word {int.from_bytes(bytes(range(100, 132)), 'big')}
        """
        entry = params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS
        tools = harness.create_default_tools()
        vm = harness.build_vm(assemble_to_code_words(prog), tools=tools,
                              ergs=1 << 20, entry_address=entry)
        cycles = harness.run(vm, 64)
        out = run_oracle(assemble_to_code_words(prog),
                         entry_address=entry, max_cycles=64)
        assert out["status"] == ST_DONE
        assert out["cycles"] == cycles
        want_logs = [serialize_log_query(q)
                     for _, q in tools.witness.log_queries]
        assert out["log_records"] == want_logs
        # heap digest parity
        want_heap = vm.memory.dump_page(10, 0, 64)
        assert out["heap"] == want_heap


class TestNativeKeccakFuzz:
    def test_randomized_offsets_and_lengths(self):
        rng = random.Random(0xC0FFEE)
        for _ in range(10):
            offset = rng.randrange(0, 32)
            length = rng.randrange(0, 280)
            data = bytes(rng.randrange(256) for _ in range(length))
            padded = bytes(offset) + data
            padded += bytes(-len(padded) % 32)
            words, stores = [], []
            for i in range(len(padded) // 32):
                words.append(
                    f"w{i}: .word "
                    f"{int.from_bytes(padded[32*i:32*i+32], 'big')}")
                stores.append(f"add code[@w{i}], r0, r2\nst.h {32*i}, r2")
            prog = "\n".join(stores) + f"""
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            ret r0
            abi: .word {_abi(offset, length, 20)}
            """ + "\n".join(words)
            out = run_oracle(
                assemble_to_code_words(prog), heap_words=64,
                entry_address=
                params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS)
            assert out["status"] == ST_DONE, (offset, length)
            want = int.from_bytes(keccak256(data), "big")
            assert _heap_word(out, 20) == want, (offset, length)


# ---------------------------------------------------------------------------
# the two oracles on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["random", "far_call"])
def test_the_two_oracles_agree_on_the_fuzz_campaigns(name):
    _, words, bank, entries = fz.campaign(name)
    kw = dict(ergs=fz.ERGS, max_cycles=fz.MAX_CYCLES,
              witness_cap=fz.MAX_CYCLES * 8, contracts=bank,
              storage_entries=list(entries))
    decommits = 0
    for w in words:
        ours, theirs = run_oracle(w, **kw), jax_native.run_oracle(w, **kw)
        assert ours.pop("run_seconds") > 0
        theirs.pop("run_seconds")
        assert ours == theirs
        assert ours["status"] == ST_DONE
        decommits += len(ours["decommit_records"])
    assert native._lib is not jax_native._lib
    assert (decommits > 0) == (name == "far_call")


# ---------------------------------------------------------------------------
# the port's plain engine against its oracle on the precompile programs
# ---------------------------------------------------------------------------

def test_plain_engine_on_the_precompile_lanes_matches_the_oracle():
    """`chip_smoke.py`'s K1-precompile-small lanes (every precompile test
    program and 17 txs of the precompile mix) through the plain engine,
    96 cycles, held to the oracle by `compare_lanes`, streams included, as
    the card holds K1: every lane in full, the two that run out of cycles
    too."""
    from era_zk_evm_tpu_torch.config import VmConfig, precompile_queue_slots
    from era_zk_evm_tpu_torch.models import batched_vm
    from era_zk_evm_tpu_torch.models.state import make_entry_state
    from era_zk_evm_tpu_torch.native.compare import compare_lanes
    from era_zk_evm_tpu_torch.testing import block_programs as bp

    lanes = list(bp.PRECOMPILE_LANES) + [
        (e, src) for e, src, *_ in bp.precompile_mix(17, seed=3)]
    config = VmConfig(
        batch=len(lanes), code_words=32, stack_words=256, sweep_gating=False,
        stack_abs_words=64, stack_sp_base=960, heap_words=32,
        aux_heap_words=16, max_depth=8, queue_capacity=4 * 32 * 8,
        storage_slots=8, journal_slots=64, event_slots=16,
        log_queue_capacity=4 * 32, heap_frames=2, code_pages=2,
        decommit_queue_capacity=4 * 32, precompile_keccak_blocks=2,
        precompile_sha_rounds=2)
    config = dataclasses.replace(config, precompile_queue_capacity=32 * sum(
        precompile_queue_slots(config)))
    words = [assemble_to_code_words(src) for _, src in lanes]
    st = make_entry_state(config, words, ergs=1 << 20,
                          entry_address=[e for e, _ in lanes], device="cpu")
    batched_vm.run_cycles(st, config, 96)
    want = [run_oracle(w, entry_address=e, ergs=1 << 20, max_cycles=96,
                       heap_words=config.heap_words)
            for w, (e, _) in zip(words, lanes)]
    assert sum(o["status"] == ST_DONE for o in want) >= len(lanes) - 2
    assert compare_lanes(st, want, range(len(lanes))) == ([], len(lanes))
