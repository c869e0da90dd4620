"""The LOG-family and far-call program sets, with their contracts, without JAX.

Copies of the program sets that the JAX package's tests hold its engines
to: `LOG_PROGRAMS` of `tests/test_batched_vm.py:486`, the far-call sets of
`tests/test_batched_far_call.py` (`CONTRACTS` and `FAR_PROGRAMS` :22-128,
the delegate set :130-154, `PTR_FWD_*` :194-271, `REVERTDATA_CONTRACT` :273,
`NESTED_CONTRACTS` :292 and the nested caller :325, `EDGE_CONTRACT` :398 and
the two edge callers :412-475), and the rollback, pubdata and bad-hash
programs of `tests/test_fused_cycle.py:249-318`.  `tests/test_torch_log.py`
holds every copy equal to its source.  `PRECOMPILE_OFF` is the port's own:
a `log.precompile` under a config with the precompile units off, which sets
`lane_error`.

`RUNS` groups them into two 16-lane runs, each set's lanes with their own
storage entries and code bank; `stage` assembles a run.
"""

from __future__ import annotations

from ..isa import params
from ..isa.abi import (
    FarCallABI, FatPointer, ForwardingMode, RetABI, code_hash_for_bytecode,
)
from ..isa.assembler import assemble_to_code_words

LANES = 16
PAD = "ret r0"

CALLEE = 0x10042

CALLEE2 = 0x10055

PASS_ALL = (1 << 32) - 1


def fc_abi(ergs=PASS_ALL, mode=ForwardingMode.USE_HEAP, start=0, length=0,
           to_system=False):
    return FarCallABI(FatPointer(0, 0, start, length), ergs, 0, mode,
                      False, to_system).to_u256()


def ret_abi(start=0, length=0, mode=ForwardingMode.USE_HEAP):
    return RetABI(FatPointer(0, 0, start, length), mode).to_u256()


LOG_PROGRAMS = [
    # storage write + read back
    """
    add 5, r0, r1
    add 70, r0, r2
    log.swrite r1, r2
    log.sread r1, r3
    log.sread r2, r4        ; absent key reads 0
    ret r0
    """,
    # overwrite + multiple keys
    """
    add 1, r0, r1
    add 2, r0, r2
    add 11, r0, r3
    add 22, r0, r4
    log.swrite r1, r3
    log.swrite r2, r4
    log.swrite r1, r4
    log.sread r1, r5
    log.sread r2, r6
    ret r0
    """,
    # rollback on near-call panic (incl. insert rollback)
    """
    add 5, r0, r1
    add 70, r0, r2
    log.swrite r1, r2
    add 3000, r0, r9
    near_call r9, @mutate, @h
    done:
    log.sread r1, r4
    add 9, r0, r5
    log.sread r5, r6        ; rolled-back insert reads 0
    ret r0
    mutate:
    add 99, r0, r3
    log.swrite r1, r3
    add 9, r0, r7
    log.swrite r7, r3       ; fresh insert, also rolled back
    panic
    h:
    jump @done
    """,
    # nested frames: inner success inside outer panic
    """
    add 7, r0, r1
    add 1, r0, r2
    log.swrite r1, r2
    add 4000, r0, r9
    near_call r9, @outer, @h
    done:
    log.sread r1, r4
    ret r0
    outer:
    add 2, r0, r2
    log.swrite r1, r2
    add 2000, r0, r8
    near_call r8, @inner, @oh
    panic                     ; outer panics after inner succeeded
    inner:
    add 3, r0, r2
    log.swrite r1, r2
    ret r0
    oh:
    panic
    h:
    jump @done
    """,
    # events + l1 messages with rollback cancellation
    """
    add 1, r0, r1
    add 100, r0, r2
    log.event r1, r2
    log.to_l1.first r1, r2
    add 2500, r0, r9
    near_call r9, @emitter, @h
    done:
    add 2, r0, r3
    add 200, r0, r4
    log.event.first r3, r4
    ret r0
    emitter:
    add 5, r0, r5
    add 500, r0, r6
    log.event r5, r6
    panic
    h:
    jump @done
    """,
    # pubdata ergs accounting: set price then write
    """
    add 3, r0, r1
    ctx.set_pubdata r1
    add 5, r0, r2
    add 50, r0, r3
    log.swrite r2, r3
    log.to_l1 r2, r3
    ctx.ergs r4
    ret r0
    """,
    # out-of-ergs on pubdata: to_l1 skipped, ergs zeroed, next decode panics
    """
    add 100, r0, r1
    ctx.set_pubdata r1
    add 3000, r0, r9
    near_call r9, @w, @h
    done:
    ret r0
    w:
    add 5, r0, r2
    log.to_l1 r2, r2       ; cost 100*88 >> passed ergs -> skipped + ergs 0
    add 1, r0, r3          ; masked into panic (no ergs)
    ret r0
    h:
    add 42, r0, r8
    jump @done
    """,
    # storage in tx context: inc_tx changes the recorded tx number
    """
    add 1, r0, r1
    log.swrite r1, r1
    ctx.inc_tx
    add 2, r0, r2
    log.swrite r2, r2
    log.event r1, r2
    ret r0
    """,
]

CONTRACTS = [
    (CALLEE, f"""
        ld.ptr r1, r5          ; calldata[0]
        add 1, r0, r6
        add r5, r6, r5
        st.h 0, r5             ; heap[0] = calldata[0] + 1
        add code[@rabi], r0, r7
        ret r7                 ; forward heap[0..32]
        rabi: .word {ret_abi(0, 32)}
    """),
    (CALLEE2, """
        add 5, r0, r1
        add 50, r0, r2
        log.swrite r1, r2
        revert r0
    """),
]

FAR_PROGRAMS = [
    # basic call + returndata read-back
    f"""
    add 41, r0, r3
    st.h 0, r3
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @on_fail
    ld.ptr r1, r10          ; returndata[0] == 42
    ret r0
    on_fail:
    add 99, r0, r9
    ret r0
    abi: .word {fc_abi(length=32)}
    dest: .word {CALLEE}
    """,
    # revert runs handler + storage rolls back
    f"""
    add code[@abi], r0, r4
    add code[@dest2], r0, r2
    far_call r4, r2, @on_fail
    add 1, r0, r8
    ret r0
    on_fail:
    add 5, r0, r1
    log.sread r1, r9       ; rolled-back 0
    add 7, r0, r11
    ret r0
    abi: .word {fc_abi()}
    dest2: .word {CALLEE2}
    """,
    # unknown-address call with zero default AA: masked AA hash 0 -> panic
    f"""
    add code[@abi], r0, r4
    add code[@dest3], r0, r2
    far_call r4, r2, @on_fail
    add 1, r0, r8
    ret r0
    on_fail:
    add 7, r0, r9
    ret r0
    abi: .word {fc_abi()}
    dest3: .word 0x77777
    """,
    # repeat decommit: second call is stale (refund path)
    f"""
    add 1, r0, r3
    st.h 0, r3
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @fail
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @fail
    ld.ptr r1, r10
    ret r0
    fail:
    add 99, r0, r9
    ret r0
    abi: .word {fc_abi(length=32)}
    dest: .word {CALLEE}
    """,
    # zero-ergs far call: callee immediately out of ergs -> handler
    f"""
    add code[@abi0], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @on_fail
    add 1, r0, r8
    ret r0
    on_fail:
    add 3, r0, r9
    ret r0
    abi0: .word {fc_abi(ergs=0)}
    dest: .word {CALLEE}
    """,
    # static far call: callee's storage write masks to panic
    f"""
    add code[@abi], r0, r4
    add code[@dest2], r0, r2
    far_call.static r4, r2, @on_fail
    add 1, r0, r8
    ret r0
    on_fail:
    add 11, r0, r9
    ret r0
    abi: .word {fc_abi()}
    dest2: .word {CALLEE2}
    """,
]

DELEGATE_PROGRAMS = [
    # delegate keeps identity; callee writes ctx.this into storage
    f"""
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    delegate_call r4, r2, @fail
    add 1, r0, r6
    log.sread r6, r10
    ret r0
    fail:
    add 99, r0, r9
    ret r0
    abi: .word {fc_abi()}
    dest: .word {CALLEE}
    """,
]

DELEGATE_CONTRACTS = [
    (CALLEE, """
        ctx.this r5
        add 1, r0, r6
        log.swrite r6, r5
        ret r0
    """),
]

PTR_FWD_CONTRACTS = [
    (CALLEE, f"""
        ld.ptr r1, r5           ; calldata[0]
        st.h 0, r5
        ptr.add r1, r0, r6      ; copy of calldata ptr (offset +0)
        add 32, r0, r7
        ptr.add r6, r7, r6      ; offset 32
        ld.ptr r6, r8           ; calldata[1]
        st.h 32, r8
        ptr.shrink r1, r7, r9   ; length -= 32
        ptr.pack r9, r0, r10    ; pack with zero high -> same ptr
        add code[@rabi], r0, r7
        ret r7
        rabi: .word {ret_abi(0, 64)}
    """),
    (CALLEE2, f"""
        ld.ptr r1, r5
        add 1, r0, r6
        add r5, r6, r5
        st.h 0, r5
        add code[@rfwd], r0, r7
        ret r7                  ; forward our own CALLDATA pointer? banned ->
                                ; instead forward heap normally
        rfwd: .word {ret_abi(0, 32)}
    """),
]

PTR_FWD_PROGRAMS = [
    # two-word calldata; callee echoes both words via ptr arithmetic
    f"""
    add 1111, r0, r3
    st.h 0, r3
    add 2222, r0, r5
    st.h 32, r5
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @fail
    ld.ptr r1, r10          ; returndata[0] == 1111
    add 32, r0, r3
    ptr.add r1, r3, r6
    ld.ptr r6, r11          ; returndata[1] == 2222
    ret r0
    fail:
    add 99, r0, r9
    ret r0
    abi: .word {fc_abi(length=64)}
    dest: .word {CALLEE}
    """,
    # nested far calls: A calls B which calls A's sibling? use CALLEE2 -> heap fwd
    f"""
    add 41, r0, r3
    st.h 0, r3
    add code[@abi], r0, r4
    add code[@dest2], r0, r2
    far_call r4, r2, @fail
    ld.ptr r1, r10          ; 42
    ret r0
    fail:
    add 99, r0, r9
    ret r0
    abi: .word {fc_abi(length=32)}
    dest2: .word {CALLEE2}
    """,
    # revert with returndata: callee writes then reverts forwarding heap
    f"""
    add code[@abi], r0, r4
    add code[@dest3], r0, r2
    far_call r4, r2, @on_fail
    add 1, r0, r8
    ret r0
    on_fail:
    ld.ptr r1, r10          ; revert data readable in the handler
    add 2, r0, r11
    ret r0
    abi: .word {fc_abi()}
    dest3: .word 0x10077
    """,
]

REVERTDATA_CONTRACT = [(0x10077, f"""
    add 5151, r0, r2
    st.h 0, r2
    add code[@rabi], r0, r7
    revert r7
    rabi: .word {ret_abi(0, 32)}
""")]

NESTED_CONTRACTS = [
    (CALLEE, f"""
        ld.ptr r1, r5
        add 1, r0, r6
        add r5, r6, r5          ; +1
        st.h 0, r5
        add code[@abi2], r0, r4
        add code[@dest2], r0, r2
        far_call r4, r2, @fail  ; nested call to CALLEE2
        ld.ptr r1, r7           ; nested returndata
        st.h 0, r7
        add code[@rabi], r0, r7
        ret r7
        fail:
        panic
        abi2: .word {fc_abi(length=32)}
        dest2: .word {CALLEE2}
        rabi: .word {ret_abi(0, 32)}
    """),
    (CALLEE2, f"""
        ld.ptr r1, r5
        add 10, r0, r6
        add r5, r6, r5          ; +10
        st.h 0, r5
        add code[@rabi], r0, r7
        ret r7
        rabi: .word {ret_abi(0, 32)}
    """),
]

EDGE_CONTRACT = [(CALLEE, f"""
    ld.ptr r1, r5
    st.h 0, r5
    st.h 32, r5
    add code[@rabi], r0, r7
    ret r7                    ; 40-byte returndata (unaligned length)
    rabi: .word {ret_abi(0, 40)}
""")]


# tests/test_fused_cycle.py TestFusedLogFamily / TestFusedFarCall
ROLLBACK = """
    add 9, r0, r1
    add 11, r0, r2
    log.swrite r1, r2
    add 3000, r0, r9
    near_call r9, @w, @h
    done:
    log.sread r1, r5
    ret r0
    w:
    add 55, r0, r3
    log.swrite r1, r3
    log.event r1, r3
    panic
    h:
    jump @done
"""
PUBDATA_OUT_OF_ERGS = """
    add 120, r0, r1
    ctx.set_pubdata r1
    add 1, r0, r2
    add 190, r0, r9
    near_call r9, @w, @h
    done:
    ret r0
    w:
    log.swrite r2, r2
    ret r0
    h:
    add 7, r0, r7
    jump @done
"""
BAD_HASH = """
    add code[@abi], r0, r4
    add 77, r0, r2
    far_call r4, r2, @h
    ret r0
    h:
    add 5, r0, r5
    ret r0
    abi: .word 0
"""
# tests/test_batched_far_call.py TestNestedFarCalls / TestFatPointerEdges
NESTED = f"""
    add 100, r0, r3
    st.h 0, r3
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @fail
    ld.ptr r1, r10
    ret r0
    fail:
    add 99, r0, r9
    ret r0
    abi: .word {fc_abi(length=32)}
    dest: .word {CALLEE}
"""
EDGE_TAIL = f"""
    add code[@v], r0, r3
    st.h 0, r3
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @fail
    ld.ptr r1, r10
    add 8, r0, r3
    ptr.add r1, r3, r6
    ld.ptr r6, r11
    add 9, r0, r3
    ptr.add r1, r3, r6
    ld.ptr r6, r12
    add 39, r0, r3
    ptr.add r1, r3, r6
    ld.ptr r6, r13
    add 40, r0, r3
    ptr.add r1, r3, r6
    ld.ptr r6, r14
    add 2, r0, r3
    ptr.shrink r1, r3, r6
    add 7, r0, r3
    ptr.add r6, r3, r6
    ld.ptr r6, r15
    ret r0
    fail:
    panic
    abi: .word {fc_abi(length=32)}
    dest: .word {CALLEE}
    v: .word 0x0102030405060708090A0B0C0D0E0F101112131415161718191A1B1C1D1E1F20
"""
EDGE_UNALIGNED = f"""
    add code[@v], r0, r3
    st.h 0, r3
    add code[@w], r0, r5
    st.h 32, r5
    add code[@abi], r0, r4
    add code[@dest2], r0, r2
    far_call r4, r2, @fail
    add 1, r0, r8
    ret r0
    fail:
    panic
    abi: .word {fc_abi(length=64)}
    dest2: .word 0x30011
    v: .word 0x1111111111111111222222222222222233333333333333334444444444444444
    w: .word 0x5555555555555555666666666666666677777777777777778888888888888888
"""
UNALIGNED_CALLEE = [(0x30011, """
    add 3, r0, r9
    ptr.add r1, r9, r6
    ld.ptr r6, r5
    st.h 0, r5
    add 31, r0, r9
    ptr.add r1, r9, r6
    ld.ptr r6, r7
    st.h 32, r7
    ret r0
""")]

# the port's own: a precompile call from kernel space under a config whose
# precompile units are off (precompile_keccak_blocks == 0), which sets
# lane_error and still spends ergs and logs a row; testing/block_programs.py
# has the programs that run the units
PRECOMPILE_OFF = """
    add 17, r0, r4
    add 40, r0, r1
    log.precompile r4, r1, r5
    ret r0
"""

#: run -> {set: (programs, contracts)}; every lane of a set gets its contracts
RUNS = {
    "log": {
        "log_programs": (LOG_PROGRAMS, []),
        "rollback_pubdata": ([ROLLBACK, PUBDATA_OUT_OF_ERGS], []),
        "bad_hash": ([BAD_HASH], []),
        "precompile_off": ([PRECOMPILE_OFF], []),
    },
    "far": {
        "far_programs": (FAR_PROGRAMS, CONTRACTS),
        "delegate_mimic": (DELEGATE_PROGRAMS, DELEGATE_CONTRACTS),
        "ptr_fwd": (PTR_FWD_PROGRAMS[:2], PTR_FWD_CONTRACTS),
        "revertdata": ([PTR_FWD_PROGRAMS[2]], REVERTDATA_CONTRACT),
        "nested": ([NESTED], NESTED_CONTRACTS),
        "edge": ([EDGE_TAIL, EDGE_UNALIGNED], None),
    },
}
EDGE_LANE_CONTRACTS = [EDGE_CONTRACT, UNALIGNED_CALLEE]
SETS = [(run, name) for run, sets in RUNS.items() for name in sets]


def lane_plan(run: str):
    """(sources, per-lane contract lists, {set: (lo, hi)}) of one run."""
    sources, contracts, spans = [], [], {}
    for name, (progs, cons) in RUNS[run].items():
        spans[name] = (len(sources), len(sources) + len(progs))
        sources += progs
        contracts += (EDGE_LANE_CONTRACTS if cons is None
                      else [cons] * len(progs))
    assert len(sources) <= LANES
    pad = LANES - len(sources)
    return sources + [PAD] * pad, contracts + [[]] * pad, spans


def stage(run: str):
    """(code words per lane, storage entries per lane, code bank per lane):
    each contract's code hash stored under the deployer at its address."""
    sources, contracts, _ = lane_plan(run)
    words = [assemble_to_code_words(s) for s in sources]
    entries, banks = [], []
    for cons in contracts:
        lane_entries, lane_bank = [], []
        for address, src in cons:
            w = assemble_to_code_words(src)
            h = code_hash_for_bytecode(w)
            lane_entries.append(
                (0, params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, address, h))
            lane_bank.append((h, w))
        entries.append(lane_entries)
        banks.append(lane_bank)
    return words, entries, banks
