"""Assembler sources for driving the port without the JAX package or its tests.

Copies of the repo's bench programs, each held equal to its source by a test
(`tests/test_torch_slice.py`, `tests/test_torch_log.py`):

  * `WORKLOAD`: `bench.py:130` (`WORKLOAD`), the memory-witness slice's
    bench program;
  * `STORAGE_WORKLOAD`: `bench.py:231` (`STORAGE_WORKLOAD`), the storage /
    event loop of `bench_storage`;
  * `tiny_mix_program(iters)`: `bench.py:583-599` (`bench_block`'s `prog`),
    the tiny-mix transaction: storage, events and heap in every iteration;
  * `farcall_callee()` / `farcall_caller(callee_addr)`: `bench.py:314-342`
    (`bench_farcall`), a caller that far-calls one callee in a loop.

`FAMILY_PROGRAMS` has a few short programs for each opcode family of the
memory-witness slice, plus two masking cases: a kernel-only context op from
user space, and a LOG opcode, which sets `lane_error` under a config with
`storage_slots == 0` and runs under one with storage.
"""

# a sustained mixed workload: arithmetic, stack traffic, unaligned-capable
# heap access, conditional control flow — ~10 cycles per iteration, 2^15 iters
WORKLOAD = """
    add 1, r0, r10
    add code[@n], r0, r1
    add 0, r0, r2
    loop:
    add r2, r1, r2
    mul r2, r1, r3, r4
    xor r3, r2, r5
    shl r5, r10, r6
    add r6, r0, stack+=[1]
    add stack-=[1], r0, r7
    st.h 0, r7
    ld.h 32, r8
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    n: .word 32768
"""

FAMILY_PROGRAMS = {
    "arith": """
        add 7, r0, r1
        add 35, r0, r2
        add! r1, r2, r3
        sub! r3, r1, r4
        sub.s! r1, r3, r5
        mul! r3, r4, r6, r7
        div! r6, r1, r8, r9
        div! r6, r0, r10, r11
        ret r0
    """,
    "shift_binop": """
        add 1, r0, r1
        add 200, r0, r2
        shl r1, r2, r3
        add 60, r0, r4
        rol r3, r4, r5
        ror r1, r1, r6
        shr! r1, r1, r7
        xor r3, r5, r8
        and r5, r3, r9
        or! r1, r2, r10
        ret r0
    """,
    "control_flow": """
        add 1, r0, r10
        add 5, r0, r1
        add 0, r0, r2
        loop:
        add r2, r1, r2
        sub! r1, r10, r1
        jump.if_ne @loop
        add.if_eq 42, r0, r4
        add.if_gt 17, r0, r5
        ret r0
    """,
    "stack": """
        add 11, r0, r1
        add r1, r0, stack+=[1]
        add 22, r0, r2
        add r2, r0, stack+=[1]
        add stack-=[1], r0, r3
        add stack-=[1], r0, r4
        add r1, r0, stack[7]
        add stack[7], r0, r5
        add code[@k], r0, r6
        ctx.sp r7
        ret r0
        k: .word 0xdeadbeefcafebabe112233445566778899aabbccddeeff0012345678deadbeef
    """,
    "uma": """
        add 5, r0, r1
        add 251, r0, r2
        shl r1, r2, r1
        add 3, r0, r5
        st.h r5, r1
        ld.h r5, r3
        ld.h.inc 0, r4, r6
        st.h.inc 64, r2, r7
        add 4242, r0, r8
        st.ah 0, r8
        ld.ah 0, r9
        ret r0
    """,
    "near_call": """
        add 5, r0, r1
        near_call r0, @double, @fail
        add 2000, r0, r9
        near_call r9, @fail_fn, @handler
        ret r0
        double:
        add r1, r1, r1
        ret r0
        fail_fn:
        panic
        handler:
        add.if_lt 77, r0, r3
        ret r0
        fail:
        panic
    """,
    "context": """
        ctx.this r1
        ctx.caller r2
        ctx.code_addr r3
        ctx.ergs r4
        ctx.meta r6
        add 99, r0, r8
        ctx.set_u128 r8
        ctx.set_pubdata r8
        ctx.inc_tx
        ctx.get_u128 r7
        ret r0
    """,
    "ptr_panic": """
        add 2000, r0, r9
        near_call r9, @bad_ptr, @h
        done:
        ret r0
        bad_ptr:
        add 5, r0, r1
        ptr.add r1, r2, r3
        ret r0
        h:
        add 66, r0, r4
        jump @done
    """,
    "user_mode_masking": """
        add 2000, r0, r9
        near_call r9, @k, @h
        done:
        ret r0
        k:
        ctx.inc_tx
        ret r0
        h:
        add 3, r0, r3
        jump @done
    """,
    "unsupported_log": """
        add 1, r0, r1
        log.sread r1, r2
        ret r0
    """,
}


STORAGE_WORKLOAD = """
    add 1, r0, r10
    add code[@n], r0, r1
    add 0, r0, r2
    loop:
    and r1, r10, r3
    add r3, r10, r3
    log.swrite r3, r1
    log.sread r3, r4
    log.event r3, r4
    add r4, r2, r2
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    n: .word 32768
"""

#: the address bench_farcall gives its callee
FARCALL_CALLEE_ADDRESS = 0x20042


def tiny_mix_program(iters: int) -> str:
    """bench_block's tiny-mix transaction with `iters` loop iterations."""
    return f"""
        add 1, r0, r10
        add code[@n], r0, r1
        add 0, r0, r2
        loop:
        and r1, r10, r3
        add r3, r10, r3
        log.swrite r3, r1
        log.sread r3, r4
        log.event r3, r4
        st.h 0, r4
        add r4, r2, r2
        sub! r1, r10, r1
        jump.if_ne @loop
        ret r0
        n: .word {iters}
    """


def farcall_callee() -> str:
    """bench_farcall's callee: returns calldata[0] + 1 in heap[0..32]."""
    from ..isa.abi import FatPointer, ForwardingMode, RetABI

    r_abi = RetABI(FatPointer(0, 0, 0, 32), ForwardingMode.USE_HEAP).to_u256()
    return f"""
        ld.ptr r1, r5
        add 1, r0, r6
        add r5, r6, r5
        st.h 0, r5
        add code[@rabi], r0, r7
        ret r7
        rabi: .word {r_abi}
    """


def farcall_caller(callee_addr: int = FARCALL_CALLEE_ADDRESS) -> str:
    """bench_farcall's caller: 4096 far calls to `callee_addr`, each passing
    heap[0..32] and reading the returndata back."""
    from ..isa.abi import FarCallABI, FatPointer, ForwardingMode

    f_abi = FarCallABI(FatPointer(0, 0, 0, 32), (1 << 32) - 1, 0,
                       ForwardingMode.USE_HEAP, False, False).to_u256()
    return f"""
        add 1, r0, r10
        add code[@n], r0, r13
        add 0, r0, r3
        loop:
        st.h 0, r3
        add code[@abi], r0, r4
        add code[@dest], r0, r2
        far_call r4, r2, @fail
        ld.ptr r1, r3
        sub! r13, r10, r13
        jump.if_ne @loop
        ret r0
        fail:
        panic
        abi: .word {f_abi}
        dest: .word {callee_addr}
        n: .word 4096
    """


def assemble(source: str) -> list[int]:
    """Assembler source -> code words (the port's copy of the assembler)."""
    from ..isa.assembler import assemble_to_code_words

    return assemble_to_code_words(source)
