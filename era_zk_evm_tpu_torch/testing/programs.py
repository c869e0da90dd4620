"""Assembler sources for driving the port without the JAX package's tests.

`WORKLOAD` is the bench program of the repo (`bench.py`); a test holds the
copy equal to it.  `FAMILY_PROGRAMS` has a few short programs for each opcode
family of the ported slice, plus the two masking cases: a kernel-only
context op from user space, and a LOG opcode (outside the slice, so the lane
sets `lane_error`).
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


def assemble(source: str) -> list[int]:
    """Assembler source -> code words (the repo's assembler)."""
    from era_zk_evm_tpu.isa.assembler import assemble_to_code_words

    return assemble_to_code_words(source)
