"""The program sets of `tests/test_batched_vm.py` that the port's
differential harness replays, as jax-free copies: `BASIC_PROGRAMS`,
`CONTROL_FLOW`, `STACK_PROGRAMS`, `UMA_PROGRAMS`, and the bootloader
calldata entry's programs (`TestDifferential.test_bootloader_calldata`,
with `CALLDATA`).  `tests/test_torch_differential.py` holds each copy
equal to its source.
"""

BASIC_PROGRAMS = [
    # arithmetic + flags
    """
    add 7, r0, r1
    add 35, r0, r2
    add! r1, r2, r3
    sub! r3, r1, r4
    ret r0
    """,
    # overflow / underflow flags
    """
    add 1, r0, r1
    sub! r0, r1, r2
    add! r2, r1, r3
    add.if_eq 5, r0, r4
    add.if_lt 6, r0, r5
    ret r0
    """,
    # mul/div incl. by-zero
    """
    add 1000, r0, r1
    add 999, r0, r2
    mul! r1, r2, r3, r4
    add 7, r0, r5
    div! r3, r5, r6, r7
    div! r6, r0, r8, r9
    ret r0
    """,
    # shifts and rotates
    """
    add 1, r0, r1
    add 200, r0, r2
    shl r1, r2, r3
    add 60, r0, r4
    rol r3, r4, r5
    ror r1, r1, r6
    shr! r1, r1, r7
    ret r0
    """,
    # binops
    """
    add 12, r0, r1
    add 10, r0, r2
    xor r1, r2, r3
    and r1, r2, r4
    or! r1, r2, r5
    ret r0
    """,
    # swapped operands
    """
    add 10, r0, r1
    add 3, r0, r2
    sub.s r1, r2, r3
    sub r1, r2, r4
    shl.s r2, r1, r5
    ret r0
    """,
]

CONTROL_FLOW = [
    # loop with conditional backward jump
    """
    add 1, r0, r10
    add 5, r0, r1
    add 0, r0, r2
    loop:
    add r2, r1, r2
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    """,
    # masked nops
    """
    add 1, r0, r1
    sub! r1, r1, r2
    add.if_ne 99, r0, r3
    add.if_eq 42, r0, r4
    add.if_gt 17, r0, r5
    add.if_le 23, r0, r6
    ret r0
    """,
    # jump via register
    """
    add 4, r0, r1
    jump r1
    add 111, r0, r2     ; skipped
    add 222, r0, r3     ; skipped
    add 5, r0, r4
    ret r0
    """,
]

STACK_PROGRAMS = [
    """
    add 11, r0, r1
    add r1, r0, stack+=[1]
    add 22, r0, r2
    add r2, r0, stack+=[1]
    add stack-=[1], r0, r3
    add stack-=[1], r0, r4
    ret r0
    """,
    """
    add 7, r0, r1
    add r1, r0, stack[100]
    add stack[100], r0, r2
    add 5, r0, r3
    add r3, r0, stack+=[1]
    add stack-[1], r0, r4
    ctx.sp r5
    ret r0
    """,
    # code-page constants
    """
    add code[@k1], r0, r1
    add code[@k2], r0, r2
    add r1, r2, r3
    ret r0
    k1: .word 0xdeadbeefcafebabe112233445566778899aabbccddeeff0012345678deadbeef
    k2: .word 0x1
    """,
]

UMA_PROGRAMS = [
    # aligned heap rw
    """
    add 1234, r0, r2
    st.h 64, r2
    ld.h 64, r3
    ret r0
    """,
    # unaligned rw + word0 inspection
    """
    add 5, r0, r1
    add 251, r0, r2
    shl r1, r2, r1
    add 3, r0, r5
    st.h r5, r1
    ld.h r5, r3
    ld.h 0, r4
    ld.h 32, r6
    ret r0
    """,
    # increment variants
    """
    add 777, r0, r2
    st.h 0, r2
    add 888, r0, r3
    st.h 32, r3
    ld.h.inc 0, r4, r5
    ld.h r5, r6
    st.h.inc 64, r2, r7
    ret r0
    """,
    # aux heap
    """
    add 4242, r0, r2
    st.ah 0, r2
    ld.ah 0, r3
    ld.h 0, r4
    ret r0
    """,
    # heap growth ergs
    """
    add 1500, r0, r1
    ld.h r1, r2
    ctx.ergs r3
    st.ah 1100, r3
    ctx.ergs r4
    ret r0
    """,
]

CALLDATA_PROGRAMS = [
    # read word 0 and word 1 via ld.ptr + ptr.add
    """
    ld.ptr r1, r5
    add 32, r0, r6
    ptr.add r1, r6, r2
    ld.ptr r2, r7
    add r5, r7, r8
    st.h 0, r8
    ret r0
    """,
    # walk past length: tail bytes read as zero
    """
    add 64, r0, r6
    ptr.add r1, r6, r2
    ld.ptr r2, r7
    st.h 0, r7
    ret r0
    """,
    # shrink then read inside the shrunk window
    """
    add 32, r0, r6
    ptr.shrink r1, r6, r2
    ld.ptr r2, r7
    st.h 0, r7
    ret r0
    """,
]

CALLDATA = [0xDEADBEEF << 128, 0x1234, (1 << 255) | 7]
