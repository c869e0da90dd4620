"""The witness-path programs of the JAX tests, jax-free: the bootloader
block of `tests/test_bootloader.py` and the log mixes of
`tests/test_sorted_queue.py`, with their configs and staging.

`tests/test_torch_net_states.py` and `tests/test_torch_sorted_queue.py`
hold the copies equal to their sources.
"""

from __future__ import annotations

from ..config import VmConfig
from ..isa import params
from ..isa.abi import code_hash_for_bytecode
from ..isa.assembler import assemble_to_code_words
from ..models.state import (
    make_entry_state, populate_code_bank, populate_storage,
)

# ---------------------------------------------------------------------------
# The bootloader block (tests/test_bootloader.py): one VM reads tx
# descriptors from its calldata, far-calls each tx's contract and advances
# tx_number_in_block between them
# ---------------------------------------------------------------------------

MAX_CYCLES = 160

#: the block's contracts: each writes one storage slot and emits one event
#: carrying its own marker value
TX_ADDRS = [0x10001, 0x10002, 0x10003]
TX_MARKS = [101, 202, 303]

CALLEES = [
    f"""
    add {mark}, r0, r1
    log.swrite r1, r1
    log.event r1, r1
    ret r0
    """
    for mark in TX_MARKS
]

#: word 0 = N, words 1..N = the callee address of tx i
TX_SEQUENCE = [0, 1, 2, 0]   # tx 3 re-calls contract 0 (repeat decommit)
CALLDATA = [len(TX_SEQUENCE)] + [TX_ADDRS[i] for i in TX_SEQUENCE]

BOOTLOADER = f"""
    add 1, r0, r11
    add 32, r0, r12
    ld.ptr r1, r5
    add r5, r0, r7
    add 0, r0, r6
    copy:
    ptr.add r1, r12, r1
    ld.ptr r1, r2
    add r6, r12, r6
    st.h r6, r2
    sub! r7, r11, r7
    jump.if_ne @copy
    add r5, r0, r7
    add 0, r0, r6
    loop:
    add r6, r12, r6
    ld.h r6, r2
    add r6, r0, stack+=[1]
    add r7, r0, stack+=[1]
    add code[@abi], r0, r4
    far_call r4, r2, @fail
    ctx.inc_tx
    add stack-=[1], r0, r7
    add stack-=[1], r0, r6
    add 1, r0, r11
    add 32, r0, r12
    sub! r7, r11, r7
    jump.if_ne @loop
    ret r0
    fail:
    panic
    abi: .word {0xFFFFFFFF << 192}
"""


def bootloader_config(batch: int) -> VmConfig:
    """tests/test_bootloader.py::_config."""
    return VmConfig(
        batch=batch, queue_capacity=MAX_CYCLES * 8, heap_words=64,
        stack_words=2048, code_words=64, max_depth=8,
        storage_slots=16, journal_slots=32, event_slots=32,
        log_queue_capacity=MAX_CYCLES,
        heap_frames=2 + len(TX_SEQUENCE), code_pages=1 + len(TX_ADDRS),
        decommit_queue_capacity=MAX_CYCLES)


def bootloader_state(config: VmConfig, device):
    """Every lane at the bootloader's entry with the block's calldata and
    its contracts deployed (storage entries and code bank), on `device`."""
    entries, bank = [], []
    for addr, src in zip(TX_ADDRS, CALLEES):
        words = assemble_to_code_words(src)
        h = code_hash_for_bytecode(words)
        entries.append((0, params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, addr, h))
        bank.append((h, words))
    B = config.batch
    st = make_entry_state(config, [assemble_to_code_words(BOOTLOADER)] * B,
                          ergs=1 << 24, calldata=[CALLDATA] * B,
                          device=device)
    populate_storage(st, config, [entries] * B)
    populate_code_bank(st, config, [bank] * B)
    return st


# ---------------------------------------------------------------------------
# The log mixes of tests/test_sorted_queue.py: storage writes and reads in
# descending key order, events and an L1 message, deliberately unsorted
# ---------------------------------------------------------------------------

PROG = """
    add 9, r0, r1
    add 111, r0, r2
    log.swrite r1, r2
    add 3, r0, r1
    log.swrite r1, r2
    log.event r2, r1
    add 6, r0, r1
    log.sread r1, r3
    log.swrite r1, r2
    log.to_l1! r1, r2
    add 3, r0, r1
    log.sread r1, r3
    ret r0
"""

PROG2 = """
    add 5, r0, r1
    add 77, r0, r2
    log.swrite r1, r2
    log.event r1, r2
    add 2, r0, r1
    log.swrite r1, r2
    log.sread r1, r3
    ret r0
"""


def sorted_queue_config(batch: int) -> VmConfig:
    """tests/test_sorted_queue.py::_run's geometry (32 cycles)."""
    return VmConfig(batch=batch, queue_capacity=0, heap_words=16,
                    stack_words=2048, code_words=64, max_depth=8,
                    storage_slots=8, journal_slots=16, event_slots=16,
                    log_queue_capacity=32)
