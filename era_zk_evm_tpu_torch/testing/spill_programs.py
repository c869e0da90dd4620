"""The segmented executor's programs, without JAX.

Copies of `tests/test_executor.py:21-76`: `R_ABI` / `F_ABI` (the callees'
return and the caller's far-call ABI words), `callees(n)` (n small
contracts, each one storage write and a return) and `caller(callees,
key_base, depth, iters)`: a recursion burst to `depth` (a `log.event` a
level), then `iters` rounds of a distinct storage write, a heap store and
load, and a far call round-robin over `callees`.  With tight geometry the
program drives every spill protocol: the callstack window, the storage
KV, the code bank and the heap frames.  `tests/test_torch_executor.py`
holds the copies equal to their source; `chip_smoke.py`'s segmented-block
phase gives each lane its own `key_base`, depth, round count and callee
order (the list rotated), all arguments.  `stage` and `cold_code_hosts`
set a run up as that file's tests do.
"""

from __future__ import annotations

import numpy as np

from ..config import VmConfig
from ..isa import params
from ..isa.abi import (
    FarCallABI, FatPointer, ForwardingMode, RetABI, code_hash_for_bytecode,
)
from ..isa.assembler import assemble_to_code_words
from ..models.executor import BlockHosts
from ..models.state import (
    make_entry_state, populate_code_bank, populate_storage,
)
from ..utils import to_limbs

R_ABI = RetABI(FatPointer(0, 0, 0, 0), ForwardingMode.USE_HEAP).to_u256()
F_ABI = FarCallABI(FatPointer(0, 0, 0, 0), 1 << 30, 0,
                   ForwardingMode.USE_HEAP, False, False).to_u256()


def callees(n=3):
    """[(address, code hash, words)] of n callees."""
    out = []
    for k in range(n):
        words = assemble_to_code_words(f"""
            add {k + 21}, r0, r11
            log.swrite r11, r11
            add code[@rabi], r0, r7
            ret r7
            rabi: .word {R_ABI}
        """)
        out.append((0x40000 + k, code_hash_for_bytecode(words), words))
    return out


def caller(callees, key_base: int, depth: int, iters: int):
    """Recursion burst to `depth`, then `iters` rounds of: distinct storage
    write + heap store/load + far call (round-robin over the callees)."""
    body = "\n".join(f"""
        add r9, r10, r9
        add r9, r14, r12
        log.swrite r12, r12
        st.h 0, r12
        ld.h 0, r8
        add code[@abi], r0, r4
        add code[@d{k % len(callees)}], r0, r2
        far_call r4, r2, @fail
    """ for k in range(iters))
    dests = "\n".join(f"d{k}: .word {callees[k][0]}"
                      for k in range(len(callees)))
    return assemble_to_code_words(f"""
        add 1, r0, r10
        add code[@depth], r0, r13
        add code[@base], r0, r14
        add 0, r0, r9
        near_call r0, @rec, @fail
        {body}
        ret r0
        rec:
        log.event r13, r13
        sub! r13, r10, r13
        jump.if_eq @leaf
        near_call r0, @rec, @fail
        leaf:
        ret r0
        fail:
        panic
        abi: .word {F_ABI}
        depth: .word {depth}
        base: .word {key_base}
        {dests}
    """)


def stage(config: VmConfig, programs: list, callees: list, staged: list,
          device):
    """The entry state of `programs` (one a lane) with every callee's code
    hash at the deployer and the `staged` callees in each lane's code
    bank, on `device`."""
    entries = [(0, params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, a, h)
               for a, h, _ in callees]
    st = make_entry_state(config, programs, ergs=1 << 24, device=device)
    populate_storage(st, config, [entries] * config.batch)
    return populate_code_bank(st, config, [[(h, w) for _, h, w in staged]]
                              * config.batch)


def cold_code_hosts(config: VmConfig, cold: list) -> BlockHosts:
    """BlockHosts whose code maps hold the `cold` callees from t = 0, as
    evicted contracts that were never bound to a page."""
    hosts = BlockHosts.empty(config.batch)
    for _, code_hash, words in cold:
        arena = np.zeros((config.code_words, 8), dtype=np.uint32)
        for i, w in enumerate(words):
            arena[i] = to_limbs(w)
        key = tuple(int(x) for x in to_limbs(code_hash))
        for lane in hosts.code.maps:
            lane[key] = {"page": 0, "len": len(words), "words": arena.copy()}
    return hosts
