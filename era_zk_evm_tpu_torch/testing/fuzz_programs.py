"""The random programs of the JAX package's cross-engine fuzz, without JAX.

Copies of `_random_program` (`tests/test_batched_vm.py:388`) and
`_random_far_call_scenario` (`tests/test_batched_far_call.py:342`), and the
two campaigns of `tests/test_cross_engine_fuzz.py` that hold an engine to
the native C++ oracle: 48 random programs (seed 0xF00D) and the callers of
two random far-call scenarios (seeds 0xD01, 0xD02) with their contracts, at
the file's `VmConfig`s and 160 cycles.  `tests/test_torch_fuzz.py` holds the
copies equal to their sources and runs the campaigns through the port;
`chip_smoke.py` runs them on the card.
"""

from __future__ import annotations

import random

from ..config import VmConfig
from ..isa import params
from ..isa.abi import code_hash_for_bytecode
from ..isa.assembler import assemble_to_code_words
from ..models.state import (
    DEFAULT_DEVICE, make_entry_state, populate_code_bank, populate_storage,
)
from .log_programs import PASS_ALL, fc_abi, ret_abi

MAX_CYCLES = 160
ERGS = 1 << 20
PROGRAM_SEED = 0xF00D
FAR_CALL_SEEDS = (0xD01, 0xD02)


def random_program(rng: random.Random) -> str:
    """A random terminating program over the device-supported subset."""
    lines = []
    n_ops = rng.randrange(5, 30)
    regs = [f"r{i}" for i in range(0, 9)]

    def r():
        return rng.choice(regs)

    for i in range(n_ops):
        kind = rng.randrange(14)
        if kind in (0, 1, 2):
            op = rng.choice(["add", "sub", "mul", "div", "xor", "and", "or",
                             "shl", "shr", "rol", "ror"])
            bang = "!" if rng.random() < 0.4 else ""
            extra = ", r" + str(rng.randrange(1, 9)) \
                if op in ("mul", "div") else ""
            lines.append(f"{op}{bang} {r()}, {r()}, r{rng.randrange(1, 9)}{extra}")
        elif kind == 3:
            lines.append(f"add {rng.randrange(0, 65536)}, {r()}, r{rng.randrange(1, 9)}")
        elif kind == 4:
            lines.append(f"add {r()}, r0, stack+=[1]")
            lines.append(f"add stack-=[1], r0, r{rng.randrange(1, 9)}")
        elif kind == 5:
            slot = rng.randrange(0, 200)
            lines.append(f"add {r()}, r0, stack[{slot}]")
            lines.append(f"add stack[{slot}], r0, r{rng.randrange(1, 9)}")
        elif kind == 6:
            off = rng.randrange(0, 900)
            lines.append(f"st.h {off}, {r()}")
            lines.append(f"ld.h {off}, r{rng.randrange(1, 9)}")
        elif kind == 7:
            off = rng.randrange(0, 1200)
            lines.append(f"ld.h {off}, r{rng.randrange(1, 9)}")
        elif kind == 8:
            cond = rng.choice(["if_eq", "if_ne", "if_gt", "if_lt", "if_ge",
                               "if_le", "if_gt_or_lt"])
            lines.append(f"add.{cond} {rng.randrange(100)}, r0, r{rng.randrange(1, 9)}")
        elif kind == 9:
            lines.append(rng.choice(
                ["ctx.ergs", "ctx.sp", "ctx.this", "ctx.meta"])
                + f" r{rng.randrange(1, 9)}")
        elif kind == 10:
            lines.append("nop")
        elif kind == 11:
            off = rng.randrange(0, 40)
            lines.append(f"st.ah {off}, {r()}")
            lines.append(f"ld.ah {off}, r{rng.randrange(1, 9)}")
        elif kind == 12:
            key = rng.randrange(1, 8)
            lines.append(f"add {key}, r0, r9")
            lines.append(f"log.swrite r9, {r()}")
            lines.append(f"log.sread r9, r{rng.randrange(1, 9)}")
        else:
            lines.append(f"log.event {r()}, {r()}")
    lines.append("ret r0")
    return "\n".join(lines)


def random_far_call_scenario(seed: int):
    """Random callee contracts + random callers exercising the call
    protocol: (callers, [(address, contract source)])."""
    rng = random.Random(seed)
    addrs = [0x20000 + 0x111 * i for i in range(2)]
    contracts = []
    for address in addrs:
        body = [ln for ln in random_program(rng).splitlines()[:-1][:10]
                if "near_call" not in ln]
        exit_kind = rng.randrange(3)
        if exit_kind == 0:
            tail = ["ld.ptr r1, r5", "add 1, r0, r6", "add r5, r6, r5",
                    "st.h 0, r5", "add code[@rabi], r0, r7", "ret r7",
                    f"rabi: .word {ret_abi(0, 32)}"]
        elif exit_kind == 1:
            tail = ["add 7, r0, r5", "st.h 0, r5",
                    "add code[@rabi], r0, r7", "revert r7",
                    f"rabi: .word {ret_abi(0, 32)}"]
        else:
            tail = ["ret r0"]
        contracts.append((address, "\n".join(body + tail)))

    callers = []
    for _ in range(6):
        target = rng.choice(addrs)
        ergs_mode = rng.choice([PASS_ALL, 0, rng.randrange(500, 5000)])
        pre = [ln for ln in random_program(rng).splitlines()[:-1][:6]
               if "near_call" not in ln]
        callers.append("\n".join(pre + [
            f"add {rng.randrange(1, 1000)}, r0, r3",
            "st.h 0, r3",
            "add code[@abi], r0, r4",
            "add code[@dest], r0, r2",
            "far_call r4, r2, @on_fail",
            "ld.ptr r1, r10",
            "add 1, r0, r11",
            "ret r0",
            "on_fail:",
            "add 99, r0, r9",
            "ret r0",
            f"abi: .word {fc_abi(ergs=ergs_mode, length=32)}",
            f"dest: .word {target}",
        ]))
    return callers, contracts


def campaign(name: str, batch: int | None = None):
    """One campaign of the fuzz file: (config, programs, bank, storage
    entries).  "random": 48 random programs; "far_call": the callers of the
    two scenarios, with the contracts as the code bank [(hash, words)] and
    their deployer entries [(deployer, address, hash)] in every lane.  A
    `batch` cycles the programs over that many lanes."""
    if name == "random":
        rng = random.Random(PROGRAM_SEED)
        sources = [random_program(rng) for _ in range(48)]
        contracts = []
    else:
        sources, contracts = [], None
        for seed in FAR_CALL_SEEDS:
            c, contracts = random_far_call_scenario(seed)
            sources.extend(c)
    words = [assemble_to_code_words(p) for p in sources]
    bank, entries = [], []
    for address, src in contracts:
        c_words = assemble_to_code_words(src)
        h = code_hash_for_bytecode(c_words)
        bank.append((h, c_words))
        entries.append((params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, address, h))
    if batch is not None:
        words = [words[i % len(words)] for i in range(batch)]
    extra = (dict(heap_frames=4, code_pages=4,
                  decommit_queue_capacity=MAX_CYCLES)
             if name == "far_call" else {})
    config = VmConfig(batch=len(words), queue_capacity=MAX_CYCLES * 8,
                      heap_words=64, stack_words=2048, code_words=64,
                      max_depth=8, storage_slots=16, journal_slots=64,
                      event_slots=64, log_queue_capacity=MAX_CYCLES, **extra)
    return config, words, bank, entries


def entry_state(name: str, batch: int | None = None,
                device=DEFAULT_DEVICE):
    """(config, the campaign's entry state on `device`): every lane with the
    campaign's storage entries and code bank."""
    config, words, bank, entries = campaign(name, batch)
    st = make_entry_state(config, words, ergs=ERGS, device=device)
    if bank:
        B = config.batch
        populate_storage(st, config,
                         [[(0, a, k, v) for a, k, v in entries]] * B)
        populate_code_bank(st, config, [list(bank)] * B)
    return config, st
