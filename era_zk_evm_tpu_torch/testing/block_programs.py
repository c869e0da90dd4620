"""The programs and transaction blocks the block pipeline is driven with.

Copies, each held equal to its source by `tests/test_torch_block.py`,
`tests/test_torch_scheduler.py` or `tests/test_torch_precompile.py`:

  * `realistic_program(iters)`: `bench.py:601-626` (`bench_block`'s
    `prog_real`); the tiny-mix `prog` is `programs.tiny_mix_program`;
  * `tiny_mix_lengths` / `realistic_lengths`: `bench_block`'s length draws
    (`bench.py:628-650`);
  * `scheduler_program(n_iters)` and `SCHEDULER_LENGTHS`:
    `tests/test_scheduler.py:21-48`;
  * `TX_STORAGE`, `TX_ROLLBACK`, `CALLEE`, `TX_FARCALL`, `TX_ALU` and
    `block_txs()`: the six transactions of `tests/test_block.py:29-110`;
  * `keccak_abi` / `sha_abi`: `tests/test_batched_precompiles.py:23-36`;
  * `KECCAK_PROGRAMS`, `SHA_PROGRAM`, `OUT_OF_ERGS_PROGRAM`,
    `ROUND_WITNESS_PROGRAMS`, `FUSED_KECCAK_PROGRAMS`, `FUSED_SHA_PROGRAM`
    and `PQ_CLOCK_PROGRAM`: the precompile programs of
    `tests/test_batched_precompiles.py` and `tests/test_fused_cycle.py:360-440,
    741-752`, with `PRECOMPILE_LANES`, their entry addresses.

`precompile_mix` is the port's own: a block of mapping-slot writes, three
transactions in four hashing their slot key with keccak256 (the way a
Solidity mapping write does), the rest running sha256 rounds.
"""

from __future__ import annotations

import numpy as np

from ..isa import params
from ..isa.abi import PrecompileCallABI, code_hash_for_bytecode
from ..isa.assembler import assemble_to_code_words

TINY_LENGTHS = ([4, 8, 16, 32], [0.5, 0.25, 0.15, 0.1])


def realistic_program(iters: int) -> str:
    """bench_block's realistic tx: a bounded storage / event prologue, then
    a compute and memory body of `iters` iterations."""
    return f"""
            add 1, r0, r10
            add 16, r0, r1
            sloop:
            log.swrite r10, r1
            log.event r1, r1
            sub! r1, r10, r1
            jump.if_ne @sloop
            add code[@n], r0, r1
            add 0, r0, r2
            loop:
            add r2, r1, r2
            xor r2, r1, r3
            add r3, r0, stack+=[1]
            add stack-=[1], r0, r4
            st.h 0, r4
            sub! r1, r10, r1
            jump.if_ne @loop
            ret r0
            n: .word {iters}
        """


def tiny_mix_lengths(n_txs: int, seed: int = 11) -> np.ndarray:
    """bench_block's tiny-mix iteration counts."""
    return np.random.RandomState(seed).choice(TINY_LENGTHS[0], size=n_txs,
                                              p=TINY_LENGTHS[1])


def realistic_lengths(n_txs: int, seed: int = 11) -> np.ndarray:
    """bench_block's realistic-mix iteration counts: lognormal, clipped to
    [100, 6000], bucketed to 32 distinct programs."""
    rng = np.random.RandomState(seed)
    lengths = np.clip(rng.lognormal(mean=5.5, sigma=1.0, size=n_txs),
                      100, 6000).astype(np.int64)
    buckets = np.unique(np.clip(
        np.exp(np.linspace(np.log(100), np.log(6000), 32)), 100,
        6000).astype(np.int64))
    return buckets[np.searchsorted(buckets, lengths,
                                   side="left").clip(0, len(buckets) - 1)]


def scheduler_program(n_iters: int) -> str:
    """tests/test_scheduler.py's tx: ~6 cycles per iteration."""
    return f"""
        add 1, r0, r10
        add code[@n], r0, r1
        add 0, r0, r2
        loop:
        add r2, r1, r2
        add r2, r0, stack+=[1]
        add stack-=[1], r0, r3
        st.h 0, r3
        sub! r1, r10, r1
        jump.if_ne @loop
        ret r0
        n: .word {n_iters}
    """


SCHEDULER_LENGTHS = [1, 7, 2, 11, 3, 1, 9, 4, 2, 6]

# tests/test_block.py's transactions
TX_STORAGE = """
    add code[@p], r0, r1
    log.swrite r1, r1
    add 7, r1, r2
    log.swrite r2, r2
    log.sread r1, r3
    log.event r3, r1
    ret r0
    p: .word {val}
"""

TX_ROLLBACK = """
    add 100, r0, r1
    log.event r1, r1
    near_call r9, @sub, @handler
    handler:
    add 2, r0, r8
    log.to_l1 r8, r1
    ret r0
    sub:
    add 200, r0, r2
    log.event r2, r2
    log.swrite r2, r2
    panic
"""

CALLEE = """
    add 3, r0, r1
    log.swrite r1, r1
    ret r0
"""

TX_FARCALL = f"""
    add 1, r0, r1
    log.swrite r1, r1
    add code[@abi], r0, r4
    add code[@dest], r0, r2
    far_call r4, r2, @fail
    add 1, r0, r8
    ret r0
    fail:
    panic
    abi: .word {0xFFFFFFFF << 192}
    dest: .word 0x10042
"""

TX_ALU = """
    add 1, r0, r10
    add code[@n], r0, r1
    add 0, r0, r2
    loop:
    add r2, r1, r2
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
    n: .word {iters}
"""

BLOCK_ERGS = 1 << 22


def block_txs() -> list:
    """The six transactions of tests/test_block.py: storage and events, a
    rolled-back frame, a far call with its callee staged, arithmetic."""
    from ..models.scheduler import TxSpec

    callee_words = assemble_to_code_words(CALLEE)
    h = code_hash_for_bytecode(callee_words)
    dep = [(0, params.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, 0x10042, h)]
    return [
        TxSpec(program=assemble_to_code_words(TX_STORAGE.format(val=11)),
               ergs=BLOCK_ERGS),
        TxSpec(program=assemble_to_code_words(TX_ROLLBACK), ergs=BLOCK_ERGS),
        TxSpec(program=assemble_to_code_words(TX_FARCALL), ergs=BLOCK_ERGS,
               storage=tuple(dep), contracts=((h, tuple(callee_words)),)),
        TxSpec(program=assemble_to_code_words(TX_ALU.format(iters=9)),
               ergs=BLOCK_ERGS),
        TxSpec(program=assemble_to_code_words(
            TX_STORAGE.format(val=0xBEEF)), ergs=BLOCK_ERGS),
        TxSpec(program=assemble_to_code_words(TX_ALU.format(iters=2)),
               ergs=BLOCK_ERGS),
    ]


def keccak_abi(offset, length, out_word):
    return PrecompileCallABI(
        input_memory_offset=offset, input_memory_length=length,
        output_memory_offset=out_word, output_memory_length=0,
        memory_page_to_read=0, memory_page_to_write=0,
        precompile_interpreted_data=0).to_u256()


def sha_abi(in_word, rounds, out_word):
    return PrecompileCallABI(
        input_memory_offset=in_word, input_memory_length=2 * rounds,
        output_memory_offset=out_word, output_memory_length=1,
        memory_page_to_read=0, memory_page_to_write=0,
        precompile_interpreted_data=rounds).to_u256()


_DATA4 = (0x61626364).to_bytes(4, "big")
_ABC = b"abc" + b"\x80" + b"\x00" * 52 + (24).to_bytes(8, "big")

# tests/test_batched_precompiles.py::test_keccak_cases
KECCAK_PROGRAMS = [
    f"""
            add code[@d], r0, r2
            st.h 0, r2
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add 64, r0, r6
            ld.h r6, r7
            ret r0
            abi: .word {keccak_abi(0, 4, 2)}
            d: .word {int.from_bytes(_DATA4 + bytes(28), 'big')}
            """,
    f"""
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            ld.h 0, r7
            ret r0
            abi: .word {keccak_abi(0, 0, 0)}
            """,
    f"""
            add code[@w0], r0, r2
            st.h 0, r2
            add code[@w1], r0, r3
            st.h 32, r3
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add 96, r0, r6
            ld.h r6, r7
            ret r0
            abi: .word {keccak_abi(0, 64, 3)}
            w0: .word {int.from_bytes(bytes(range(32)), 'big')}
            w1: .word {int.from_bytes(bytes(range(32, 64)), 'big')}
            """,
    f"""
            add code[@w0], r0, r2
            st.h 0, r2
            add code[@w1], r0, r3
            st.h 32, r3
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add 96, r0, r6
            ld.h r6, r7
            ret r0
            abi: .word {keccak_abi(3, 40, 3)}
            w0: .word {int.from_bytes(bytes(range(32)), 'big')}
            w1: .word {int.from_bytes(bytes(range(32, 64)), 'big')}
            """,
    f"""
            add code[@fill], r0, r2
            st.h 0, r2
            st.h 32, r2
            st.h 64, r2
            st.h 96, r2
            st.h 128, r2
            st.h 160, r2
            st.h 192, r2
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add code[@outw], r0, r6
            ld.h r6, r7
            ret r0
            abi: .word {keccak_abi(0, 200, 8)}
            fill: .word {int.from_bytes(bytes([0x7B] * 32), 'big')}
            outw: .word 256
            """,
]

# tests/test_fused_cycle.py::TestFusedPrecompiles::test_keccak_cases
FUSED_KECCAK_PROGRAMS = [
    f"""
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            ld.h 0, r7
            ret r0
            abi: .word {keccak_abi(0, 0, 0)}
            """,
    f"""
            add code[@w0], r0, r2
            st.h 0, r2
            add code[@w1], r0, r3
            st.h 32, r3
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add 96, r0, r6
            ld.h r6, r7
            ret r0
            abi: .word {keccak_abi(3, 40, 3)}
            w0: .word {int.from_bytes(bytes(range(32)), 'big')}
            w1: .word {int.from_bytes(bytes(range(32, 64)), 'big')}
            """,
    f"""
            add code[@fill], r0, r2
            st.h 0, r2
            st.h 32, r2
            st.h 64, r2
            st.h 96, r2
            st.h 128, r2
            st.h 160, r2
            st.h 192, r2
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            ret r0
            abi: .word {keccak_abi(0, 200, 8)}
            fill: .word {int.from_bytes(bytes([0x7B] * 32), 'big')}
            """,
]

# tests/test_fused_cycle.py::TestFusedPrecompiles::test_sha256_rounds
FUSED_SHA_PROGRAM = f"""
        add code[@w0], r0, r2
        st.h 0, r2
        add code[@w1], r0, r3
        st.h 32, r3
        add code[@abi], r0, r4
        log.precompile r4, r0, r5
        add 96, r0, r6
        ld.h r6, r7
        ret r0
        abi: .word {sha_abi(0, 1, 3)}
        w0: .word {int.from_bytes(_ABC[:32], 'big')}
        w1: .word {int.from_bytes(_ABC[32:], 'big')}
        """

# tests/test_batched_precompiles.py::test_sha256_rounds ("abc", one round)
SHA_PROGRAM = f"""
            add code[@w0], r0, r2
            st.h 0, r2
            add code[@w1], r0, r3
            st.h 32, r3
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add 64, r0, r6
            ld.h r6, r7
            ret r0
            abi: .word {sha_abi(0, 1, 2)}
            w0: .word {int.from_bytes(_ABC[:32], 'big')}
            w1: .word {int.from_bytes(_ABC[32:], 'big')}
            """

# tests/test_batched_precompiles.py::test_precompile_extra_cost_out_of_ergs
OUT_OF_ERGS_PROGRAM = f"""
            add 3000, r0, r9
            near_call r9, @w, @h
            done:
            ret r0
            w:
            add code[@abi], r0, r4
            add 60000, r0, r6      ; extra cost > passed ergs
            log.precompile r4, r6, r5
            add r5, r0, stack[7]   ; store result flag (0)
            ret r0
            h:
            add 1, r0, r8
            jump @done
            abi: .word {keccak_abi(0, 0, 0)}
            """

# tests/test_batched_precompiles.py::test_keccak_and_sha_round_witness
ROUND_WITNESS_PROGRAMS = [
    f"""
            add code[@w0], r0, r2
            st.h 0, r2
            add code[@w1], r0, r3
            st.h 32, r3
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add code[@abi2], r0, r6
            log.precompile r6, r0, r7
            ret r0
            abi: .word {keccak_abi(3, 40, 3)}
            abi2: .word {keccak_abi(0, 0, 5)}
            w0: .word {int.from_bytes(bytes(range(32)), 'big')}
            w1: .word {int.from_bytes(bytes(range(32, 64)), 'big')}
            """,
    f"""
            add code[@d], r0, r2
            st.h 0, r2
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            ret r0
            abi: .word {keccak_abi(0, 4, 2)}
            d: .word {int.from_bytes(_DATA4 + bytes(28), 'big')}
            """,
    f"""
            add code[@w0], r0, r2
            st.h 0, r2
            add code[@w1], r0, r3
            st.h 32, r3
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            ret r0
            abi: .word {sha_abi(0, 1, 2)}
            w0: .word {int.from_bytes(_ABC[:32], 'big')}
            w1: .word {int.from_bytes(_ABC[32:], 'big')}
            """,
]


def _pq_abi(o, length, out):
    return PrecompileCallABI(o, length, out, 0, 0, 0, 0).to_u256()


# tests/test_fused_cycle.py::test_pq_streams_and_clock: two keccak calls
PQ_CLOCK_PROGRAM = f"""
        add code[@w0], r0, r2
        st.h 0, r2
        add code[@abi], r0, r4
        log.precompile r4, r0, r5
        add code[@abi2], r0, r4
        log.precompile r4, r0, r5
        ret r0
        abi: .word {_pq_abi(3, 24, 3)}
        abi2: .word {_pq_abi(0, 17, 5)}
        w0: .word {int.from_bytes(bytes(range(64, 96)), 'big')}
        """


def unaligned_program(abi: int, seed: int = 14) -> str:
    """Nine distinct heap words (random bytes from `seed`), then one
    precompile call with `abi`, its output word (word 12) read back."""
    fill = np.random.RandomState(seed).randint(0, 256, 9 * 32,
                                               dtype=np.uint8).tobytes()
    stores = "".join(f"""
            add code[@w{i}], r0, r2
            st.h {32 * i}, r2""" for i in range(9))
    words = "".join(f"""
            w{i}: .word {int.from_bytes(fill[32 * i:32 * i + 32], 'big')}"""
                    for i in range(9))
    return f"""{stores}
            add code[@abi], r0, r4
            log.precompile r4, r0, r5
            add {32 * 12}, r0, r6
            ld.h r6, r7
            ret r0
            abi: .word {abi}{words}
            """


def keccak_mapping_program(iters: int) -> str:
    """`iters` mapping-slot writes: store the key (iteration & 3) and the
    slot number, keccak256 the 64 bytes, load the hash, write storage under
    it and read it back.  Runs as the keccak256 precompile's address."""
    return f"""
        add 1, r0, r10
        add code[@n], r0, r1
        add code[@abi], r0, r4
        loop:
        and 3, r1, r3
        st.h 0, r3
        st.h 32, r10
        log.precompile r4, r0, r5
        ld.h 64, r6
        log.swrite r6, r1
        log.sread r6, r7
        sub! r1, r10, r1
        jump.if_ne @loop
        ret r0
        abi: .word {keccak_abi(0, 64, 2)}
        n: .word {iters}
    """


def sha_rounds_program(iters: int, rounds: int) -> str:
    """`iters` iterations of `rounds` sha256 rounds over the heap's first
    2 * rounds words (the iteration count in word 1), the state written to
    word 4 and stored.  Runs as the sha256 precompile's address."""
    return f"""
        add 1, r0, r10
        add code[@n], r0, r1
        add code[@abi], r0, r4
        loop:
        st.h 32, r1
        log.precompile r4, r0, r5
        ld.h 128, r6
        log.swrite r10, r6
        sub! r1, r10, r1
        jump.if_ne @loop
        ret r0
        abi: .word {sha_abi(0, rounds, 4)}
        n: .word {iters}
    """


def precompile_mix(n_txs: int, seed: int = 11) -> list[tuple]:
    """The precompile mix: per tx (entry address, program source, iteration
    count, sha256 rounds per call or 0).  Iteration counts are the tiny
    mix's draw; one tx in four (a second draw from the same generator) runs
    sha256 with 1 or 2 rounds per iteration, the rest keccak256 mapping
    writes."""
    rng = np.random.RandomState(seed)
    lengths = rng.choice(TINY_LENGTHS[0], size=n_txs, p=TINY_LENGTHS[1])
    sha = rng.random_sample(n_txs) < 0.25
    rounds = rng.randint(1, 3, size=n_txs)
    out = []
    for n, is_sha, r in zip(lengths.tolist(), sha.tolist(), rounds.tolist()):
        if is_sha:
            out.append((params.SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS,
                        sha_rounds_program(n, r), n, r))
        else:
            out.append((params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS,
                        keccak_mapping_program(n), n, 0))
    return out


_KECCAK = params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS
_SHA = params.SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS

#: every precompile test program with its entry address
PRECOMPILE_LANES = (
    [(_KECCAK, p) for p in KECCAK_PROGRAMS + FUSED_KECCAK_PROGRAMS]
    + [(_SHA, SHA_PROGRAM), (_SHA, FUSED_SHA_PROGRAM),
       (_KECCAK, OUT_OF_ERGS_PROGRAM)]
    + [(_KECCAK, p) for p in ROUND_WITNESS_PROGRAMS]
    + [(_KECCAK, PQ_CLOCK_PROGRAM)])

#: inputs the mix never has: two-block keccak256 calls at unaligned offsets,
#: one of them past two blocks (lane_error with the units' limit of 2), a
#: short one across a word boundary and sha256 at an odd word
UNALIGNED_LANES = (
    [(_KECCAK, unaligned_program(keccak_abi(o, n, 12)))
     for o, n in ((1, 137), (7, 200), (31, 271), (3, 272), (29, 40))]
    + [(_SHA, unaligned_program(sha_abi(3, 2, 12)))])
