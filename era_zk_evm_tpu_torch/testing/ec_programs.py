"""The ecrecover programs: the JAX tests' programs, edge cases, and a block.

Copies, each held equal to its source by `tests/test_torch_ecrecover.py`:

  * `VIA_VM_PROGRAM`: `tests/test_batched_precompiles.py:190-235`, a
    recovery whose ok word and address are loaded back;
  * `ROUND_WITNESS_PROGRAM`: `tests/test_batched_precompiles.py:298-343`;
  * `MID_CHUNK_PROGRAM`: `tests/test_fused_cycle.py:469-524`, two recoveries
    around a third `log.precompile` (which, the lane being the ecrecover
    contract, recovers again), placed mid-chunk by 8-cycle chunks;
    each with its vector construction.

The port's own: `EDGE_PROGRAMS`, one recovery each at the same cycle as the
copies (so the plain version runs once for all of them): r = 0, s = 0,
r = n, s = n, an r whose x^3 + 7 is no square, digest = 0, digest >= n,
v from a word larger than 1, s = n - 1, a signature whose recovered point
is at infinity, an output window whose second word passes the frame
(`hw_ok` fails on it alone), and a call short of ergs.  `EC_LANES` is every
program with its entry address.  `ecrecover_mix` is a block of signed
transfers (see there).  The output window case assumes 64 heap words, the
geometry of `tests/test_batched_precompiles.py::_config`.
"""

from __future__ import annotations

import random

from ..isa import params
from ..isa.abi import PrecompileCallABI
from ..ops.keccak import keccak256
from ..ops.secp256k1 import (
    GX_INT, GY_INT, N_INT, P_INT, address_of, ec_mul, sign,
)
from .block_programs import tiny_mix_lengths

EC = params.ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS
HEAP_WORDS = 64


def ec_abi(out_word: int = 4) -> int:
    return PrecompileCallABI(
        input_memory_offset=0, input_memory_length=4,
        output_memory_offset=out_word, output_memory_length=2,
        memory_page_to_read=0, memory_page_to_write=0,
        precompile_interpreted_data=0).to_u256()


_D = 0xC0FFEE0DDF00DC0FFEE0DDF00DC0FFEE0DDF00DC0FFEE0DDF00DC0FFEE0DD01
_K = 0x8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D8BADF00D


def _vector(msg: bytes, d: int = _D, k: int = _K) -> tuple:
    """(digest, v, r, s) of keccak256(msg) under key d, nonce k."""
    digest = int.from_bytes(keccak256(msg), "big")
    return (digest,) + sign(d, digest, k)


# tests/test_batched_precompiles.py::TestDeviceEcrecover::test_ecrecover_via_vm
_DG, _V, _R, _S = _vector(b"device recovery")
VIA_VM_PROGRAM = f"""
            add code[@dg], r0, r2
            st.h 0, r2
            add {_V}, r0, r3
            st.h 32, r3
            add code[@sr], r0, r4
            st.h 64, r4
            add code[@ss], r0, r5
            st.h 96, r5
            add code[@abi], r0, r6
            log.precompile r6, r0, r7
            add 128, r0, r8
            ld.h r8, r9
            add 160, r0, r10
            ld.h r10, r11
            ret r0
            abi: .word {ec_abi()}
            dg: .word {_DG}
            sr: .word {_R}
            ss: .word {_S}
        """

# tests/test_batched_precompiles.py::TestPrecompileRoundWitness::
# test_ecrecover_round_witness
_DG, _V, _R, _S = _vector(b"round witness")
ROUND_WITNESS_PROGRAM = f"""
            add code[@dg], r0, r2
            st.h 0, r2
            add {_V}, r0, r3
            st.h 32, r3
            add code[@sr], r0, r4
            st.h 64, r4
            add code[@ss], r0, r5
            st.h 96, r5
            add code[@abi], r0, r6
            log.precompile r6, r0, r7
            ret r0
            abi: .word {ec_abi()}
            dg: .word {_DG}
            sr: .word {_R}
            ss: .word {_S}
        """


# tests/test_fused_cycle.py::TestFusedEcrecover::test_ecrecover_detour_mid_chunk
def _ec_call(dg, v, r, s, tag):
    return f"""
            add code[@dg{tag}], r0, r2
            st.h 0, r2
            add {v}, r0, r3
            st.h 32, r3
            add code[@sr{tag}], r0, r4
            st.h 64, r4
            add code[@ss{tag}], r0, r5
            st.h 96, r5
            add code[@ecabi], r0, r6
            log.precompile r6, r0, r7
            add 128, r0, r8
            ld.h r8, r9
            add 160, r0, r10
            ld.h r10, r11
            """


_DG1, _V1, _R1, _S1 = _vector(b"fused detour 1")
_DG2, _V2, _R2, _S2 = _vector(b"fused detour 2", k=_K + 7)
_KC_ABI = PrecompileCallABI(
    input_memory_offset=0, input_memory_length=16,
    output_memory_offset=7, output_memory_length=1,
    memory_page_to_read=0, memory_page_to_write=0,
    precompile_interpreted_data=0).to_u256()
MID_CHUNK_PROGRAM = f"""
            add 1, r0, r14
            {_ec_call(_DG1, _V1, _R1, _S1, '1')}
            add r9, r11, r12
            add code[@kcabi], r0, r6
            log.precompile r6, r0, r7
            ld.h 224, r13
            {_ec_call(_DG2, _V2, _R2, _S2, '2')}
            add r9, r12, r12
            ret r0
            ecabi: .word {ec_abi()}
            kcabi: .word {_KC_ABI}
            dg1: .word {_DG1}
            sr1: .word {_R1}
            ss1: .word {_S1}
            dg2: .word {_DG2}
            sr2: .word {_R2}
            ss2: .word {_S2}
        """


def edge_program(digest: int, v_word: int, r: int, s: int,
                 out_word: int = 4, load: bool = True) -> str:
    """One recovery of (digest, v_word, r, s) at cycle 9, its two output
    words loaded back into r9 and r11 when `load`."""
    loads = """
            add 128, r0, r8
            ld.h r8, r9
            add 160, r0, r10
            ld.h r10, r11""" if load else ""
    return f"""
            add code[@dg], r0, r2
            st.h 0, r2
            add code[@vw], r0, r3
            st.h 32, r3
            add code[@sr], r0, r4
            st.h 64, r4
            add code[@ss], r0, r5
            st.h 96, r5
            add code[@abi], r0, r6
            log.precompile r6, r0, r7{loads}
            ret r0
            abi: .word {ec_abi(out_word)}
            dg: .word {digest}
            vw: .word {v_word}
            sr: .word {r}
            ss: .word {s}
        """


def _non_square_x() -> int:
    """The least x for which x^3 + 7 is no square mod p."""
    x = 1
    while pow((x ** 3 + 7) % P_INT, (P_INT - 1) // 2, P_INT) == 1:
        x += 1
    return x


def _infinity_vector() -> tuple:
    """A signature whose recovered point is at infinity: r = x(kG), and the
    digest e = s k, so that s R = e G."""
    k, s = 0x1234567, 0xABCDEF
    Rx, Ry = ec_mul(k, (GX_INT, GY_INT))
    return s * k % N_INT, Ry & 1, Rx % N_INT, s


def _high_s_vector() -> tuple:
    """A valid signature with s = n - 1 (no low-s normalisation)."""
    Rx, Ry = ec_mul(_K, (GX_INT, GY_INT))
    r, s = Rx % N_INT, N_INT - 1
    return (s * _K - r * _D) % N_INT, Ry & 1, r, s


def _edge_cases() -> dict:
    dg, v, r, s = _vector(b"edge cases")
    e_small = 12345
    v_small, r_small, s_small = sign(_D, e_small, _K)
    v0, r0, s0 = sign(_D, 0, _K + 1)
    cases = {
        "r_zero": (dg, v, 0, s),
        "s_zero": (dg, v, r, 0),
        "r_is_n": (dg, v, N_INT, s),
        "s_is_n": (dg, v, r, N_INT),
        "r_not_on_curve": (dg, v, _non_square_x(), s),
        "digest_zero": (0, v0, r0, s0),
        "digest_above_n": (N_INT + e_small, v_small, r_small, s_small),
        "v_word_above_1": (dg, (1 << 255) | 2 | v, r, s),
        "s_is_n_minus_1": _high_s_vector(),
        "q_at_infinity": _infinity_vector(),
    }
    programs = {name: edge_program(*c) for name, c in cases.items()}
    programs["output_passes_frame"] = edge_program(
        dg, v, r, s, out_word=HEAP_WORDS - 1, load=False)
    return cases, programs


EDGE_CASES, EDGE_PROGRAMS = _edge_cases()


def crafted_signatures() -> list[tuple]:
    """(digest, v, r, s) signatures that reach the edges of the recovery:
    the edge cases above (v from its word's low bit), R = G and R = -G,
    their sums at infinity (u1 G = -u2 R), u1 = 0 (digest 0 or n), r = n - 1,
    r or s outside [1, n) and v > 1."""
    out = [(dg, vw & 1, r, s) for dg, vw, r, s in EDGE_CASES.values()]
    g_par, e = GY_INT & 1, 0x1234567
    out += [
        (e, g_par, GX_INT, 0xABCDEF),          # R = G
        (e, 1 - g_par, GX_INT, 0xABCDEF),      # R = -G
        (e, g_par, GX_INT, e),                 # R = G, u1 = -u2: infinity
        (N_INT - e, 1 - g_par, GX_INT, e),     # R = -G, u1 = u2: infinity
        (N_INT - e, g_par, GX_INT, e),         # R = G, u1 = u2: 2 u1 G
        (0, g_par, GX_INT, 5), (N_INT, 1, GX_INT, 7),   # u1 = 0
        (7, 0, N_INT - 1, N_INT - 1), (7, 1, N_INT - 1, 3),
        (1, 0, N_INT + 5, 1), (1, 0, 5, N_INT + 1), (2**256 - 1, 1, 3, 3),
        (5, 2, 7, 9), (5, 3, GX_INT, 9),
    ]
    return out
EDGE_CASES["output_passes_frame"] = _vector(b"edge cases")

# a recovery short of ergs: the near call passes 3000 ergs, the call costs
# more, so no unit runs and dst0 reads 0 (the keccak out-of-ergs program of
# tests/test_batched_precompiles.py with the ecrecover call's ABI)
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
            abi: .word {ec_abi()}
            """

#: every ecrecover test program; each lane is the ecrecover contract
EC_LANES = [(EC, p) for p in (VIA_VM_PROGRAM, ROUND_WITNESS_PROGRAM,
                              MID_CHUNK_PROGRAM, OUT_OF_ERGS_PROGRAM)] \
    + [(EC, p) for p in EDGE_PROGRAMS.values()]


def ecrecover_vectors(n: int, seed: int = 11) -> list[tuple]:
    """n signed vectors (digest, v, r, s, signer address), keys, nonces and
    digests drawn from `seed`."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        d = rng.randrange(1, N_INT)
        digest = rng.getrandbits(256)
        out.append((digest,) + sign(d, digest, rng.randrange(1, N_INT))
                   + (address_of(d),))
    return out


def ecrecover_tx_program(digest: int, v: int, r: int, s: int, signer: int,
                         iters: int) -> str:
    """A signed transfer: recover the signer of (digest, v, r, s), compare
    it with the expected address (`sub!` and a branch), write the sender's
    nonce slot and read it back, then the tiny mix's body for `iters`
    iterations; a signer that differs logs an event and ends the tx."""
    return f"""
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
        ld.h 160, r8
        add code[@signer], r0, r9
        sub! r8, r9, r13
        jump.if_ne @reject
        add 1, r0, r10
        log.swrite r9, r10
        log.sread r9, r11
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
        reject:
        log.event r8, r9
        ret r0
        abi: .word {ec_abi()}
        dg: .word {digest}
        sr: .word {r}
        ss: .word {s}
        signer: .word {signer}
        n: .word {iters}
    """


POOL = 512     # distinct signed vectors a block cycles through


def ecrecover_mix(n_txs: int, seed: int = 11) -> list[tuple]:
    """A block of signed transfers: per tx (entry address, program source,
    iteration count, whether its s is corrupted, the (digest, v, r, s) it
    recovers).  Iteration counts are the tiny mix's draw (`RandomState(seed)`,
    `TINY_LENGTHS`); the signatures cycle through min(n_txs, POOL) vectors
    of `ecrecover_vectors`; one tx in 16 carries s + 1, so it recovers
    another address and takes the reject branch."""
    vectors = ecrecover_vectors(min(n_txs, POOL), seed)
    out = []
    for i, n in enumerate(tiny_mix_lengths(n_txs, seed).tolist()):
        digest, v, r, s, signer = vectors[i % len(vectors)]
        bad = i % 16 == 15
        out.append((EC, ecrecover_tx_program(digest, v, r, s + bad, signer, n),
                    n, bad, (digest, v, r, s + bad)))
    return out
