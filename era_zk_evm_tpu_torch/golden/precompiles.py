"""Golden precompiles processor: keccak256, sha256, ecrecover.

Capability surface of `zk_evm_abstractions::DefaultPrecompilesProcessor`
(SURVEY.md §2.10): each precompile is a memory-to-memory round function driven
by a `PrecompileCallABI` packed in the log query's key.  Reads happen at the
query timestamp (ts+1 of the calling cycle), writes at timestamp+1 (ts+2),
matching the cycle's timestamp discipline (vm_state/mod.rs:220-231).

The primitive implementations (keccak-f[1600] permutation, SHA-256
compression, secp256k1 recovery) are written from the public specifications —
they double as the scalar reference for the batched JAX/Pallas kernels in
``era_zk_evm_tpu.ops``.

ABI interpretation per precompile ([E]-grade pins, kept consistent between
this golden model, the TPU kernels and the tests):
  * keccak256: input offset/length in BYTES, output offset in WORDS; evidenced
    by the reference's own test (testing/tests/precompiles/keccak256.rs:98-111
    passes byte offsets/lengths and a word output offset).
  * sha256: `precompile_interpreted_data` = number of 64-byte rounds; input
    offset in words (2 words per round); output state written as 1 word.
  * ecrecover: 4 input words (digest, v, r, s), 2 output words
    (success marker, recovered address).
"""

from __future__ import annotations

import dataclasses

from ..isa.abi import PrecompileCallABI
from ..isa import params
from .memory import GoldenMemory
from .queries import LogQuery, MemoryQuery, MemoryType

U64 = (1 << 64) - 1
U256_MASK = (1 << 256) - 1

# ---------------------------------------------------------------------------
# Keccak-f[1600]
# ---------------------------------------------------------------------------

KECCAK_ROUNDS = 24
KECCAK_RATE_BYTES = 136  # keccak256: rate 1088 bits

#: iota round constants (FIPS 202 / original Keccak spec)
KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

#: rho rotation offsets, flat index x + 5*y
KECCAK_ROTATIONS = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl64(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & U64 if n else v


def keccak_f1600(state: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation over 25 u64 lanes (flat x + 5y)."""
    a = list(state)
    for rnd in range(KECCAK_ROUNDS):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [(a[i] ^ d[i % 5]) for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    a[x + 5 * y], KECCAK_ROTATIONS[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & U64)
                    & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        a[0] ^= KECCAK_RC[rnd]
    return a


def keccak256(data: bytes) -> bytes:
    """keccak256 with original 0x01 multi-rate padding (NOT sha3-256)."""
    state = [0] * 25
    padded = bytearray(data)
    pad_len = KECCAK_RATE_BYTES - (len(data) % KECCAK_RATE_BYTES)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 \
        else b"\x81"
    for block_start in range(0, len(padded), KECCAK_RATE_BYTES):
        block = padded[block_start:block_start + KECCAK_RATE_BYTES]
        for i in range(KECCAK_RATE_BYTES // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f1600(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


# ---------------------------------------------------------------------------
# SHA-256 compression
# ---------------------------------------------------------------------------

SHA256_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
SHA256_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
_M32 = (1 << 32) - 1


def _rotr32(v: int, n: int) -> int:
    return ((v >> n) | (v << (32 - n))) & _M32


def sha256_compress(state: list[int], block: bytes) -> list[int]:
    """One SHA-256 compression round over a 64-byte block."""
    w = [int.from_bytes(block[4 * i:4 * i + 4], "big") for i in range(16)]
    for i in range(16, 64):
        s0 = _rotr32(w[i - 15], 7) ^ _rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr32(w[i - 2], 17) ^ _rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + SHA256_K[i] + w[i]) & _M32
        s0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(state, [a, b, c, d, e, f, g, h])]


# ---------------------------------------------------------------------------
# secp256k1 ecrecover
# ---------------------------------------------------------------------------

SECP_P = 2**256 - 2**32 - 977
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
SECP_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


def _ec_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % SECP_P == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * _inv_mod(2 * y1, SECP_P) % SECP_P
    else:
        lam = (y2 - y1) * _inv_mod(x2 - x1, SECP_P) % SECP_P
    x3 = (lam * lam - x1 - x2) % SECP_P
    y3 = (lam * (x1 - x3) - y1) % SECP_P
    return (x3, y3)


def _ec_mul(k: int, point):
    result = None
    addend = point
    while k:
        if k & 1:
            result = _ec_add(result, addend)
        addend = _ec_add(addend, addend)
        k >>= 1
    return result


def ecrecover_inner(digest: int, v: int, r: int, s: int) -> int | None:
    """Recover the Ethereum address (as int) or None on failure.

    v is the recovery bit (0/1).
    """
    if not (1 <= r < SECP_N and 1 <= s < SECP_N) or v not in (0, 1):
        return None
    x = r
    if x >= SECP_P:
        return None
    y_sq = (pow(x, 3, SECP_P) + 7) % SECP_P
    y = pow(y_sq, (SECP_P + 1) // 4, SECP_P)
    if (y * y) % SECP_P != y_sq:
        return None
    if (y & 1) != v:
        y = SECP_P - y
    r_point = (x, y)
    r_inv = _inv_mod(r, SECP_N)
    e = digest % SECP_N
    # Q = r^-1 (s*R - e*G)
    q_point = _ec_mul(
        r_inv, _ec_add(_ec_mul(s, r_point), _ec_mul((SECP_N - e) % SECP_N,
                                                    (SECP_GX, SECP_GY))))
    if q_point is None:
        return None
    qx, qy = q_point
    pub = qx.to_bytes(32, "big") + qy.to_bytes(32, "big")
    return int.from_bytes(keccak256(pub)[12:], "big")


# ---------------------------------------------------------------------------
# The processor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrecompileRoundWitness:
    name: str
    rounds: int


class GoldenPrecompilesProcessor:
    """Dispatch by the low 16 bits of the call's formal address."""

    def __init__(self, collect_witness: bool = True) -> None:
        self._collect = collect_witness

    def start_frame(self) -> None: ...
    def finish_frame(self, panicked: bool) -> None: ...

    def execute_precompile(self, monotonic_cycle_counter: int, query: LogQuery,
                           memory: GoldenMemory):
        abi = PrecompileCallABI.from_u256(query.key)
        address_low = query.address & 0xFFFF
        ts_read = query.timestamp
        ts_write = query.timestamp + 1
        mem_in: list[MemoryQuery] = []
        mem_out: list[MemoryQuery] = []

        def read_word(index: int) -> int:
            q = memory.execute_partial_query(monotonic_cycle_counter, MemoryQuery(
                timestamp=ts_read, memory_type=MemoryType.FAT_POINTER,
                page=abi.memory_page_to_read, index=index,
                value=0, value_is_pointer=False, rw_flag=False))
            mem_in.append(q)
            return q.value

        def write_word(index: int, value: int) -> None:
            q = memory.execute_partial_query(monotonic_cycle_counter, MemoryQuery(
                timestamp=ts_write, memory_type=MemoryType.HEAP,
                page=abi.memory_page_to_write, index=index,
                value=value, value_is_pointer=False, rw_flag=True))
            mem_out.append(q)

        if address_low == params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS:
            witness = self._keccak256(abi, read_word, write_word)
        elif address_low == params.SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS:
            witness = self._sha256(abi, read_word, write_word)
        elif address_low == params.ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS:
            witness = self._ecrecover(abi, read_word, write_word)
        else:
            return None
        if not self._collect:
            return None
        return mem_in, mem_out, witness

    def _keccak256(self, abi: PrecompileCallABI, read_word, write_word):
        offset, length = abi.input_memory_offset, abi.input_memory_length
        data = bytearray()
        if length:
            first_word = offset // 32
            last_word = (offset + length - 1) // 32
            for w in range(first_word, last_word + 1):
                data += read_word(w).to_bytes(32, "big")
            start = offset - first_word * 32
            data = data[start:start + length]
        digest = keccak256(bytes(data))
        write_word(abi.output_memory_offset, int.from_bytes(digest, "big"))
        rounds = (length + 1 + KECCAK_RATE_BYTES) // KECCAK_RATE_BYTES
        return PrecompileRoundWitness("keccak256", rounds)

    def _sha256(self, abi: PrecompileCallABI, read_word, write_word):
        rounds = abi.precompile_interpreted_data
        state = list(SHA256_IV)
        for rnd in range(rounds):
            block = b"".join(
                read_word(abi.input_memory_offset + 2 * rnd + i).to_bytes(32, "big")[:32]
                for i in range(2))
            state = sha256_compress(state, block[:64])
        out = int.from_bytes(b"".join(x.to_bytes(4, "big") for x in state), "big")
        write_word(abi.output_memory_offset, out)
        return PrecompileRoundWitness("sha256", rounds)

    def _ecrecover(self, abi: PrecompileCallABI, read_word, write_word):
        digest = read_word(abi.input_memory_offset + 0)
        v = read_word(abi.input_memory_offset + 1)
        r = read_word(abi.input_memory_offset + 2)
        s = read_word(abi.input_memory_offset + 3)
        recovered = ecrecover_inner(digest, v & 1, r, s)
        if recovered is None:
            write_word(abi.output_memory_offset + 0, 0)
            write_word(abi.output_memory_offset + 1, 0)
        else:
            write_word(abi.output_memory_offset + 0, 1)
            write_word(abi.output_memory_offset + 1, recovered)
        return PrecompileRoundWitness("ecrecover", 1)
