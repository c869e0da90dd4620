// Native scalar EraVM oracle — the C++ runtime counterpart of the golden
// Python model (and of the reference's native Rust VM): a fast sequential
// interpreter for high-volume differential fuzzing, and the machine's real
// measured single-core witness-traced baseline for bench.py.
//
// Coverage: all 15 opcode families incl. Log.precompile for keccak256,
// sha256 AND ecrecover (secp256k1 recovery, correctness-grade arithmetic):
// NOP ADD SUB MUL DIV JUMP CONTEXT(all 10
// sub-ops) SHIFT BINOP PTR NEAR_CALL FAR_CALL(normal/delegate/mimic, decommit,
// 63/64, register protocol) RET(ok/revert/panic with returndata forwarding)
// UMA(heap/aux/fat-pointer) LOG(sread/swrite/event/to_l1 with journal
// rollback).
//
// Decode tables are generated from the Python ISA layer (gen_tables.py) so
// variant semantics have one source of truth; ISA constants are pinned
// identically to isa/params.py (provenance lives there).  Semantics citations
// refer to the reference crate files (far_call.rs, ret.rs, uma.rs, log.rs)
// mirrored 1:1 by golden/vm.py.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

struct U256 { u64 w[4]; };  // little-endian limbs

static inline U256 z256() { return U256{{0, 0, 0, 0}}; }
static inline bool is_zero(const U256 &a) {
    return !(a.w[0] | a.w[1] | a.w[2] | a.w[3]);
}
static inline U256 add256(const U256 &a, const U256 &b, bool *carry) {
    U256 r; u128 c = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a.w[i] + b.w[i] + c;
        r.w[i] = (u64)s; c = s >> 64;
    }
    *carry = c != 0; return r;
}
static inline U256 sub256(const U256 &a, const U256 &b, bool *borrow) {
    U256 r; u64 c = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a.w[i] - b.w[i] - c;
        r.w[i] = (u64)s; c = (u64)(s >> 64) ? 1 : 0;
    }
    *borrow = c != 0; return r;
}
static inline void mul256(const U256 &a, const U256 &b, U256 *lo, U256 *hi) {
    u64 prod[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)a.w[i] * b.w[j] + prod[i + j] + carry;
            prod[i + j] = (u64)cur; carry = cur >> 64;
        }
        int k = i + 4; u128 c2 = carry;
        while (c2 && k < 8) {
            u128 cur = (u128)prod[k] + c2; prod[k] = (u64)cur; c2 = cur >> 64; k++;
        }
    }
    for (int i = 0; i < 4; i++) { lo->w[i] = prod[i]; hi->w[i] = prod[i + 4]; }
}
static inline int cmp256(const U256 &a, const U256 &b) {
    for (int i = 3; i >= 0; i--) {
        if (a.w[i] < b.w[i]) return -1;
        if (a.w[i] > b.w[i]) return 1;
    }
    return 0;
}
static inline void divmod256(const U256 &a, const U256 &b, U256 *q, U256 *r) {
    *q = z256(); *r = z256();
    if (is_zero(b)) return;
    for (int bit = 255; bit >= 0; bit--) {
        for (int i = 3; i >= 0; i--) {
            u64 in = (i > 0) ? (r->w[i - 1] >> 63)
                             : ((a.w[bit / 64] >> (bit % 64)) & 1);
            r->w[i] = (r->w[i] << 1) | in;
        }
        if (cmp256(*r, b) >= 0) {
            bool bw; *r = sub256(*r, b, &bw);
            q->w[bit / 64] |= 1ull << (bit % 64);
        }
    }
}
static inline U256 shl256(const U256 &a, unsigned n) {
    U256 r = z256();
    if (n >= 256) return r;
    unsigned ws = n / 64, bs = n % 64;
    for (int i = 3; i >= 0; i--) {
        u64 v = 0;
        if (i >= (int)ws) v = a.w[i - ws] << bs;
        if (bs && i > (int)ws) v |= a.w[i - ws - 1] >> (64 - bs);
        r.w[i] = v;
    }
    return r;
}
static inline U256 shr256(const U256 &a, unsigned n) {
    U256 r = z256();
    if (n >= 256) return r;
    unsigned ws = n / 64, bs = n % 64;
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        if (i + ws < 4) v = a.w[i + ws] >> bs;
        if (bs && i + ws + 1 < 4) v |= a.w[i + ws + 1] << (64 - bs);
        r.w[i] = v;
    }
    return r;
}
static inline U256 or256(const U256 &a, const U256 &b) {
    return U256{{a.w[0]|b.w[0], a.w[1]|b.w[1], a.w[2]|b.w[2], a.w[3]|b.w[3]}};
}
static inline U256 and256(const U256 &a, const U256 &b) {
    return U256{{a.w[0]&b.w[0], a.w[1]&b.w[1], a.w[2]&b.w[2], a.w[3]&b.w[3]}};
}
static inline U256 xor256(const U256 &a, const U256 &b) {
    return U256{{a.w[0]^b.w[0], a.w[1]^b.w[1], a.w[2]^b.w[2], a.w[3]^b.w[3]}};
}
static void to_be_bytes(const U256 &a, u8 *out) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            out[(3 - i) * 8 + j] = (u8)(a.w[i] >> (56 - 8 * j));
}
static U256 from_be_bytes(const u8 *in) {
    U256 r = z256();
    for (int limb = 0; limb < 4; limb++) {
        u64 v = 0;
        const u8 *p = in + (3 - limb) * 8;
        for (int j = 0; j < 8; j++) v = (v << 8) | p[j];
        r.w[limb] = v;
    }
    return r;
}

#include "tables.h"

// ISA constants (pinned identically to isa/params.py)
static const u32 INITIAL_SP = 1024;
static const u32 TIME_DELTA = 4;
static const u32 STARTING_TS = 1024;
static const u32 NEW_FRAME_STIPEND = 1 << 10;
static const u32 VM_MAX_STACK_DEPTH = 1024;
static const u64 MAX_OFFSET_TO_DEREF = 0x100000000ull - 33;
static const u64 KERNEL_BOUND = 1 << 16;
static const u32 STARTING_BASE_PAGE = 2048;
static const u32 NEW_PAGES_PER_FAR_CALL = 4;
static const u32 UNMAPPED_PAGE = 0;
static const u32 ERGS_PER_CODE_WORD_DECOMMIT = 4;
static const u64 DEPLOYER_ADDRESS = 0x8002;
static const u8 CODE_HASH_VERSION = 1;
static const u8 MARKER_AT_REST = 0;
static const u8 MARKER_YET_CONSTRUCTED = 1;
static const u32 STORAGE_WRITE_PUBDATA = 64;
static const u32 L1_MESSAGE_PUBDATA = 1 + 1 + 2 + 20 + 32 + 32;

enum { OP_NOP = 0, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_JUMP, OP_CONTEXT,
       OP_SHIFT, OP_BINOP, OP_PTR, OP_NEAR_CALL, OP_LOG, OP_FAR_CALL,
       OP_RET, OP_UMA, OP_INVALID };
enum { M_REG = 0, M_RI_REG, M_RI_IMM, M_F_REG, M_F_PUSHPOP, M_F_OFFSET,
       M_F_ABS, M_F_IMM16, M_F_CODE };

struct Props {
    u32 opcode, sub, src0_mode, dst0_mode;
    bool set_flags, swap_ops, flag0, flag1, req_kernel, static_ok,
         src0_ptr_ok, src1_ptr_ok, explicit_panic;
};
static Props unpack(u32 p) {
    Props r;
    r.opcode = p & 0xF; r.sub = (p >> 4) & 0xF;
    r.src0_mode = (p >> 8) & 0xF; r.dst0_mode = (p >> 12) & 0x7;
    r.set_flags = (p >> 15) & 1; r.swap_ops = (p >> 16) & 1;
    r.flag0 = (p >> 17) & 1; r.flag1 = (p >> 18) & 1;
    r.req_kernel = (p >> 19) & 1; r.static_ok = (p >> 20) & 1;
    r.src0_ptr_ok = (p >> 21) & 1; r.src1_ptr_ok = (p >> 22) & 1;
    r.explicit_panic = (p >> 23) & 1;
    return r;
}


// ---------------------------------------------------------------------------
// precompile hash primitives (keccak256 sponge + sha256 compression),
// mirroring era_zk_evm_tpu/golden/precompiles.py
// ---------------------------------------------------------------------------
static const u64 KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

static inline u64 rotl64(u64 x, int n) {
    return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccak_f1600(u64 st[25]) {
    static const int rho[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10,
                                43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61,
                                56, 14};
    for (int round = 0; round < 24; round++) {
        u64 c[5], d[5];
        for (int x = 0; x < 5; x++)
            c[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++) st[x + 5 * y] ^= d[x];
        u64 b[25];
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++) {
                int nx = y, ny = (2 * x + 3 * y) % 5;
                b[nx + 5 * ny] = rotl64(st[x + 5 * y], rho[x + 5 * y]);
            }
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                st[x + 5 * y] = b[x + 5 * y]
                    ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
        st[0] ^= KECCAK_RC[round];
    }
}

static void keccak256(const u8 *data, size_t len, u8 out[32]) {
    u64 st[25] = {0};
    const size_t rate = 136;
    size_t off = 0;
    while (true) {
        u8 blk[136] = {0};
        size_t take = len - off < rate ? len - off : rate;
        memcpy(blk, data + off, take);
        bool last = take < rate;
        if (last) {
            blk[take] ^= 0x01;
            blk[rate - 1] ^= 0x80;
        }
        for (int i = 0; i < 17; i++) {
            u64 lane = 0;
            for (int t = 7; t >= 0; t--) lane = (lane << 8) | blk[8 * i + t];
            st[i] ^= lane;
        }
        keccak_f1600(st);
        off += rate;
        if (last) break;
    }
    for (int i = 0; i < 32; i++) out[i] = (u8)(st[i / 8] >> (8 * (i % 8)));
}

static const u32 SHA256K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline u32 rotr32(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha256_compress(u32 st[8], const u8 blk[64]) {
    u32 w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((u32)blk[4 * i] << 24) | ((u32)blk[4 * i + 1] << 16)
             | ((u32)blk[4 * i + 2] << 8) | blk[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        u32 s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
        u32 s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u32 a = st[0], b = st[1], c = st[2], d = st[3];
    u32 e = st[4], f = st[5], g = st[6], h = st[7];
    for (int i = 0; i < 64; i++) {
        u32 s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
        u32 ch = (e & f) ^ (~e & g);
        u32 t1 = h + s1 + ch + SHA256K[i] + w[i];
        u32 s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
        u32 maj = (a & b) ^ (a & c) ^ (b & c);
        u32 t2 = s0 + maj;
        h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

struct Frame {
    u64 this_addr, msg_sender, code_addr;
    u64 ctx_lo, ctx_hi;            // context_u128_value
    u32 base_page, code_page;
    u32 sp, pc, eh, ergs, heap_bound, aux_heap_bound;
    u32 j_snap, ev_snap;           // storage-journal / event-journal snapshots
    u8 this_shard, caller_shard, code_shard;
    bool is_static, is_local;
};
struct Tagged { U256 v; bool ptr; };

struct Witness {
    u8 *buf; int cap; int count; bool overflow;
    void record(u32 ts, u8 type, u32 page, u32 index, const U256 &val,
                bool is_ptr, bool rw) {
        if (buf == nullptr) { count++; return; }
        if (count >= cap) { overflow = true; count++; return; }
        u8 *r = buf + (size_t)count * 64;
        memset(r, 0, 64);
        r[0] = ts >> 24; r[1] = ts >> 16; r[2] = ts >> 8; r[3] = (u8)ts;
        r[4] = type;
        r[5] = page >> 24; r[6] = page >> 16; r[7] = page >> 8; r[8] = (u8)page;
        r[9] = index >> 24; r[10] = index >> 16; r[11] = index >> 8;
        r[12] = (u8)index;
        r[13] = (rw ? 1 : 0) | (is_ptr ? 2 : 0);
        to_be_bytes(val, r + 32);
        count++;
    }
};

struct KV { U256 key; u64 addr; U256 val; bool used; };
struct JEntry { int slot; U256 prev; };
struct Event { U256 key, val; u32 ts; u8 aux; bool first; u16 tx; bool cancelled; };

struct LogWitness {
    u8 *buf; int cap; int count;
    void record(u32 ts, u8 aux, u8 shard, u8 flags, u16 tx, u64 addr,
                const U256 &key, const U256 &rd, const U256 &wr) {
        if (buf && count < cap) {
            u8 *r = buf + (size_t)count * 128;
            memset(r, 0, 128);
            r[0] = ts >> 24; r[1] = ts >> 16; r[2] = ts >> 8; r[3] = (u8)ts;
            r[4] = aux; r[5] = shard; r[6] = flags;
            r[7] = tx >> 8; r[8] = (u8)tx;
            for (int i = 0; i < 8; i++)
                r[12 + 12 + i] = (u8)(addr >> (56 - 8 * i));  // bytes 24..32
            to_be_bytes(key, r + 32);
            to_be_bytes(rd, r + 64);
            to_be_bytes(wr, r + 96);
        }
        count++;
    }
};

// decommit-witness record (48B): hash 32B BE + ts + page + len + fresh
struct DecWitness {
    u8 *buf; int cap; int count;
    void record(const U256 &hash, u32 ts, u32 page, u32 len, bool fresh) {
        if (buf && count < cap) {
            u8 *r = buf + (size_t)count * 48;
            memset(r, 0, 48);
            to_be_bytes(hash, r);
            r[32] = ts >> 24; r[33] = ts >> 16; r[34] = ts >> 8; r[35] = (u8)ts;
            r[36] = page >> 24; r[37] = page >> 16; r[38] = page >> 8;
            r[39] = (u8)page;
            r[40] = len >> 24; r[41] = len >> 16; r[42] = len >> 8;
            r[43] = (u8)len;
            r[44] = fresh ? 1 : 0;
        }
        count++;
    }
};

// ---------------------------------------------------------------------------
// secp256k1 ecrecover (mirrors golden/precompiles.ecrecover_inner).
// Correctness-grade arithmetic: shift-add mulmod + Fermat inversions on the
// U256 limbs — ~1 s per recovery, fine for the differential-test role (the
// bench baseline workloads contain no ecrecover).
// ---------------------------------------------------------------------------

static bool u256_lt(const U256 &a, const U256 &b) {
    for (int i = 3; i >= 0; i--) {
        if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
    }
    return false;
}
static bool u256_is_zero(const U256 &a) {
    return !(a.w[0] | a.w[1] | a.w[2] | a.w[3]);
}
static U256 u256_addc(const U256 &a, const U256 &b, bool &carry_out) {
    U256 r; unsigned __int128 c = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 s = (unsigned __int128)a.w[i] + b.w[i] + c;
        r.w[i] = (u64)s; c = s >> 64;
    }
    carry_out = c != 0;
    return r;
}
static U256 u256_subb(const U256 &a, const U256 &b, bool &borrow_out) {
    U256 r; unsigned __int128 brw = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d = (unsigned __int128)a.w[i] - b.w[i] - brw;
        r.w[i] = (u64)d; brw = (d >> 64) ? 1 : 0;
    }
    borrow_out = brw != 0;
    return r;
}
static U256 addmod256(const U256 &a, const U256 &b, const U256 &m) {
    bool c, br;
    U256 s = u256_addc(a, b, c);
    U256 t = u256_subb(s, m, br);
    return (c || !br) ? t : s;
}
static U256 mulmod256(const U256 &a, const U256 &b, const U256 &m) {
    // double-and-add over b's bits, MSB first
    U256 acc = {};
    bool any = false;
    for (int i = 255; i >= 0; i--) {
        if (any) acc = addmod256(acc, acc, m);
        if ((b.w[i / 64] >> (i % 64)) & 1) {
            acc = addmod256(acc, a, m);
            any = true;
        }
    }
    return acc;
}
static U256 powmod256(const U256 &a, const U256 &e, const U256 &m) {
    U256 acc = {}; acc.w[0] = 1;
    for (int i = 255; i >= 0; i--) {
        acc = mulmod256(acc, acc, m);
        if ((e.w[i / 64] >> (i % 64)) & 1) acc = mulmod256(acc, a, m);
    }
    return acc;
}
static U256 u256_from_words(u64 w0, u64 w1, u64 w2, u64 w3) {
    U256 r; r.w[0] = w0; r.w[1] = w1; r.w[2] = w2; r.w[3] = w3;
    return r;
}
static const U256 SECP_P = u256_from_words(
    0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
    0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL);
static const U256 SECP_N = u256_from_words(
    0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL,
    0xFFFFFFFFFFFFFFFEULL, 0xFFFFFFFFFFFFFFFFULL);
static const U256 SECP_GX = u256_from_words(
    0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL,
    0x55A06295CE870B07ULL, 0x79BE667EF9DCBBACULL);
static const U256 SECP_GY = u256_from_words(
    0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL,
    0x5DA4FBFC0E1108A8ULL, 0x483ADA7726A3C465ULL);

static U256 submod_p(const U256 &a, const U256 &b) {
    bool br;
    U256 d = u256_subb(a, b, br);
    if (br) { bool c; d = u256_addc(d, SECP_P, c); }
    return d;
}
static U256 invmod(const U256 &a, const U256 &m) {
    bool br;
    U256 two = {}; two.w[0] = 2;
    U256 e = u256_subb(m, two, br);
    return powmod256(a, e, m);
}

struct ECPoint { U256 x, y; bool inf; };

static ECPoint ec_add_pt(const ECPoint &p, const ECPoint &q) {
    if (p.inf) return q;
    if (q.inf) return p;
    bool x_eq = !memcmp(p.x.w, q.x.w, 32);
    U256 ysum = addmod256(p.y, q.y, SECP_P);
    if (x_eq && u256_is_zero(ysum)) return ECPoint{{}, {}, true};
    U256 lam;
    if (x_eq) {
        U256 three = {}; three.w[0] = 3;
        U256 num = mulmod256(three, mulmod256(p.x, p.x, SECP_P), SECP_P);
        U256 den = addmod256(p.y, p.y, SECP_P);
        lam = mulmod256(num, invmod(den, SECP_P), SECP_P);
    } else {
        U256 num = submod_p(q.y, p.y);
        U256 den = submod_p(q.x, p.x);
        lam = mulmod256(num, invmod(den, SECP_P), SECP_P);
    }
    U256 x3 = submod_p(submod_p(mulmod256(lam, lam, SECP_P), p.x), q.x);
    U256 y3 = submod_p(mulmod256(lam, submod_p(p.x, x3), SECP_P), p.y);
    return ECPoint{x3, y3, false};
}

static ECPoint ec_mul_pt(const U256 &k, const ECPoint &p) {
    ECPoint acc{{}, {}, true};
    ECPoint base = p;
    for (int i = 0; i < 256; i++) {
        if ((k.w[i / 64] >> (i % 64)) & 1) acc = ec_add_pt(acc, base);
        base = ec_add_pt(base, base);
    }
    return acc;
}

// returns true + writes the recovered address (low 160 bits) on success
static bool ecrecover_native(const U256 &digest, u64 v, const U256 &r,
                             const U256 &s, U256 &addr_out) {
    U256 one = {}; one.w[0] = 1;
    if (u256_is_zero(r) || u256_is_zero(s)) return false;
    if (!u256_lt(r, SECP_N) || !u256_lt(s, SECP_N)) return false;
    if (v > 1) return false;
    if (!u256_lt(r, SECP_P)) return false;
    U256 seven = {}; seven.w[0] = 7;
    U256 y_sq = addmod256(
        mulmod256(mulmod256(r, r, SECP_P), r, SECP_P), seven, SECP_P);
    // sqrt: y = y_sq^((p+1)/4)
    bool c;
    U256 e = u256_addc(SECP_P, one, c);  // p+1 (no overflow: p < 2^256-1)
    // shift right by 2
    U256 e4;
    for (int i = 0; i < 4; i++) {
        u64 hi = (i < 3) ? e.w[i + 1] : 0;
        e4.w[i] = (e.w[i] >> 2) | (hi << 62);
    }
    U256 y = powmod256(y_sq, e4, SECP_P);
    if (memcmp(mulmod256(y, y, SECP_P).w, y_sq.w, 32)) return false;
    if ((y.w[0] & 1) != v) y = submod_p(SECP_P, y);
    ECPoint R{r, y, false};
    ECPoint G{SECP_GX, SECP_GY, false};
    U256 r_inv = invmod(r, SECP_N);
    // e_red = digest mod n
    U256 e_red = digest;
    while (!u256_lt(e_red, SECP_N)) { bool br; e_red = u256_subb(e_red, SECP_N, br); }
    U256 neg_e = u256_is_zero(e_red) ? e_red : [&] {
        bool br; return u256_subb(SECP_N, e_red, br);
    }();
    ECPoint q = ec_mul_pt(r_inv, ec_add_pt(ec_mul_pt(s, R),
                                           ec_mul_pt(neg_e, G)));
    if (q.inf) return false;
    u8 pub[64];
    to_be_bytes(q.x, pub);
    to_be_bytes(q.y, pub + 32);
    u8 digest32[32];
    keccak256(pub, 64, digest32);
    u8 addr_be[32];
    memset(addr_be, 0, 12);
    memcpy(addr_be + 12, digest32 + 12, 20);
    addr_out = from_be_bytes(addr_be);
    return true;
}

struct BankEntry { U256 stored_hash; const U256 *words; int len; u32 page; };
struct CodePage { const U256 *words; int len; };

enum { ST_DONE = 0, ST_MAX_CYCLES = 1, ST_UNSUPPORTED = 2, ST_OOB = 3 };

extern "C" int eravm_oracle_run(
    const u8 *code_be, int n_code_words,
    const u8 *bank_hashes_be, const int *bank_lens,
    const u8 *bank_words_be, int n_bank,
    const u8 *storage_init, int n_storage_init,  // 96B: addr@16..24|key|val
    const u8 *default_aa_be,                     // 32B BE stored hash or null
    u64 entry_address, u64 ergs, int max_cycles,
    int stack_words, int heap_words, int aux_words,
    u8 *regs_out /*15*32B BE*/, u8 *reg_ptr_out /*15 bytes*/,
    u8 *heap_out /*heap_words*32B BE*/,
    u8 *witness_buf, int witness_cap, int *witness_count,
    u8 *log_buf, int log_cap, int *log_count,
    u8 *dec_buf, int dec_cap, int *dec_count,
    u8 *storage_buf, int storage_cap, int *storage_count,
    u8 *events_buf, int events_cap, int *events_count,
    int *cycles_out, int *flags_out, u64 *entry_ergs_out) {

    const u32 entry_base_page = 8;
    const u32 entry_heap_page = entry_base_page + 2;

    // ---- code pages / bank
    std::vector<U256> entry_code(n_code_words);
    for (int i = 0; i < n_code_words; i++)
        entry_code[i] = from_be_bytes(code_be + (size_t)i * 32);
    std::vector<BankEntry> bank(n_bank);
    std::vector<std::vector<U256>> bank_storage(n_bank);
    {
        size_t off = 0;
        for (int i = 0; i < n_bank; i++) {
            bank[i].stored_hash = from_be_bytes(bank_hashes_be + (size_t)i * 32);
            int len = bank_lens[i];
            bank_storage[i].resize(len);
            for (int w = 0; w < len; w++)
                bank_storage[i][w] = from_be_bytes(bank_words_be + (off + w) * 32);
            bank[i].words = bank_storage[i].data();
            bank[i].len = len;
            bank[i].page = 0;  // unbound
            off += len;
        }
    }
    std::unordered_map<u32, CodePage> code_pages;
    code_pages[entry_base_page] = CodePage{entry_code.data(), n_code_words};

    // ---- heap-like pages (heap + aux share one registry; fat-pointer reads
    // resolve any of them) and per-far-frame stack pages
    std::unordered_map<u32, std::vector<U256>> heap_pages;
    std::unordered_map<u32, std::vector<Tagged>> stack_pages;
    auto make_heap_page = [&](u32 page, int words) -> U256 * {
        auto &v = heap_pages[page];
        v.assign(words, z256());
        return v.data();
    };
    auto make_stack_page = [&](u32 page) -> Tagged * {
        auto &v = stack_pages[page];
        v.assign(stack_words, Tagged{z256(), false});
        return v.data();
    };
    U256 *entry_heap = make_heap_page(entry_heap_page, heap_words);
    make_heap_page(entry_base_page + 3, aux_words);
    make_stack_page(entry_base_page + 1);

    // ---- storage + default AA
    const int KV_CAP = 128, J_CAP = 256, EV_CAP = 256;
    KV kv[KV_CAP] = {};
    int kv_count = 0;
    for (int i = 0; i < n_storage_init && kv_count < KV_CAP; i++) {
        const u8 *r = storage_init + (size_t)i * 96;
        u64 addr = 0;
        for (int j = 16; j < 24; j++) addr = (addr << 8) | r[j];
        kv[kv_count++] = KV{from_be_bytes(r + 32), addr,
                            from_be_bytes(r + 64), true};
    }
    U256 default_aa = default_aa_be ? from_be_bytes(default_aa_be) : z256();

    JEntry journal[J_CAP];
    int j_count = 0;
    Event events[EV_CAP];
    int ev_count = 0;

    Tagged regs[15] = {};
    bool f_lt = false, f_eq = false, f_gt = false;
    u32 timestamp = STARTING_TS;
    bool pending_exc = false;
    U256 prev_code_word = z256();
    u32 prev_super_pc = 0; bool have_prev = false;
    u32 prev_code_page_v = 0;
    u64 ctx_reg_lo = 0, ctx_reg_hi = 0;     // context_u128_register
    u32 ergs_per_pubdata = 0;
    u32 spent_pubdata = 0;
    u16 tx_number = 0;
    u32 memory_page_counter =
        STARTING_BASE_PAGE > entry_base_page + NEW_PAGES_PER_FAR_CALL
            ? STARTING_BASE_PAGE : entry_base_page + NEW_PAGES_PER_FAR_CALL;

    Frame *frames = new Frame[VM_MAX_STACK_DEPTH + 2];
    int depth = 1;
    frames[0] = Frame{};
    frames[0].sp = INITIAL_SP;
    frames[1] = Frame{};
    frames[1].this_addr = entry_address;
    frames[1].code_addr = entry_address;
    frames[1].base_page = entry_base_page;
    frames[1].code_page = entry_base_page;
    frames[1].sp = INITIAL_SP;
    frames[1].eh = 0xFFFF;
    frames[1].ergs = (u32)ergs;
    frames[1].heap_bound = NEW_FRAME_STIPEND;
    frames[1].aux_heap_bound = NEW_FRAME_STIPEND;

    // current-frame arena cache (refreshed on far frame transitions)
    Tagged *cur_stack = stack_pages[entry_base_page + 1].data();
    U256 *cur_heap = heap_pages[entry_heap_page].data();
    U256 *cur_aux = heap_pages[entry_base_page + 3].data();
    CodePage cur_code = code_pages[entry_base_page];
    auto refresh_cache = [&](const Frame &f) -> bool {
        auto si = stack_pages.find(f.base_page + 1);
        auto hi = heap_pages.find(f.base_page + 2);
        auto ai = heap_pages.find(f.base_page + 3);
        if (si == stack_pages.end() || hi == heap_pages.end()
            || ai == heap_pages.end()) return false;
        cur_stack = si->second.data();
        cur_heap = hi->second.data();
        cur_aux = ai->second.data();
        auto ci = code_pages.find(f.code_page);
        if (ci == code_pages.end()) cur_code = CodePage{nullptr, 0};
        else cur_code = ci->second;
        return true;
    };

    Witness wit{witness_buf, witness_cap, 0, false};
    LogWitness logw{log_buf, log_cap, 0};
    DecWitness decw{dec_buf, dec_cap, 0};
    u32 last_frame_ergs = 0;  // entry-frame ergs at final ret

    auto read_reg = [&](u32 idx) -> Tagged {
        if (idx == 0) return Tagged{z256(), false};
        return regs[idx - 1];
    };
    auto write_reg = [&](u32 idx, const U256 &v, bool ptr) {
        if (idx > 0) { regs[idx - 1].v = v; regs[idx - 1].ptr = ptr; }
    };
    auto find_slot = [&](const U256 &key, u64 addr) {
        for (int i = 0; i < kv_count; i++)
            if (kv[i].used && kv[i].addr == addr
                && cmp256(kv[i].key, key) == 0) return i;
        return -1;
    };

    int status = ST_MAX_CYCLES;
    int cycle = 0;
    for (; cycle < max_cycles && status == ST_MAX_CYCLES; cycle++) {
        if (depth == 0) { status = ST_DONE; break; }
        Frame &cur = frames[depth];
        bool is_kernel = cur.this_addr < KERNEL_BOUND;

        // ---- fetch + decode (golden/vm.py _read_and_decode)
        u32 pc = cur.pc;
        u32 super_pc = pc >> 2, sub_pc = pc & 3;
        u32 variant, cond;
        u32 src0_reg, src1_reg, dst0_reg, dst1_reg, imm0, imm1;
        if (pending_exc) {
            pending_exc = false;
            // quirk preserved: previous_super_pc updates, code word does not
            prev_super_pc = super_pc; have_prev = true;
            prev_code_page_v = cur.code_page;
            variant = PANIC_VARIANT; cond = 0;
            src0_reg = src1_reg = dst0_reg = dst1_reg = 0; imm0 = imm1 = 0;
        } else {
            bool need = (cur.code_page != prev_code_page_v) || !have_prev
                        || (super_pc != prev_super_pc);
            if (need) {
                if ((int)super_pc >= cur_code.len || cur_code.words == nullptr) {
                    status = ST_OOB; break;
                }
                prev_code_word = cur_code.words[super_pc];
                prev_super_pc = super_pc; have_prev = true;
                wit.record(timestamp, 4, cur.code_page, super_pc,
                           prev_code_word, false, false);
            }
            prev_code_page_v = cur.code_page;
            u64 insn = prev_code_word.w[3 - sub_pc];
            variant = insn & 0x7FF;
            cond = (insn >> 11) & 7;
            src0_reg = (insn >> 16) & 0xF; src1_reg = (insn >> 20) & 0xF;
            dst0_reg = (insn >> 24) & 0xF; dst1_reg = (insn >> 28) & 0xF;
            imm0 = (insn >> 32) & 0xFFFF; imm1 = (insn >> 48) & 0xFFFF;
        }

        Props raw = unpack(VARIANT_PACKED[variant]);
        u32 price = VARIANT_PRICE[variant];
        bool not_enough = cur.ergs < price;
        cur.ergs = not_enough ? 0 : cur.ergs - price;
        bool mask_panic = raw.explicit_panic || not_enough
            || (raw.req_kernel && !is_kernel)
            || (!raw.static_ok && cur.is_static)
            || (depth >= (int)VM_MAX_STACK_DEPTH);

        bool cond_met;
        switch (cond) {
            case 0: cond_met = true; break;
            case 1: cond_met = f_gt; break;
            case 2: cond_met = f_lt; break;
            case 3: cond_met = f_eq; break;
            case 4: cond_met = f_gt || f_eq; break;
            case 5: cond_met = f_lt || f_eq; break;
            case 6: cond_met = !f_eq; break;
            default: cond_met = f_gt || f_lt; break;
        }
        if (mask_panic) {
            variant = PANIC_VARIANT;
        } else if (!cond_met) {
            variant = NOP_VARIANT;
        }
        if (mask_panic || !cond_met) {
            src0_reg = src1_reg = dst0_reg = dst1_reg = 0; imm0 = imm1 = 0;
        }
        Props pr = unpack(VARIANT_PACKED[variant]);

        // ---- addressing (golden/vm.py _compute_address)
        u32 sp = cur.sp;
        Tagged src0_rv = read_reg(src0_reg);
        u32 vaddr0 = (u32)((src0_rv.v.w[0] + imm0) & 0xFFFF);
        bool s0_stack = false, s0_code = false; u32 s0_idx = 0;
        switch (pr.src0_mode) {
            case M_F_PUSHPOP:
                sp = (sp - vaddr0) & 0xFFFF; s0_idx = sp; s0_stack = true; break;
            case M_F_OFFSET: s0_idx = (sp - vaddr0) & 0xFFFF; s0_stack = true; break;
            case M_F_ABS: s0_idx = vaddr0; s0_stack = true; break;
            case M_F_CODE: s0_idx = vaddr0; s0_code = true; break;
            default: break;
        }
        Tagged dst0_rv = read_reg(dst0_reg);
        u32 vaddr1 = (u32)((dst0_rv.v.w[0] + imm1) & 0xFFFF);
        bool d0_stack = false; u32 d0_idx = 0;
        switch (pr.dst0_mode) {
            case M_F_PUSHPOP:
                d0_idx = sp; sp = (sp + vaddr1) & 0xFFFF; d0_stack = true; break;
            case M_F_OFFSET: d0_idx = (sp - vaddr1) & 0xFFFF; d0_stack = true; break;
            case M_F_ABS: d0_idx = vaddr1; d0_stack = true; break;
            default: break;
        }
        cur.sp = sp;

        bool do_src_read = (s0_stack || s0_code) && pr.opcode != OP_NOP;
        Tagged src0{z256(), false};
        if (do_src_read) {
            if (s0_stack) {
                if ((int)s0_idx >= stack_words) { status = ST_OOB; break; }
                src0 = cur_stack[s0_idx];
                wit.record(timestamp, 0, cur.base_page + 1, s0_idx, src0.v,
                           src0.ptr, false);
            } else {
                if ((int)s0_idx >= cur_code.len) { status = ST_OOB; break; }
                src0 = Tagged{cur_code.words[s0_idx], false};
                wit.record(timestamp, 4, cur.code_page, s0_idx, src0.v, false,
                           false);
            }
        } else if (pr.src0_mode == M_RI_IMM || pr.src0_mode == M_F_IMM16) {
            src0.v.w[0] = imm0;
        } else if (pr.src0_mode == M_REG || pr.src0_mode == M_RI_REG
                   || pr.src0_mode == M_F_REG) {
            src0 = src0_rv;
        }
        Tagged src1 = read_reg(src1_reg);
        if (pr.swap_ops) { Tagged t = src0; src0 = src1; src1 = t; }

        u32 new_pc = (pc + 1) & 0xFFFF;

        // pointer-taint erasure
        if (src0.ptr && !pr.src0_ptr_ok && !is_kernel) {
            src0.v.w[0] &= 0xFFFFFFFFull; src0.v.w[1] = 0; src0.ptr = false;
        }
        if (src1.ptr && !pr.src1_ptr_ok && !is_kernel) {
            src1.v.w[0] &= 0xFFFFFFFFull; src1.v.w[1] = 0; src1.ptr = false;
        }

        auto dst0_write = [&](const U256 &v, bool ptr) {
            if (d0_stack) {
                if ((int)d0_idx >= stack_words) { status = ST_OOB; return; }
                cur_stack[d0_idx] = Tagged{v, ptr};
                wit.record(timestamp + 3, 0, cur.base_page + 1, d0_idx, v, ptr,
                           true);
            } else {
                write_reg(dst0_reg, v, ptr);
            }
        };
        auto set_flags3 = [&](bool lt, bool eq, bool gt) {
            if (pr.set_flags) { f_lt = lt; f_eq = eq; f_gt = gt; }
        };

        switch (pr.opcode) {
            case OP_NOP: cur.pc = new_pc; break;
            case OP_ADD: {
                cur.pc = new_pc;
                bool of; U256 r = add256(src0.v, src1.v, &of);
                bool eq = is_zero(r);
                set_flags3(of, eq, !eq && !of);
                dst0_write(r, false);
                break;
            }
            case OP_SUB: {
                cur.pc = new_pc;
                bool uf; U256 r = sub256(src0.v, src1.v, &uf);
                bool eq = is_zero(r);
                set_flags3(uf, eq, !eq && !uf);
                dst0_write(r, false);
                break;
            }
            case OP_MUL: {
                cur.pc = new_pc;
                U256 lo, hi; mul256(src0.v, src1.v, &lo, &hi);
                bool of = !is_zero(hi), eq = is_zero(lo);
                set_flags3(of, eq, !of && !eq);
                dst0_write(lo, false);
                write_reg(dst1_reg, hi, false);
                break;
            }
            case OP_DIV: {
                cur.pc = new_pc;
                if (is_zero(src1.v)) {
                    set_flags3(true, false, false);
                    dst0_write(z256(), false);
                    write_reg(dst1_reg, z256(), false);
                } else {
                    U256 q, r; divmod256(src0.v, src1.v, &q, &r);
                    set_flags3(false, is_zero(q), is_zero(r));
                    dst0_write(q, false);
                    write_reg(dst1_reg, r, false);
                }
                break;
            }
            case OP_JUMP: cur.pc = (u32)(src0.v.w[0] & 0xFFFF); break;
            case OP_CONTEXT: {
                cur.pc = new_pc;
                U256 v = z256();
                switch (pr.sub) {
                    case 0: v.w[0] = cur.this_addr; break;         // this
                    case 1: v.w[0] = cur.msg_sender; break;        // caller
                    case 2: v.w[0] = cur.code_addr; break;         // code addr
                    case 3:                                        // meta
                        v.w[0] = ergs_per_pubdata;
                        v.w[1] = cur.heap_bound;
                        v.w[1] |= (u64)cur.aux_heap_bound << 32;
                        v.w[3] = ((u64)cur.this_shard
                                  | ((u64)cur.caller_shard << 8)
                                  | ((u64)cur.code_shard << 16)) << 32;
                        break;
                    case 4: v.w[0] = cur.ergs; break;              // ergs left
                    case 5: v.w[0] = cur.sp; break;                // sp
                    case 6:                                        // ctx u128
                        v.w[0] = cur.ctx_lo; v.w[1] = cur.ctx_hi; break;
                    case 7:                                        // set u128
                        ctx_reg_lo = src0.v.w[0]; ctx_reg_hi = src0.v.w[1];
                        break;
                    case 8:                                        // set epp
                        ergs_per_pubdata = (u32)src0.v.w[0]; break;
                    default:                                       // inc tx
                        tx_number = (tx_number + 1) & 0xFFFF; break;
                }
                if (pr.sub <= 6) dst0_write(v, false);
                break;
            }
            case OP_SHIFT: {
                cur.pc = new_pc;
                unsigned n = (unsigned)(src1.v.w[0] & 0xFF);
                U256 r;
                bool right = (pr.sub == 1) || (pr.sub == 3);
                bool cyclic = (pr.sub == 2) || (pr.sub == 3);
                if (right) {
                    r = shr256(src0.v, n);
                    if (cyclic) r = or256(r, shl256(src0.v, 256 - n));
                } else {
                    r = shl256(src0.v, n);
                    if (cyclic) r = or256(r, shr256(src0.v, 256 - n));
                }
                if (pr.set_flags) { f_lt = false; f_gt = false; f_eq = is_zero(r); }
                dst0_write(r, false);
                break;
            }
            case OP_BINOP: {
                cur.pc = new_pc;
                U256 r = pr.sub == 0 ? xor256(src0.v, src1.v)
                        : pr.sub == 1 ? and256(src0.v, src1.v)
                                      : or256(src0.v, src1.v);
                if (pr.set_flags) { f_lt = false; f_gt = false; f_eq = is_zero(r); }
                dst0_write(r, false);
                break;
            }
            case OP_PTR: {
                cur.pc = new_pc;
                if (!src0.ptr || src1.ptr) { pending_exc = true; break; }
                u64 off_field = src0.v.w[0] & 0xFFFFFFFFull;
                u64 len_field = (src0.v.w[1] >> 32) & 0xFFFFFFFFull;
                bool src1_big = src1.v.w[1] | src1.v.w[2] | src1.v.w[3]
                    | (src1.v.w[0] >> 32);
                U256 r = src0.v;
                if (pr.sub <= 1) {  // add/sub
                    if (src1_big) { pending_exc = true; break; }
                    u64 o = src1.v.w[0] & 0xFFFFFFFFull;
                    u64 no = pr.sub == 0 ? off_field + o : off_field - o;
                    if (no >> 32) { pending_exc = true; break; }
                    r.w[0] = (r.w[0] & ~0xFFFFFFFFull) | no;
                } else if (pr.sub == 2) {  // pack
                    if ((src1.v.w[0] | src1.v.w[1])) { pending_exc = true; break; }
                    r.w[2] = src1.v.w[2]; r.w[3] = src1.v.w[3];
                } else {  // shrink
                    u64 o = src1.v.w[0] & 0xFFFFFFFFull;
                    u64 nl = len_field - o;
                    if (nl >> 32) { pending_exc = true; break; }
                    r.w[1] = (r.w[1] & 0xFFFFFFFFull) | (nl << 32);
                }
                dst0_write(r, true);
                break;
            }
            case OP_NEAR_CALL: {
                f_lt = f_eq = f_gt = false;
                u32 want = (u32)(src0.v.w[0] & 0xFFFFFFFFull);
                u32 passed, left;
                if (want == 0 || want > cur.ergs) { passed = cur.ergs; left = 0; }
                else { passed = want; left = cur.ergs - want; }
                cur.ergs = left; cur.pc = new_pc;
                Frame nf = cur;
                nf.pc = imm0; nf.eh = imm1; nf.ergs = passed; nf.is_local = true;
                nf.j_snap = j_count; nf.ev_snap = ev_count;
                depth++; frames[depth] = nf;
                break;
            }
            case OP_FAR_CALL: {
                // far_call.rs:35-613 / golden _apply_far_call
                f_lt = f_eq = f_gt = false;
                u32 sub = pr.sub;  // 0 normal, 1 delegate, 2 mimic
                bool is_static_call = pr.flag0;
                bool is_call_shard = pr.flag1;
                u64 called_address = src1.v.w[0];
                if (src1.v.w[1] | src1.v.w[2] | src1.v.w[3]) {
                    status = ST_UNSUPPORTED; break;  // >64-bit addresses
                }
                bool dst_is_kernel = called_address < KERNEL_BOUND;

                // FarCallABI from src0 (abi.py): fp low128, ergs limb6,
                // shard/mode/ctor/system bytes of limb7
                u32 fp_offset = (u32)src0.v.w[0];
                u32 fp_page = (u32)(src0.v.w[0] >> 32);
                u32 fp_start = (u32)src0.v.w[1];
                u32 fp_length = (u32)(src0.v.w[1] >> 32);
                u32 abi_ergs = (u32)src0.v.w[3];
                u8 abi_shard = (u8)(src0.v.w[3] >> 32);
                u8 fwd_mode = (u8)(src0.v.w[3] >> 40);
                if (fwd_mode > 2) fwd_mode = 0;  // saturate to UseHeap
                bool ctor_call = ((src0.v.w[3] >> 48) & 0xFF) && is_kernel;
                bool to_system = ((src0.v.w[3] >> 56) & 0xFF) && dst_is_kernel;

                u8 caller_shard = cur.this_shard;
                u8 new_code_shard = is_call_shard ? abi_shard : caller_shard;
                u8 new_this_shard = (sub == 1) ? caller_shard : new_code_shard;
                u32 new_base = memory_page_counter;

                u32 exceptions = 0;
                const u32 EX_NOT_PTR = 1, EX_BAD_HASH = 2, EX_NO_ERGS_DEC = 4,
                          EX_NO_ERGS_GROW = 8, EX_MALFORMED = 16,
                          EX_CTOR_SYSTEM = 32;

                // code hash storage read (far_call.rs:122-158)
                U256 code_hash_raw = z256();
                bool map_trivial = new_code_shard != 0;  // zkporter off
                if (!map_trivial) {
                    U256 key = z256(); key.w[0] = called_address;
                    int s = find_slot(key, DEPLOYER_ADDRESS);
                    U256 from_storage = (s >= 0) ? kv[s].val : z256();
                    logw.record(timestamp + 1, 0, new_code_shard, 0, tx_number,
                                DEPLOYER_ADDRESS, key, from_storage,
                                from_storage);
                    bool mask_aa = is_zero(from_storage) && !dst_is_kernel;
                    code_hash_raw = mask_aa ? default_aa : from_storage;
                }
                u32 code_page_candidate = map_trivial ? UNMAPPED_PAGE : new_base;

                // versioned-hash validation (far_call.rs:169-252)
                U256 code_hash = z256();
                u32 code_len = 0;
                u8 vh_version = (u8)(code_hash_raw.w[3] >> 56);
                u8 vh_marker = (u8)(code_hash_raw.w[3] >> 48);
                u32 vh_len = (u32)((code_hash_raw.w[3] >> 32) & 0xFFFF);
                if (vh_version != CODE_HASH_VERSION) {
                    exceptions |= EX_BAD_HASH;
                } else if (vh_marker != MARKER_AT_REST
                           && vh_marker != MARKER_YET_CONSTRUCTED) {
                    exceptions |= EX_BAD_HASH;
                } else {
                    bool can_at_rest = !ctor_call && vh_marker == MARKER_AT_REST;
                    bool can_ctor = ctor_call && vh_marker == MARKER_YET_CONSTRUCTED;
                    if (can_at_rest || can_ctor) {
                        code_hash = code_hash_raw;
                        code_hash.w[3] &= ~(0xFFull << 48);  // stored form
                        code_len = vh_len;
                    } else if (!dst_is_kernel) {
                        code_hash = default_aa;
                        code_len = (u32)((default_aa.w[3] >> 32) & 0xFFFF);
                    } else {
                        exceptions |= EX_CTOR_SYSTEM;
                    }
                }

                // pointer validation + forwarding (far_call.rs:254-325)
                bool fwd_fat = fwd_mode == 1;
                if (fwd_fat && !src0.ptr) exceptions |= EX_NOT_PTR;
                bool deref_beyond = ((u64)fp_start + fp_length) >> 32;
                if (deref_beyond) exceptions |= EX_MALFORMED;
                if (!fwd_fat && fp_offset != 0) exceptions |= EX_MALFORMED;
                if (fp_offset > fp_length) exceptions |= EX_MALFORMED;
                if (fwd_fat) {
                    fp_start += fp_offset; fp_length -= fp_offset; fp_offset = 0;
                } else if (fwd_mode == 0) {
                    fp_page = cur.base_page + 2;
                } else {
                    fp_page = cur.base_page + 3;
                }
                if (exceptions) { fp_offset = fp_page = fp_start = fp_length = 0; }

                // memory growth payment vs the caller frame (far_call.rs:329+)
                u32 remaining = cur.ergs;
                if (!fwd_fat) {
                    u64 upper = deref_beyond ? 0xFFFFFFFFull
                                             : (u64)fp_start + fp_length;
                    u32 &bound = fwd_mode == 0 ? cur.heap_bound
                                               : cur.aux_heap_bound;
                    if (upper > bound) {
                        u32 diff = (u32)(upper - bound);
                        bound = (u32)upper;
                        if (remaining >= diff) remaining -= diff;
                        else { exceptions |= EX_NO_ERGS_GROW; remaining = 0; }
                    }
                }

                u32 cost_dec = ERGS_PER_CODE_WORD_DECOMMIT * code_len;
                if (remaining >= cost_dec) remaining -= cost_dec;
                else exceptions |= EX_NO_ERGS_DEC;

                u32 code_memory_page;
                if (exceptions) {
                    pending_exc = true;
                    code_memory_page = UNMAPPED_PAGE;
                    fp_offset = fp_page = fp_start = fp_length = 0;
                } else {
                    // decommit (decommitter.rs:31-99)
                    int bi = -1;
                    for (int i = 0; i < n_bank; i++)
                        if (cmp256(bank[i].stored_hash, code_hash) == 0) {
                            bi = i; break;
                        }
                    if (bi < 0) { status = ST_OOB; break; }  // unknown hash
                    if (bank[bi].page != 0) {
                        code_memory_page = bank[bi].page;  // repeat: refund
                        remaining += cost_dec;
                        decw.record(code_hash, timestamp + 1, code_memory_page,
                                    bank[bi].len, false);
                    } else {
                        code_memory_page = code_page_candidate;
                        bank[bi].page = code_memory_page;
                        code_pages[code_memory_page] =
                            CodePage{bank[bi].words, bank[bi].len};
                        decw.record(code_hash, timestamp + 1, code_memory_page,
                                    bank[bi].len, true);
                    }
                }

                // 63/64 rule (far_call.rs:465-487)
                u32 max_passable = (remaining / 64) * 63;
                u32 leftover = remaining - max_passable;
                u32 passed, for_this;
                if (abi_ergs > max_passable) {
                    passed = max_passable; for_this = leftover;
                } else {
                    passed = abi_ergs;
                    for_this = leftover + (max_passable - abi_ergs);
                }
                cur.ergs = for_this;
                cur.pc = new_pc;
                memory_page_counter += NEW_PAGES_PER_FAR_CALL;

                u64 addr_next, sender_next;
                if (sub == 0) { addr_next = called_address; sender_next = cur.this_addr; }
                else if (sub == 1) { addr_next = cur.this_addr; sender_next = cur.msg_sender; }
                else { addr_next = called_address;
                       sender_next = regs[14].v.w[0]; }  // r15 low 160 (u64 subset)
                u64 u128_lo = (sub == 1) ? cur.ctx_lo : ctx_reg_lo;
                u64 u128_hi = (sub == 1) ? cur.ctx_hi : ctx_reg_hi;

                Frame nf{};
                nf.this_addr = addr_next;
                nf.msg_sender = sender_next;
                nf.code_addr = called_address;
                nf.ctx_lo = u128_lo; nf.ctx_hi = u128_hi;
                nf.base_page = new_base;
                nf.code_page = code_memory_page;
                nf.sp = INITIAL_SP;
                nf.pc = 0;
                nf.eh = imm0;
                nf.ergs = passed;
                nf.heap_bound = NEW_FRAME_STIPEND;
                nf.aux_heap_bound = NEW_FRAME_STIPEND;
                nf.this_shard = new_this_shard;
                nf.caller_shard = caller_shard;
                nf.code_shard = new_code_shard;
                nf.is_static = cur.is_static || is_static_call;
                nf.is_local = false;
                nf.j_snap = j_count; nf.ev_snap = ev_count;
                ctx_reg_lo = ctx_reg_hi = 0;
                depth++; frames[depth] = nf;

                // start_global_frame: allocate the callee's pages
                make_stack_page(new_base + 1);
                make_heap_page(new_base + 2, heap_words);
                make_heap_page(new_base + 3, aux_words);
                if (!refresh_cache(frames[depth])) { status = ST_OOB; break; }

                // register protocol (far_call.rs:571-610)
                U256 fpv = z256();
                fpv.w[0] = (u64)fp_offset | ((u64)fp_page << 32);
                fpv.w[1] = (u64)fp_start | ((u64)fp_length << 32);
                regs[0] = Tagged{fpv, true};
                U256 r2 = z256();
                r2.w[0] = (ctor_call ? 1 : 0) | (to_system ? 2 : 0);
                regs[1] = Tagged{r2, false};
                for (int i = 2; i < 12; i++) {      // system ABI r3..r12
                    if (!to_system) regs[i] = Tagged{z256(), false};
                    else regs[i].ptr = false;
                }
                for (int i = 12; i < 15; i++)       // reserved + param r13..r15
                    regs[i] = Tagged{z256(), false};
                break;
            }
            case OP_RET: {
                f_lt = f_eq = f_gt = false;
                u32 sub = pr.sub;  // 0 ok, 1 revert, 2 panic
                bool to_label = pr.flag0;
                Frame fin = frames[depth];
                U256 abi = (sub == 2) ? z256() : src0.v;
                bool abi_ptr = (sub == 2) ? false : src0.ptr;
                u32 fp_offset = (u32)abi.w[0];
                u32 fp_page = (u32)(abi.w[0] >> 32);
                u32 fp_start = (u32)abi.w[1];
                u32 fp_length = (u32)(abi.w[1] >> 32);
                u8 fwd_mode = (u8)(abi.w[3] >> 40);
                if (fwd_mode > 2) fwd_mode = 0;
                bool fwd_fat = fwd_mode == 1;

                u32 ergs_left = fin.ergs;
                if (!fin.is_local) {
                    // returndata pointer validation (ret.rs:58-96); the
                    // growth step below keys on the ORIGINAL mode/validation
                    // results even after panic escalation (golden ret:979-994)
                    bool fwd_fat_orig = fwd_fat;
                    u8 fwd_mode_orig = fwd_mode;
                    bool deref_beyond = ((u64)fp_start + fp_length) >> 32;
                    bool panic_now = sub == 2;
                    if (fwd_fat && !abi_ptr) panic_now = true;
                    if (fwd_fat && fp_page < fin.base_page) panic_now = true;
                    if (deref_beyond) panic_now = true;
                    if (!fwd_fat && fp_offset != 0) panic_now = true;
                    if (fp_offset > fp_length) panic_now = true;
                    if (panic_now) sub = 2;
                    if (sub == 2) {
                        // empty pointer; page stays 0 (no fwd resolution)
                        fp_offset = fp_page = fp_start = fp_length = 0;
                    } else {
                        if (fwd_fat) {
                            fp_start += fp_offset; fp_length -= fp_offset;
                            fp_offset = 0;
                        } else if (fwd_mode == 0) {
                            fp_page = fin.base_page + 2;
                        } else {
                            fp_page = fin.base_page + 3;
                        }
                    }
                    // growth payment (ret.rs:101-190)
                    if (!fwd_fat_orig) {
                        u64 upper = deref_beyond ? 0xFFFFFFFFull
                                                 : (u64)fp_start + fp_length;
                        u32 bound = fwd_mode_orig == 2 ? fin.aux_heap_bound
                                                       : fin.heap_bound;
                        u32 growth = upper > bound ? (u32)(upper - bound) : 0;
                        if (ergs_left >= growth) ergs_left -= growth;
                        else {
                            ergs_left = 0; sub = 2;
                            fp_offset = fp_page = fp_start = fp_length = 0;
                        }
                    }
                }
                bool panicked = sub >= 1;
                if (panicked) {
                    // storage value rollback (storage.rs:156-181) + event
                    // segment cancellation (event_sink.rs:154-175)
                    for (int j = j_count - 1; j >= (int)fin.j_snap; j--)
                        kv[journal[j].slot].val = journal[j].prev;
                    j_count = fin.j_snap;
                    for (int e = fin.ev_snap; e < ev_count; e++)
                        events[e].cancelled = true;
                }
                depth--;
                Frame &parent = frames[depth];
                parent.ergs += ergs_left;
                if (to_label && fin.is_local) parent.pc = imm0;
                else if (panicked) parent.pc = fin.eh;
                if (fin.is_local) {
                    parent.heap_bound = fin.heap_bound;
                    parent.aux_heap_bound = fin.aux_heap_bound;
                } else {
                    // register-file protocol (ret.rs:213-236)
                    for (int i = 0; i < 15; i++) regs[i] = Tagged{z256(), false};
                    U256 rd = z256();
                    rd.w[0] = (u64)fp_offset | ((u64)fp_page << 32);
                    rd.w[1] = (u64)fp_start | ((u64)fp_length << 32);
                    regs[0] = Tagged{rd, true};
                    ctx_reg_lo = ctx_reg_hi = 0;
                    last_frame_ergs = parent.ergs;
                    if (depth > 0 && !refresh_cache(parent)) {
                        status = ST_OOB; break;
                    }
                }
                if (sub == 2) f_lt = true;
                break;
            }
            case OP_UMA: {
                cur.pc = new_pc;
                u32 sub = pr.sub;
                bool is_ptr_read = sub == 4;
                bool is_aux = (sub == 2) || (sub == 3);
                bool is_write = (sub == 1) || (sub == 3);
                bool inc = pr.flag0;

                u32 exceptions = 0;
                bool skip_mem = false;
                if (is_ptr_read && !src0.ptr) exceptions |= 1;  // not ptr

                u32 fp_offset = (u32)src0.v.w[0];
                u32 fp_page = (u32)(src0.v.w[0] >> 32);
                u32 fp_start = (u32)src0.v.w[1];
                u32 fp_length = (u32)(src0.v.w[1] >> 32);
                u32 page; u8 mtype;
                if (is_ptr_read) {
                    page = fp_page; mtype = 3;
                    if (!(fp_offset < fp_length)) skip_mem = true;
                } else if (is_aux) {
                    page = cur.base_page + 3; mtype = 2;
                } else {
                    page = cur.base_page + 2; mtype = 1;
                }
                u64 src_offset = is_ptr_read
                    ? (u64)((fp_start + fp_offset) & 0xFFFFFFFFu)
                    : fp_offset;
                bool too_far = false;
                if (!is_ptr_read) {
                    too_far = (src0.v.w[0] >> 32) || src0.v.w[1]
                        || src0.v.w[2] || src0.v.w[3]
                        || fp_offset > MAX_OFFSET_TO_DEREF;
                    if (too_far) { exceptions |= 2; skip_mem = true; }
                }
                u64 incremented = (u64)fp_offset + 32;
                bool incr_of = incremented >> 32;
                incremented &= 0xFFFFFFFFull;
                if (incr_of) exceptions |= 4;

                u32 growth = 0;
                if (!is_ptr_read) {
                    u32 &bound = is_aux ? cur.aux_heap_bound : cur.heap_bound;
                    if ((u32)incremented > bound) {
                        growth = (u32)incremented - bound;
                        bound = (u32)incremented;
                    }
                }
                u64 cost = too_far ? 0xFFFFFFFFull : growth;
                if (cur.ergs >= cost) cur.ergs -= (u32)cost;
                else { cur.ergs = 0; exceptions |= 8; }
                bool set_panic = exceptions != 0;
                bool skip_access = skip_mem || set_panic;

                u32 w0i = (u32)(src_offset / 32), w1i = w0i + 1;
                u32 una = (u32)(src_offset % 32);
                U256 *arena; int arena_n;
                if (is_ptr_read) {
                    auto it = heap_pages.find(page);
                    if (it == heap_pages.end()) {
                        if (!skip_access) { status = ST_OOB; break; }
                        arena = nullptr; arena_n = 0;
                    } else {
                        arena = it->second.data();
                        arena_n = (int)it->second.size();
                    }
                } else {
                    arena = is_aux ? cur_aux : cur_heap;
                    arena_n = is_aux ? aux_words : heap_words;
                }
                U256 v0 = z256(), v1 = z256();
                if (!skip_access) {
                    // strict like the device arenas: word1 must fit even for
                    // aligned access (models/batched_vm.py hw_err/aw_err)
                    if ((int)w1i >= arena_n) { status = ST_OOB; break; }
                    v0 = arena[w0i];
                    if (una) v1 = arena[w1i];
                    wit.record(timestamp, mtype, page, w0i, v0, false, false);
                    if (una)
                        wit.record(timestamp, mtype, page, w1i, v1, false,
                                   false);
                }
                if (!is_write) {
                    U256 r = shl256(v0, una * 8);
                    if (una) r = or256(r, shr256(v1, (32 - una) * 8));
                    if (is_ptr_read) {
                        // zero-mask bytes beyond ptr.length (uma.rs:305-320)
                        long long beyond = (long long)incremented - fp_length;
                        if (beyond < 0 || skip_access) beyond = 0;
                        beyond %= 32;
                        if (beyond)
                            r = shl256(shr256(r, (unsigned)beyond * 8),
                                       (unsigned)beyond * 8);
                    }
                    if (!set_panic) {
                        dst0_write(r, false);
                        if (inc) {
                            U256 up = src0.v;
                            up.w[0] = (up.w[0] & ~0xFFFFFFFFull) | incremented;
                            write_reg(dst1_reg, up, src0.ptr);
                        }
                    } else {
                        pending_exc = true;
                    }
                } else {
                    U256 keep0 = una ? shl256(shr256(v0, (32 - una) * 8),
                                              (32 - una) * 8)
                                     : z256();
                    U256 n0 = or256(keep0, shr256(src1.v, una * 8));
                    if (!skip_access) {
                        arena[w0i] = n0;
                        wit.record(timestamp + 3, mtype, page, w0i, n0, false,
                                   true);
                        if (una) {
                            U256 keep1 = shr256(shl256(v1, una * 8), una * 8);
                            U256 n1 = or256(keep1, shl256(src1.v,
                                                          (32 - una) * 8));
                            arena[w1i] = n1;
                            wit.record(timestamp + 3, mtype, page, w1i, n1,
                                       false, true);
                        }
                    }
                    if (!set_panic) {
                        if (inc) {
                            U256 up = src0.v;
                            up.w[0] = (up.w[0] & ~0xFFFFFFFFull) | incremented;
                            dst0_write(up, false);
                        }
                    } else {
                        pending_exc = true;
                    }
                }
                break;
            }
            case OP_LOG: {
                cur.pc = new_pc;
                u32 sub = pr.sub;  // 0 sread 1 swrite 2 event 3 to_l1 4 pc
                bool is_first = pr.flag0;
                u32 ts_log = timestamp + 1;
                bool is_rollup = cur.this_shard == 0;
                u32 ergs_on_pubdata = 0;
                if (sub == 1 && is_rollup)
                    ergs_on_pubdata = ergs_per_pubdata * STORAGE_WRITE_PUBDATA;
                else if (sub == 3)
                    ergs_on_pubdata = ergs_per_pubdata * L1_MESSAGE_PUBDATA;
                u32 extra = (sub == 4)
                    ? (u32)(src1.v.w[0] & 0xFFFFFFFFull) : 0;
                u32 total_cost = ergs_on_pubdata + extra;
                bool log_ne = total_cost > cur.ergs;
                if (log_ne) {
                    spent_pubdata += cur.ergs < ergs_on_pubdata
                        ? cur.ergs : ergs_on_pubdata;
                    cur.ergs = 0;
                } else {
                    cur.ergs -= total_cost;
                    spent_pubdata += ergs_on_pubdata;
                }
                if (sub == 4) {
                    // Log.precompile (golden/vm.py PRECOMPILE_CALL +
                    // golden/precompiles.py keccak256/sha256; ecrecover
                    // stays unsupported in the native subset)
                    if (log_ne) { dst0_write(z256(), false); break; }
                    auto limb32 = [](const U256 &v, int k) -> u32 {
                        return (u32)(v.w[k / 2] >> (32 * (k % 2)));
                    };
                    u32 in_off = limb32(src0.v, 0);
                    u32 in_len = limb32(src0.v, 1);
                    u32 out_off = limb32(src0.v, 2);
                    u32 page_r = limb32(src0.v, 4);
                    u32 page_w = limb32(src0.v, 5);
                    u32 rounds = limb32(src0.v, 6);
                    if (page_r == 0) page_r = cur.base_page + 2;
                    if (page_w == 0) page_w = cur.base_page + 2;
                    U256 abi_key = src0.v;
                    abi_key.w[2] = (u64)page_r | ((u64)page_w << 32);
                    logw.record(ts_log, 4, cur.this_shard,
                                (is_first ? 4 : 0), tx_number,
                                cur.this_addr, abi_key, z256(), z256());
                    u64 addr_low = cur.this_addr & 0xFFFF;
                    bool is_keccak = addr_low == 0x8010;
                    bool is_sha = addr_low == 0x02;
                    bool is_ec = addr_low == 0x01;  // ECRECOVER_INNER
                    if (is_ec) {
                        // golden/precompiles.py ecrecover path: 4 input
                        // words (digest, v, r, s), 2 output words
                        // (ok flag, address)
                        auto itr = heap_pages.find(page_r);
                        auto itw = heap_pages.find(page_w);
                        if (itr == heap_pages.end()
                            || itw == heap_pages.end()) {
                            status = ST_OOB; break;
                        }
                        std::vector<U256> &rp = itr->second;
                        std::vector<U256> &wp = itw->second;
                        if ((u64)in_off + 3 >= rp.size()
                            || (u64)out_off + 1 >= wp.size()) {
                            status = ST_OOB; break;
                        }
                        U256 dg = rp[in_off];
                        u64 vbit = rp[in_off + 1].w[0] & 1;
                        U256 sig_r = rp[in_off + 2];
                        U256 sig_s = rp[in_off + 3];
                        U256 rec = z256();
                        bool ok = ecrecover_native(dg, vbit, sig_r, sig_s,
                                                   rec);
                        U256 okw = z256(); okw.w[0] = ok ? 1 : 0;
                        wp[out_off] = okw;
                        wp[out_off + 1] = ok ? rec : z256();
                        U256 one = z256(); one.w[0] = 1;
                        dst0_write(one, false);
                        break;
                    }
                    if (is_keccak || is_sha) {
                        auto itr = heap_pages.find(page_r);
                        auto itw = heap_pages.find(page_w);
                        if (itr == heap_pages.end()
                            || itw == heap_pages.end()) {
                            status = ST_OOB; break;
                        }
                        std::vector<U256> &rp = itr->second;
                        std::vector<U256> &wp = itw->second;
                        U256 out_word = z256();
                        bool oob = false;
                        auto read_word = [&](u32 w, u8 *dst) {
                            if (w >= rp.size()) { oob = true; return; }
                            to_be_bytes(rp[w], dst);
                        };
                        if (is_keccak) {
                            std::vector<u8> data;
                            if (in_len) {
                                u32 fw = in_off / 32;
                                u32 lw = (in_off + in_len - 1) / 32;
                                std::vector<u8> raw((lw - fw + 1) * 32);
                                for (u32 w = fw; w <= lw && !oob; w++)
                                    read_word(w, raw.data()
                                              + (size_t)(w - fw) * 32);
                                if (oob) { status = ST_OOB; break; }
                                u32 start = in_off - fw * 32;
                                data.assign(raw.begin() + start,
                                            raw.begin() + start + in_len);
                            }
                            u8 digest[32];
                            keccak256(data.data(), data.size(), digest);
                            out_word = from_be_bytes(digest);
                        } else {
                            u32 st8[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                          0xa54ff53a, 0x510e527f, 0x9b05688c,
                                          0x1f83d9ab, 0x5be0cd19};
                            for (u32 r = 0; r < rounds && !oob; r++) {
                                u8 blk[64];
                                read_word(in_off + 2 * r, blk);
                                read_word(in_off + 2 * r + 1, blk + 32);
                                if (!oob) sha256_compress(st8, blk);
                            }
                            if (oob) { status = ST_OOB; break; }
                            u8 be[32];
                            for (int i = 0; i < 8; i++) {
                                be[4 * i] = (u8)(st8[i] >> 24);
                                be[4 * i + 1] = (u8)(st8[i] >> 16);
                                be[4 * i + 2] = (u8)(st8[i] >> 8);
                                be[4 * i + 3] = (u8)st8[i];
                            }
                            out_word = from_be_bytes(be);
                        }
                        if (out_off >= wp.size()) { status = ST_OOB; break; }
                        wp[out_off] = out_word;
                    }
                    U256 one = z256(); one.w[0] = 1;
                    dst0_write(one, false);
                    break;
                }
                if (sub == 0 || sub == 1) {
                    if (sub == 1 && log_ne) break;  // early return, no query
                    int s = find_slot(src0.v, cur.this_addr);
                    U256 current = (s >= 0) ? kv[s].val : z256();
                    if (sub == 1) {
                        if (s < 0) {
                            if (kv_count >= KV_CAP) { status = ST_OOB; break; }
                            s = kv_count++;
                            kv[s] = KV{src0.v, cur.this_addr, z256(), true};
                        }
                        if (j_count >= J_CAP) { status = ST_OOB; break; }
                        journal[j_count++] = JEntry{s, current};
                        kv[s].val = src1.v;
                        logw.record(ts_log, 0, cur.this_shard,
                                    1 | (is_first ? 4 : 0), tx_number,
                                    cur.this_addr, src0.v, current, src1.v);
                    } else {
                        logw.record(ts_log, 0, cur.this_shard,
                                    (is_first ? 4 : 0), tx_number,
                                    cur.this_addr, src0.v, current, current);
                        dst0_write(current, false);
                    }
                } else {
                    if (log_ne) break;  // to_l1 out-of-pubdata early return
                    if (ev_count >= EV_CAP) { status = ST_OOB; break; }
                    u8 aux = (sub == 2) ? 2 : 3;
                    events[ev_count++] = Event{src0.v, src1.v, ts_log, aux,
                                               is_first, tx_number, false};
                    logw.record(ts_log, aux, cur.this_shard,
                                1 | (is_first ? 4 : 0), tx_number,
                                cur.this_addr, src0.v, z256(), src1.v);
                }
                break;
            }
            default:
                status = ST_UNSUPPORTED;
                break;
        }
        if (status != ST_MAX_CYCLES) { cycle++; break; }
        timestamp += TIME_DELTA;
    }

    if (depth == 0 && status == ST_MAX_CYCLES) status = ST_DONE;

    if (regs_out)
        for (int i = 0; i < 15; i++) to_be_bytes(regs[i].v, regs_out + i * 32);
    if (reg_ptr_out)
        for (int i = 0; i < 15; i++) reg_ptr_out[i] = regs[i].ptr;
    if (heap_out)
        for (int i = 0; i < heap_words; i++)
            to_be_bytes(entry_heap[i], heap_out + (size_t)i * 32);
    if (witness_count) *witness_count = wit.count;
    if (log_count) *log_count = logw.count;
    if (dec_count) *dec_count = decw.count;
    if (storage_count) {
        int n = 0;
        for (int i = 0; i < kv_count && storage_buf && n < storage_cap; i++) {
            if (!kv[i].used) continue;
            u8 *r = storage_buf + (size_t)n * 96;
            memset(r, 0, 96);
            for (int j = 0; j < 8; j++)
                r[24 + j] = (u8)(kv[i].addr >> (56 - 8 * j));
            to_be_bytes(kv[i].key, r + 32);
            to_be_bytes(kv[i].val, r + 64);
            n++;
        }
        *storage_count = n;
    }
    if (events_count) {
        int n = 0;
        for (int i = 0; i < ev_count && events_buf && n < events_cap; i++) {
            if (events[i].cancelled) continue;
            u8 *r = events_buf + (size_t)n * 72;
            memset(r, 0, 72);
            r[0] = events[i].aux; r[1] = events[i].first;
            r[2] = (u8)(events[i].ts >> 24); r[3] = (u8)(events[i].ts >> 16);
            r[4] = (u8)(events[i].ts >> 8); r[5] = (u8)events[i].ts;
            r[6] = (u8)(events[i].tx >> 8); r[7] = (u8)events[i].tx;
            to_be_bytes(events[i].key, r + 8);
            to_be_bytes(events[i].val, r + 40);
            n++;
        }
        *events_count = n;
    }
    if (cycles_out) *cycles_out = cycle;
    if (flags_out) *flags_out = (f_lt ? 1 : 0) | (f_eq ? 2 : 0) | (f_gt ? 4 : 0);
    if (entry_ergs_out) *entry_ergs_out = last_frame_ergs;

    delete[] frames;
    return status;
}
