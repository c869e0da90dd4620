"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources are `csrc/*.cu` and `csrc/*.cuh` of this package, plus one
header generated from the port's `isa` package (decode constants, opcode and
operand-mode values, ergs prices, callstack field indices, precompile
addresses) and from the constants of `ops/keccak.py`, `ops/sha256.py` and
`ops/secp256k1.py`, so no such constant is written by hand in the kernels.
The shared library goes to
`era_zk_evm_tpu_torch/_build/<kind>-<hash>/`, keyed by a hash of the
sources, the flags and the generated header; a build or load failure
raises.  nvcc compiles each source into an object file, all at once in
parallel, then links them.  `build_hooked()` builds K1 alone with its
development hooks (models/fused_cycle.py: DEBUG_SKIP, DEBUG_STAGE,
DEBUG_PASSTHROUGH) as -D flags, a library for each set, for timing only.
`build_host()` compiles the same per-lane bodies with g++ for
checking them on a machine without CUDA; no runtime path uses it.

Nothing here runs at import time: `load()` builds on first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O1", "-fPIC"]
#: K1's sources: its instances, and the ecrecover instance's own
K1_SOURCES = ("cycle_kernel.cu", "cycle_kernel_ec.cu")
SOURCES = K1_SOURCES + (
    "rolling_fold.cu", "keccak_f.cu", "keccak_sponge.cu", "probe_keccak.cu",
    "probe_rate.cu", "probe_uniform.cu", "bisect_fold.cu", "pq_splice.cu")


def generate_header() -> str:
    """The text of `eravm_gen.h`, from the port's ISA layer."""
    from .config import CS_SCALAR_FIELDS, SLOTS_PER_CYCLE
    from .isa import params
    from .isa.encoding import VARIANT_MASK, exception_revert_encoding
    from .isa.opcodes import (
        ContextOp, FarCallOp, LogOp, Opcode, OperandMode, PtrOp, RetOp,
        ShiftOp, UMAOp, decode_consts,
    )
    from .isa.abi import PrecompileCallABI
    from .models.fused_cycle import K1_PASSTHROUGH_BITS, K1_SKIP_BITS
    from .ops import secp256k1 as secp
    from .ops.keccak import KECCAK_RC, KECCAK_ROTATIONS
    from .ops.sha256 import SHA256_IV, SHA256_K

    out = ["// generated by era_zk_evm_tpu_torch/_build.py — do not edit",
           "#pragma once", "#include <cstdint>", ""]

    def define(name, value):
        out.append(f"#define {name} {int(value)}u")

    for prefix, enum in (("OP", Opcode), ("CTX", ContextOp),
                         ("SHIFT", ShiftOp), ("PTR", PtrOp), ("RET", RetOp),
                         ("UMA", UMAOp), ("LOG", LogOp), ("FAR", FarCallOp),
                         ("MODE", OperandMode)):
        for member in enum:
            define(f"{prefix}_{member.name}", member.value)
    for name in ("REGISTERS_COUNT", "TIME_DELTA_PER_CYCLE",
                 "VM_MAX_STACK_DEPTH", "MAX_OFFSET_TO_DEREF",
                 "MEMORY_GROWTH_ERGS_PER_BYTE", "KERNEL_SPACE_BOUND",
                 "RICH_ADDRESSING_OPCODE_ERGS", "AVERAGE_OPCODE_ERGS",
                 "NEAR_CALL_ERGS", "FAR_CALL_ERGS", "RET_ERGS", "UMA_ERGS",
                 "INVALID_OPCODE_ERGS", "STORAGE_READ_IO_PRICE",
                 "STORAGE_WRITE_IO_PRICE", "EVENT_IO_PRICE",
                 "L1_MESSAGE_IO_PRICE", "PRECOMPILE_CALL_BASE_PRICE",
                 "INITIAL_STORAGE_WRITE_PUBDATA_BYTES",
                 "L1_MESSAGE_PUBDATA_BYTES", "EVENT_AUX_BYTE",
                 "L1_MESSAGE_AUX_BYTE", "STORAGE_AUX_BYTE",
                 "PRECOMPILE_AUX_BYTE", "DEPLOYER_SYSTEM_CONTRACT_ADDRESS",
                 "CODE_HASH_VERSION_BYTE", "CODE_AT_REST_MARKER",
                 "YET_CONSTRUCTED_MARKER", "ERGS_PER_CODE_WORD_DECOMMITTMENT",
                 "UNMAPPED_PAGE", "INITIAL_SP_ON_FAR_CALL",
                 "NEW_FRAME_MEMORY_STIPEND",
                 "NEW_MEMORY_PAGES_PER_FAR_CALL",
                 "KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS",
                 "SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS",
                 "ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS"):
        define(name, getattr(params, name))
    # the precompile-call ABI: the u32 limb of src0 that holds each field
    for name, field in (("IN_OFF", "input_memory_offset"),
                        ("IN_LEN", "input_memory_length"),
                        ("OUT_OFF", "output_memory_offset"),
                        ("PAGE_R", "memory_page_to_read"),
                        ("PAGE_W", "memory_page_to_write"),
                        ("ROUNDS", "precompile_interpreted_data")):
        bit = PrecompileCallABI(**{field: 1}).to_u256().bit_length() - 1
        define(f"PP_ABI_{name}", bit // 32)
    define("VARIANT_MASK", VARIANT_MASK)
    enc = exception_revert_encoding()
    define("PANIC_LO", enc & 0xFFFFFFFF)
    define("PANIC_HI", enc >> 32)
    define("SLOTS_PER_CYCLE", SLOTS_PER_CYCLE)
    define("NF", len(CS_SCALAR_FIELDS))
    for i, name in enumerate(CS_SCALAR_FIELDS):
        define(f"CS_{name.upper()}", i)
    # K1's development hooks' bits (models/fused_cycle.py)
    for prefix, bits in (("K1_SKIP", K1_SKIP_BITS),
                         ("K1_PASS", K1_PASSTHROUGH_BITS)):
        for name, bit in bits.items():
            define(f"{prefix}_{name.upper()}", bit)
    out.append("")
    for name, arr in decode_consts().items():
        vals = ", ".join(f"{int(v)}u" for v in arr)
        out.append(f"EVM_TABLE uint32_t DC_{name.upper()}[{len(arr)}] = "
                   f"{{{vals}}};")
    rc = ", ".join(f"0x{c:016x}ull" for c in KECCAK_RC)
    out.append(f"EVM_TABLE uint64_t KECCAK_RC[{len(KECCAK_RC)}] = {{{rc}}};")
    # the rho offsets as a constant expression of the lane index, which
    # folds to an immediate where the index is a constant (keccak.cuh's
    # round); a __constant__ table load does not
    sel = "".join(f"(i) == {i} ? {r} : "
                  for i, r in enumerate(KECCAK_ROTATIONS[:-1]))
    out.append(f"#define KECCAK_ROT_C(i) ({sel}{KECCAK_ROTATIONS[-1]})")
    p, n = secp.P_INT, secp.N_INT
    tables = [("SHA256_K", SHA256_K), ("SHA256_IV", SHA256_IV)] + [
        (name, secp.to_limbs(value)) for name, value in (
            ("SECP_P", p), ("SECP_N", n), ("SECP_FOLD_P", 2**256 - p),
            ("SECP_FOLD_N", 2**256 - n), ("SECP_GX", secp.GX_INT),
            ("SECP_GY", secp.GY_INT))]
    for name, arr in tables:
        vals = ", ".join(f"0x{v:08x}u" for v in arr)
        out.append(f"EVM_TABLE uint32_t {name}[{len(arr)}] = {{{vals}}};")
    out += _secp_header()
    return "\n".join(out) + "\n"


#: the signed-digit windows of the ecrecover unit's scalar multiplication:
#: 4 bits for R and lambda R (a table of 8 points built per lane), 5 bits
#: for G and lambda G (16 points each, here); every half-scalar of the
#: endomorphism split is held under 2**SECP_SPLIT_BITS
SECP_WINDOW_R, SECP_WINDOW_G, SECP_SPLIT_BITS = 4, 5, 130


@functools.lru_cache(maxsize=None)
def secp_glv() -> dict:
    """The secp256k1 endomorphism and its lattice split, from the curve's
    Python ints: lam (a cube root of 1 mod n) and beta (one mod p) with
    lam * G = (beta * Gx, Gy); the short basis (a1, b1), (a2, b2) of {(x, y):
    x + y lam = 0 mod n} by the extended Euclidean algorithm on (n, lam); and
    g1 = round(2**384 b2 / n), g2 = round(-2**384 b1 / n), so that
    c1 = round(k g1 / 2**384), c2 = round(k g2 / 2**384) give the halves
    k1 = k - c1 a1 - c2 a2 and k2 = -c1 b1 - c2 b2, k = k1 + k2 lam mod n."""
    from .ops import secp256k1 as secp

    p, n, g = secp.P_INT, secp.N_INT, (secp.GX_INT, secp.GY_INT)

    def cube_roots(m):
        for base in range(2, 64):
            c = pow(base, (m - 1) // 3, m)
            if c != 1:
                return (c, c * c % m)
        raise AssertionError("no cube root of unity")

    def split(lam, beta):
        rs, ts = [n, lam], [0, 1]
        while rs[-1]:
            q = rs[-2] // rs[-1]
            rs.append(rs[-2] - q * rs[-1])
            ts.append(ts[-2] - q * ts[-1])
        last = max(i for i, r in enumerate(rs) if r * r >= n)
        a1, b1 = rs[last + 1], -ts[last + 1]
        a2, b2 = min(((rs[last], -ts[last]), (rs[last + 2], -ts[last + 2])),
                     key=lambda v: v[0] ** 2 + v[1] ** 2)
        return {"lam": lam, "beta": beta, "a1": a1, "b1": b1, "a2": a2,
                "b2": b2, "g1": (2**384 * b2 + n // 2) // n,
                "g2": (-(2**384) * b1 + n // 2) // n}

    # of the two (lam, beta) pairs, the one whose constants are all u256
    # (b1 < 0 < b2)
    return next(c for c in (split(lam, beta) for lam in cube_roots(n)
                            for beta in cube_roots(p)
                            if secp.ec_mul(lam, g) == (beta * g[0] % p, g[1]))
                if c["b1"] < 0 < c["b2"] and max(c["g1"], c["g2"]) < 2**256)


def secp_digits(window: int) -> int:
    """Digits of the regular signed recoding of an odd scalar under
    2**SECP_SPLIT_BITS: the fewest whose top digit 2 (k >> (w (m - 1) + 1))
    + 1 stays under 2**w."""
    m = 1
    while 2 * ((2**SECP_SPLIT_BITS - 1) >> (window * (m - 1) + 1)) + 1 \
            >= 2**window:
        m += 1
    return m


def pow_chain(e: int) -> tuple[list, list, int]:
    """A fixed addition chain for x ** e, from e's runs of ones: x_L =
    x ** (2**L - 1) for every run length L, each built as x_L = x_a ** (2**b)
    x_b from two built lengths (or by halving), then one step acc = acc **
    (2**s) x_L a run.  Returns (builds (L, a, b), runs (zeros before, L)
    MSB first, trailing zeros)."""
    bits = bin(e)[2:]
    runs = [(len(z), len(o)) for z, o in re.findall(r"(0*)(1+)", bits)]
    tail = len(bits) - len(bits.rstrip("0"))
    built, builds = {1}, []

    def build(length):
        if length in built:
            return
        pair = next((b for b in sorted(built, reverse=True)
                     if b < length and length - b in built), None)
        if pair is not None:
            builds.append((length, length - pair, pair))
        elif length % 2 == 0:
            build(length // 2)
            builds.append((length, length // 2, length // 2))
        else:
            build(length - 1)
            builds.append((length, length - 1, 1))
        built.add(length)

    for length in sorted({r for _, r in runs}):
        build(length)
    return builds, runs, tail


def _chain_macro(name: str, e: int) -> str:
    """`#define name(SQM, SQ)`: the statements of x ** e from `x1`, with
    SQM(a, s, b) = a ** (2**s) * b and SQ(a, s) = a ** (2**s)."""
    builds, runs, tail = pow_chain(e)
    body = [f"const U256 x{a + b} = SQM(x{a}, {b}, x{b});"
            for _, a, b in builds]
    body.append(f"U256 acc = x{runs[0][1]};")
    body += [f"acc = SQM(acc, {z + r}, x{r});" for z, r in runs[1:]]
    if tail:
        body.append(f"acc = SQ(acc, {tail});")
    body.append("return acc;")
    return f"#define {name}(SQM, SQ) " + " ".join(body)


def _secp_header() -> list[str]:
    """The ecrecover unit's generated constants: the endomorphism's beta,
    the split's constants, G's and lambda G's tables of odd multiples, the
    windows and the addition chains of the three fixed powers."""
    from .golden.precompiles import _ec_add
    from .ops import secp256k1 as secp

    p, n = secp.P_INT, secp.N_INT
    glv = secp_glv()
    out = []
    for name, value in (("SECP_BETA", glv["beta"]), ("SECP_G1", glv["g1"]),
                        ("SECP_G2", glv["g2"]), ("SECP_A1", glv["a1"]),
                        ("SECP_A2", glv["a2"]), ("SECP_MINUS_B1", -glv["b1"]),
                        ("SECP_B2", glv["b2"])):
        assert 0 <= value < 2**256
        vals = ", ".join(f"0x{v:08x}u" for v in secp.to_limbs(value))
        out.append(f"EVM_TABLE uint32_t {name}[8] = {{{vals}}};")
    # odd multiples 1, 3, .. 2**(w - 1) - 1 of G, then of lambda G: x, y
    g = (secp.GX_INT, secp.GY_INT)
    g2 = secp.ec_mul(2, g)
    mult, rows = g, []
    for _ in range(2 ** (SECP_WINDOW_G - 1)):
        rows.append(mult)
        mult = _ec_add(mult, g2)
    words = [w for x, y in rows for w in secp.to_limbs(x) + secp.to_limbs(y)]
    words += [w for x, y in rows
              for w in secp.to_limbs(glv["beta"] * x % p) + secp.to_limbs(y)]
    vals = ", ".join(f"0x{v:08x}u" for v in words)
    out.append(f"EVM_GTABLE uint32_t SECP_GTAB[{len(words)}] = {{{vals}}};")
    # the top digit's bit position: the multiplication's doublings
    top = max(w * (secp_digits(w) - 1) for w in (SECP_WINDOW_R, SECP_WINDOW_G))
    for name, value in (("SECP_WR", SECP_WINDOW_R), ("SECP_WG", SECP_WINDOW_G),
                        ("SECP_DIGITS_R", secp_digits(SECP_WINDOW_R)),
                        ("SECP_DIGITS_G", secp_digits(SECP_WINDOW_G)),
                        ("SECP_TOP_POS", top)):
        out.append(f"#define {name} {value}")
    out += [_chain_macro("SECP_CHAIN_SQRT", (p + 1) // 4),
            _chain_macro("SECP_CHAIN_P_INV", p - 2),
            _chain_macro("SECP_CHAIN_N_INV", n - 2)]
    return out


def _key(header: str, flags: list[str]) -> str:
    h = hashlib.sha256(header.encode())
    h.update(" ".join(flags).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


_LIB = None
_HOST_LIBS = {}
_HOOKED_LIBS = {}


def _start(kind: str, compiler: str, flags: list[str],
           sources: tuple[str, ...], lib_name: str):
    """Start compiling `sources` into `_build/<kind>-<hash>/<lib_name>`, one
    compiler process per source, unless that library exists; `_finish`
    waits, links and returns its path."""
    header = generate_header()
    out_dir = BUILD_ROOT / f"{kind}-{_key(header, flags)}"
    lib = out_dir / lib_name
    if lib.exists():
        return lib, None
    BUILD_ROOT.mkdir(exist_ok=True)
    # build in a private directory, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    (tmp / "eravm_gen.h").write_text(header)
    objects = [tmp / (pathlib.Path(s).stem + ".o") for s in sources]
    procs = [subprocess.Popen(
        [compiler, *flags, "-c", "-I", str(tmp), "-I", str(CSRC),
         "-o", str(obj), str(CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objects)]
    return lib, (compiler, sources, tmp, objects, procs)


def _finish(lib: pathlib.Path, job) -> pathlib.Path:
    """Wait for `_start`'s compilers, link, and move the library to its
    directory; the compilers' output goes beside it in `build.log`; raise
    on failure."""
    if job is None:
        return lib
    compiler, sources, tmp, objects, procs = job
    out_dir, lib_name = lib.parent, lib.name
    outputs = [proc.communicate()[0] for proc in procs]
    log = "".join(outputs)
    failed = [src for src, proc in zip(sources, procs) if proc.returncode]
    if not failed:
        link = subprocess.run(
            [compiler, "-shared", "-o", str(tmp / lib_name),
             *map(str, objects)], capture_output=True, text=True)
        log += link.stdout + link.stderr
        failed = ["link"] if link.returncode else []
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"{compiler} failed on {failed}:\n{log}")
    (tmp / "build.log").write_text(log)
    try:
        tmp.rename(out_dir)
    except OSError:
        if not lib.exists():
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _compile(kind: str, compiler: str, flags: list[str],
             sources: tuple[str, ...], lib_name: str) -> pathlib.Path:
    """Compile `sources` into `_build/<kind>-<hash>/<lib_name>` once per
    source hash: one compiler process per source, all started together, then
    one link (`_start`, `_finish`)."""
    return _finish(*_start(kind, compiler, flags, sources, lib_name))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return nvcc


def build() -> pathlib.Path:
    """Compile the CUDA kernels with nvcc; return the library path."""
    return _compile("cuda", _nvcc(), NVCC_FLAGS, SOURCES,
                    "liberavm_kernels.so")


def build_hooked(variants: list[list[str]]) -> list[pathlib.Path]:
    """K1's hooked libraries (dev-only), one for each list of -D flags
    (`models/fused_cycle.k1_hook_flags`), from K1's sources alone: every
    variant's nvcc processes started together, so that a group of variants
    costs about one build's time; each library in `_build/k1hook-<hash>/`,
    keyed by its flags."""
    nvcc = _nvcc()
    jobs = [_start("k1hook", nvcc, NVCC_FLAGS + list(flags), K1_SOURCES,
                   "liberavm_k1.so") for flags in variants]
    # wait for every variant's compilers before raising a failure
    paths, errors = [], []
    for job in jobs:
        try:
            paths.append(_finish(*job))
        except RuntimeError as exc:
            errors.append(exc)
    if errors:
        raise errors[0]
    return paths


def build_host(hooks: bool = False) -> pathlib.Path:
    """Compile the kernels' per-lane bodies with the host C++ compiler, for
    checking their logic without a card (csrc/host_entry.cpp); with
    `hooks`, K1's development hooks set at run time
    (`eravm_k1_hooks_host`)."""
    return _compile("host", "g++",
                    HOST_FLAGS + ["-DK1_HOOKS_HOST"] * hooks,
                    ("host_entry.cpp",), "liberavm_kernels_host.so")


class K1Args(ctypes.Structure):
    """Mirror of `struct K1Args` in csrc/cycle_kernel.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "regs", "reg_ptr", "flags", "timestamp", "mcc", "ergs_per_pubdata",
        "tx_number", "pending", "prev_code_word", "prev_super_pc",
        "prev_code_page", "context_u128", "depth", "cs_this", "cs_sender",
        "cs_code_addr", "cs_u128", "cs_scalars", "code", "stack",
        "stack_tag", "heap", "aux_heap", "hp_page", "ap_page", "cb_page",
        "cb_valid", "j_count", "ev_count", "spent_pubdata", "st_key",
        "st_val", "st_used", "st_count", "j_slot", "j_prev", "ev_key",
        "ev_val", "ev_meta", "ev_cancelled", "lq_meta", "lq_addr", "lq_key",
        "lq_read", "lq_written", "lq_count", "dq_hash", "dq_meta", "dq_count",
        "cb_hash", "default_aa_hash", "frame_count", "page_counter", "done",
        "lane_error", "global_step", "wq_count", "q_meta", "q_value",
        "q_flags", "blk_meta", "blk_value", "blk_flags", "blk_count", "step0",
        "pq_meta_blk", "pq_value_blk", "pq_flags_blk", "pq_emit_blk",
        "pq_nslots_blk",
    )] + [(name, ctypes.c_int) for name in (
        "batch", "max_depth", "code_words", "code_pages", "stack_words",
        "stack_abs_words", "stack_sp_base", "heap_words", "aux_heap_words",
        "heap_frames", "queue_capacity", "storage_slots", "journal_slots",
        "event_slots", "log_queue_capacity", "decommit_queue_capacity",
        "emit_queue", "emit_block", "k_cycles", "k_stop", "keccak_blocks",
        "sha_rounds", "pq_slots_in", "pq_capacity",
    )]


class SpliceArgs(ctypes.Structure):
    """Mirror of `struct SpliceArgs` in csrc/pq_splice.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "meta_blk", "value_blk", "flags_blk", "emit", "nslots", "pq_meta",
        "pq_value", "pq_flags", "pq_count", "pq_blocks", "lane_error",
        "scratch",
    )] + [(name, ctypes.c_int) for name in ("n", "ps", "ps_in", "cap",
                                            "batch")]


class UnitsArgs(ctypes.Structure):
    """Mirror of `struct UnitsArgs` in csrc/cycle_kernel.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "arena", "call", "out", "err",
    )] + [(name, ctypes.c_int) for name in (
        "n", "n_words", "keccak_blocks", "sha_rounds", "ps_in",
    )]


#: the probes' C entries, eravm_<probe>_launch and eravm_<probe>_host: their
#: arguments ("p" a pointer, "i" an int) before the launchers' stream
_PROBE_LAUNCH = {"p1": "piiii", "p2": "piii", "p3": "piiii", "p4": "pii",
                 "p6": "pppiiiiiii", "p6w": "pppiiiiii", "p6c": "pppiii",
                 "p6_empty": "", "p7": "ppiii"}
_PROBE_HOST = {"p1": "piii", "p2": "piii", "p2_rho": "p", "p3": "piiii",
               "p4": "pii", "p6": "pppiiiiii", "p6w": "pppiiiii",
               "p6c": "pppiii", "p7": "ppiii"}


def _bind_probes(lib: ctypes.CDLL, kind: str, specs: dict) -> None:
    for name, spec in specs.items():
        fn = getattr(lib, f"eravm_{name}_{kind}")
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in spec] + [ctypes.c_void_p] * (kind == "launch")
        fn.restype = ctypes.c_int


def _bind_k1(lib: ctypes.CDLL) -> None:
    lib.eravm_k1_launch.argtypes = [ctypes.POINTER(K1Args), ctypes.c_int,
                                    ctypes.c_void_p]
    lib.eravm_k1_launch.restype = ctypes.c_int
    lib.eravm_k1_threads.argtypes = [ctypes.c_int]
    lib.eravm_k1_threads.restype = ctypes.c_int


def load_hooked(flags: list[str]) -> ctypes.CDLL:
    """Build if needed and load K1's hooked library for these -D flags
    (`build_hooked`; once per process and flags)."""
    key = tuple(flags)
    if key not in _HOOKED_LIBS:
        lib = ctypes.CDLL(str(build_hooked([list(flags)])[0]))
        _bind_k1(lib)
        _HOOKED_LIBS[key] = lib
    return _HOOKED_LIBS[key]


def load() -> ctypes.CDLL:
    """Build if needed and load the CUDA kernels' library (once per
    process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _bind_k1(lib)
        lib.eravm_k2_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.eravm_k2_launch.restype = ctypes.c_int
        lib.eravm_k3_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.eravm_k3_launch.restype = ctypes.c_int
        lib.eravm_k3s_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.eravm_k3s_launch.restype = ctypes.c_int
        lib.eravm_pq_splice_launch.argtypes = [ctypes.POINTER(SpliceArgs),
                                               ctypes.c_void_p]
        lib.eravm_pq_splice_launch.restype = ctypes.c_int
        lib.eravm_pq_splice_scratch.argtypes = [ctypes.c_int] * 3
        lib.eravm_pq_splice_scratch.restype = ctypes.c_int
        lib.eravm_ecrecover_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.eravm_ecrecover_launch.restype = ctypes.c_int
        lib.eravm_units_launch.argtypes = [ctypes.POINTER(UnitsArgs),
                                           ctypes.c_void_p]
        lib.eravm_units_launch.restype = ctypes.c_int
        _bind_probes(lib, "launch", _PROBE_LAUNCH)
        lib.eravm_p3_unroll.argtypes = []
        lib.eravm_p3_unroll.restype = ctypes.c_int
        lib.eravm_p2_warps_per_sm.argtypes = [ctypes.c_int]
        lib.eravm_p2_warps_per_sm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def load_host(hooks: bool = False) -> ctypes.CDLL:
    """Build if needed and load the host build (once per process), with
    `hooks` the one whose K1 hooks `eravm_k1_hooks_host(skip, stage, pass)`
    sets."""
    if hooks not in _HOST_LIBS:
        lib = ctypes.CDLL(str(build_host(hooks)))
        lib.eravm_k1_host.argtypes = [ctypes.POINTER(K1Args), ctypes.c_int]
        lib.eravm_k1_host.restype = ctypes.c_int
        lib.eravm_k2_host.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int]
        lib.eravm_k2_host.restype = ctypes.c_int
        lib.eravm_k3_host.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
        lib.eravm_k3_host.restype = ctypes.c_int
        lib.eravm_perm_host.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.eravm_perm_host.restype = ctypes.c_int
        lib.eravm_k3s_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        lib.eravm_k3s_host.restype = ctypes.c_int
        lib.eravm_ecrecover_host.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int]
        lib.eravm_ecrecover_host.restype = ctypes.c_int
        lib.eravm_units_host.argtypes = [ctypes.POINTER(UnitsArgs)]
        lib.eravm_units_host.restype = ctypes.c_int
        lib.eravm_fe_host.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int]
        lib.eravm_fe_host.restype = ctypes.c_int
        lib.eravm_secp_split_host.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int]
        lib.eravm_secp_split_host.restype = ctypes.c_int
        lib.eravm_pq_splice_host.argtypes = [ctypes.POINTER(SpliceArgs)]
        lib.eravm_pq_splice_host.restype = ctypes.c_int
        lib.eravm_pq_splice_scratch.argtypes = [ctypes.c_int] * 3
        lib.eravm_pq_splice_scratch.restype = ctypes.c_int
        _bind_probes(lib, "host", _PROBE_HOST)
        if hooks:
            lib.eravm_k1_hooks_host.argtypes = [ctypes.c_uint, ctypes.c_int,
                                                ctypes.c_uint]
            lib.eravm_k1_hooks_host.restype = ctypes.c_int
        _HOST_LIBS[hooks] = lib
    return _HOST_LIBS[hooks]
