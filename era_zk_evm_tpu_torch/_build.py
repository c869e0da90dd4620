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
parallel, then links them.  `build_host()` compiles the same per-lane bodies with g++ for
checking them on a machine without CUDA; no runtime path uses it.

Nothing here runs at import time: `load()` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O1", "-fPIC"]
SOURCES = ("cycle_kernel.cu", "cycle_kernel_ec.cu", "rolling_fold.cu",
           "keccak_f.cu", "probe_keccak.cu", "probe_rate.cu",
           "probe_uniform.cu", "bisect_fold.cu")


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
    out.append("")
    for name, arr in decode_consts().items():
        vals = ", ".join(f"{int(v)}u" for v in arr)
        out.append(f"EVM_TABLE uint32_t DC_{name.upper()}[{len(arr)}] = "
                   f"{{{vals}}};")
    rc = ", ".join(f"0x{c:016x}ull" for c in KECCAK_RC)
    out.append(f"EVM_TABLE uint64_t KECCAK_RC[{len(KECCAK_RC)}] = {{{rc}}};")
    rot = ", ".join(str(r) for r in KECCAK_ROTATIONS)
    out.append(f"EVM_TABLE int KECCAK_ROT[25] = {{{rot}}};")
    p, n = secp.P_INT, secp.N_INT
    tables = [("SHA256_K", SHA256_K), ("SHA256_IV", SHA256_IV)] + [
        (name, secp.to_limbs(value)) for name, value in (
            ("SECP_P", p), ("SECP_N", n), ("SECP_FOLD_P", 2**256 - p),
            ("SECP_FOLD_N", 2**256 - n), ("SECP_GX", secp.GX_INT),
            ("SECP_GY", secp.GY_INT), ("SECP_SQRT_EXP", (p + 1) // 4),
            ("SECP_P_MINUS_2", p - 2), ("SECP_N_MINUS_2", n - 2))]
    for name, arr in tables:
        vals = ", ".join(f"0x{v:08x}u" for v in arr)
        out.append(f"EVM_TABLE uint32_t {name}[{len(arr)}] = {{{vals}}};")
    return "\n".join(out) + "\n"


def _key(header: str, flags: list[str]) -> str:
    h = hashlib.sha256(header.encode())
    h.update(" ".join(flags).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


_LIB = None
_HOST_LIB = None


def _compile(kind: str, compiler: str, flags: list[str],
             sources: tuple[str, ...], lib_name: str) -> pathlib.Path:
    """Compile `sources` into `_build/<kind>-<hash>/<lib_name>` once per
    source hash: one compiler process per source, all started together, then
    one link.  The compilers' output goes beside it in `build.log`; raise on
    failure."""
    header = generate_header()
    out_dir = BUILD_ROOT / f"{kind}-{_key(header, flags)}"
    lib = out_dir / lib_name
    if lib.exists():
        return lib
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


def build() -> pathlib.Path:
    """Compile the CUDA kernels with nvcc; return the library path."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return _compile("cuda", nvcc, NVCC_FLAGS, SOURCES, "liberavm_kernels.so")


def build_host() -> pathlib.Path:
    """Compile the kernels' per-lane bodies with the host C++ compiler, for
    checking their logic without a card (csrc/host_entry.cpp)."""
    return _compile("host", "g++", HOST_FLAGS, ("host_entry.cpp",),
                    "liberavm_kernels_host.so")


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
        "q_flags", "step0", "pq_meta_blk", "pq_value_blk", "pq_flags_blk",
        "pq_emit_blk", "pq_nslots_blk",
    )] + [(name, ctypes.c_int) for name in (
        "batch", "max_depth", "code_words", "code_pages", "stack_words",
        "stack_abs_words", "stack_sp_base", "heap_words", "aux_heap_words",
        "heap_frames", "queue_capacity", "storage_slots", "journal_slots",
        "event_slots", "log_queue_capacity", "decommit_queue_capacity",
        "emit_mode", "k_cycles", "k_stop", "keccak_blocks", "sha_rounds",
        "pq_slots_in", "pq_capacity",
    )]


#: the probes' C entries, eravm_<probe>_launch and eravm_<probe>_host: their
#: arguments ("p" a pointer, "i" an int) before the launchers' stream
_PROBE_LAUNCH = {"p1": "piiii", "p2": "ppiii", "p3": "piiii", "p4": "pii",
                 "p6": "pppiiiii", "p7": "ppiii"}
_PROBE_HOST = {"p1": "piii", "p2": "ppiii", "p3": "piiii", "p4": "pii",
               "p6": "pppiiii", "p7": "ppiii"}


def _bind_probes(lib: ctypes.CDLL, kind: str, specs: dict) -> None:
    for name, spec in specs.items():
        fn = getattr(lib, f"eravm_{name}_{kind}")
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in spec] + [ctypes.c_void_p] * (kind == "launch")
        fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build if needed and load the CUDA kernels' library (once per
    process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.eravm_k1_launch.argtypes = [ctypes.POINTER(K1Args),
                                        ctypes.c_int, ctypes.c_void_p]
        lib.eravm_k1_launch.restype = ctypes.c_int
        lib.eravm_k2_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.eravm_k2_launch.restype = ctypes.c_int
        lib.eravm_k3_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.eravm_k3_launch.restype = ctypes.c_int
        _bind_probes(lib, "launch", _PROBE_LAUNCH)
        lib.eravm_p3_unroll.argtypes = []
        lib.eravm_p3_unroll.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def load_host() -> ctypes.CDLL:
    """Build if needed and load the host build (once per process)."""
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = ctypes.CDLL(str(build_host()))
        lib.eravm_k1_host.argtypes = [ctypes.POINTER(K1Args), ctypes.c_int]
        lib.eravm_k1_host.restype = ctypes.c_int
        lib.eravm_k2_host.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int]
        lib.eravm_k2_host.restype = ctypes.c_int
        lib.eravm_k3_host.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
        lib.eravm_k3_host.restype = ctypes.c_int
        lib.eravm_ecrecover_host.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int]
        lib.eravm_ecrecover_host.restype = ctypes.c_int
        _bind_probes(lib, "host", _PROBE_HOST)
        _HOST_LIB = lib
    return _HOST_LIB
