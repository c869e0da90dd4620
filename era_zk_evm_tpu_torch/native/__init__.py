"""The C++ scalar EraVM oracle, bound with ctypes: the port's own copy.

A sequential interpreter of the whole ISA (all 15 opcode families, with
Log.precompile for keccak256, sha256 and ecrecover, the latter in
correctness-grade shift-add field arithmetic; far calls take a staged
contract bank and storage-init entries).  It is the port's independent
scalar reference beside `golden/`, for differential runs against the engine
and K1, and its single-core witness-traced cycles/s is the baseline of a
throughput figure.  It runs on the host only: it has no device argument and
no path on the card calls it.

`eravm_oracle.cpp` is a byte-for-byte copy of the JAX package's source; its
`#include "tables.h"` is generated from the port's `isa` (`gen_tables.py`).
`build()` compiles it with g++ on first use into
`era_zk_evm_tpu_torch/_build/oracle-<key>/`, keyed by a hash of the source,
the tables, the flags, g++'s version and the host's machine type (a library
carried from another host or compiler never matches); the library is built in a private directory and
renamed into place, so builds racing in several processes never load a
half-written library.  A failed build or load raises: nothing here falls
back to an assumed figure.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import platform
import shutil
import subprocess
import tempfile
import time

_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = _DIR / "eravm_oracle.cpp"
BUILD_ROOT = _DIR.parent / "_build"
FLAGS = ["-O2", "-shared", "-fPIC"]
LIB_NAME = "liberavm_oracle.so"

ST_DONE = 0
ST_MAX_CYCLES = 1
ST_UNSUPPORTED = 2
ST_OOB = 3


def _key(tables: str) -> str:
    gxx = subprocess.run(["g++", "-dumpfullversion"], capture_output=True,
                         text=True, check=True).stdout.strip()
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (tables, " ".join(FLAGS), gxx, platform.machine()):
        h.update(part.encode() + b"\0")
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the oracle once per key; return the library's path.  Raises
    with the compiler's output if g++ fails."""
    from .gen_tables import tables_text

    tables = tables_text()
    out_dir = BUILD_ROOT / f"oracle-{_key(tables)}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        (tmp / "tables.h").write_text(tables)
        proc = subprocess.run(
            ["g++", *FLAGS, "-I", str(tmp), "-o", str(tmp / LIB_NAME),
             str(SOURCE)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        (tmp / "build.log").write_text(proc.stdout + proc.stderr)
        tmp.rename(out_dir)
    except OSError:
        # another process renamed its build into place first
        if not lib.exists():
            raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.eravm_oracle_run.restype = ctypes.c_int
        lib.eravm_oracle_run.argtypes = [
            ctypes.c_char_p, ctypes.c_int,                  # code, n words
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),  # bank hashes/lens
            ctypes.c_char_p, ctypes.c_int,                  # bank words, n
            ctypes.c_char_p, ctypes.c_int,                  # storage init, n
            ctypes.c_char_p,                                # default AA hash
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,  # addr, ergs, max
            ctypes.c_int, ctypes.c_int, ctypes.c_int,       # arena sizes
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,  # regs/tags/heap
            ctypes.c_char_p, ctypes.c_int,                  # witness buf/cap
            ctypes.POINTER(ctypes.c_int),                   # witness count
            ctypes.c_char_p, ctypes.c_int,                  # log buf/cap
            ctypes.POINTER(ctypes.c_int),                   # log count
            ctypes.c_char_p, ctypes.c_int,                  # decommit buf/cap
            ctypes.POINTER(ctypes.c_int),                   # decommit count
            ctypes.c_char_p, ctypes.c_int,                  # storage buf/cap
            ctypes.POINTER(ctypes.c_int),                   # storage count
            ctypes.c_char_p, ctypes.c_int,                  # events buf/cap
            ctypes.POINTER(ctypes.c_int),                   # events count
            ctypes.POINTER(ctypes.c_int),                   # cycles
            ctypes.POINTER(ctypes.c_int),                   # flags
            ctypes.POINTER(ctypes.c_uint64),                # entry ergs
        ]
        _lib = lib
    return _lib


def run_oracle(code_words: list[int], entry_address: int = 0x8001,
               ergs: int = 1 << 20, max_cycles: int = 10_000,
               stack_words: int = 2048, heap_words: int = 64,
               aux_words: int = 64, witness_cap: int = 1 << 16,
               collect_witness: bool = True,
               contracts: list[tuple[int, list[int]]] | None = None,
               storage_entries: list[tuple[int, int, int]] | None = None,
               default_aa_hash: int = 0) -> dict:
    """Run a program on the native oracle; returns final state + witness.

    ``contracts`` stages the decommitter bank as (stored_code_hash, words);
    ``storage_entries`` pre-populates shard-0 storage as (address, key, value)
    — use address=DEPLOYER_SYSTEM_CONTRACT_ADDRESS, key=callee address,
    value=code hash to make a contract callable (mirrors populate_storage).
    The result dict carries ``run_seconds`` — wall time of the native call
    only (excludes Python-side result extraction) for baseline measurement.
    """
    lib = _load()
    code = b"".join(w.to_bytes(32, "big") for w in code_words)

    contracts = contracts or []
    bank_hashes = b"".join(h.to_bytes(32, "big") for h, _ in contracts)
    bank_lens = (ctypes.c_int * max(len(contracts), 1))(
        *[len(w) for _, w in contracts])
    bank_words = b"".join(
        w.to_bytes(32, "big") for _, ws in contracts for w in ws)

    storage_entries = storage_entries or []
    sinit = bytearray()
    for address, key, value in storage_entries:
        assert address < (1 << 64), "native oracle: addresses must fit u64"
        rec = bytearray(96)
        rec[16:24] = address.to_bytes(8, "big")
        rec[32:64] = key.to_bytes(32, "big")
        rec[64:96] = value.to_bytes(32, "big")
        sinit += rec
    aa = default_aa_hash.to_bytes(32, "big") if default_aa_hash else None

    regs = ctypes.create_string_buffer(15 * 32)
    tags = ctypes.create_string_buffer(15)
    heap = ctypes.create_string_buffer(heap_words * 32)
    wit = ctypes.create_string_buffer(witness_cap * 64) if collect_witness \
        else None
    wc = ctypes.c_int(0)
    log_cap, dec_cap, st_cap, ev_cap = 4096, 256, 128, 256
    logb = ctypes.create_string_buffer(log_cap * 128)
    decb = ctypes.create_string_buffer(dec_cap * 48)
    stb = ctypes.create_string_buffer(st_cap * 96)
    evb = ctypes.create_string_buffer(ev_cap * 72)
    lc = ctypes.c_int(0)
    dc = ctypes.c_int(0)
    sc = ctypes.c_int(0)
    ec = ctypes.c_int(0)
    cycles = ctypes.c_int(0)
    flags = ctypes.c_int(0)
    entry_ergs = ctypes.c_uint64(0)
    t0 = time.perf_counter()
    status = lib.eravm_oracle_run(
        code, len(code_words),
        bank_hashes or None, bank_lens, bank_words or None, len(contracts),
        bytes(sinit) or None, len(storage_entries), aa,
        entry_address, ergs, max_cycles,
        stack_words, heap_words, aux_words,
        regs, tags, heap, wit, witness_cap if collect_witness else 0,
        ctypes.byref(wc),
        logb, log_cap, ctypes.byref(lc),
        decb, dec_cap, ctypes.byref(dc),
        stb, st_cap, ctypes.byref(sc),
        evb, ev_cap, ctypes.byref(ec),
        ctypes.byref(cycles), ctypes.byref(flags),
        ctypes.byref(entry_ergs))
    run_seconds = time.perf_counter() - t0
    out = {
        "status": status,
        "run_seconds": run_seconds,
        "cycles": cycles.value,
        "flags": (bool(flags.value & 1), bool(flags.value & 2),
                  bool(flags.value & 4)),
        "registers": [int.from_bytes(regs.raw[i * 32:(i + 1) * 32], "big")
                      for i in range(15)],
        "reg_ptr": [bool(b) for b in tags.raw],
        "heap": [int.from_bytes(heap.raw[i * 32:(i + 1) * 32], "big")
                 for i in range(heap_words)],
        "witness_count": wc.value,
        "entry_ergs": entry_ergs.value,
    }
    if collect_witness:
        n = min(wc.value, witness_cap)
        raw = wit.raw  # single copy out of ctypes (``.raw`` copies per access)
        out["witness_records"] = [raw[i * 64:(i + 1) * 64] for i in range(n)]
    lraw = logb.raw
    out["log_records"] = [lraw[i * 128:(i + 1) * 128]
                          for i in range(min(lc.value, log_cap))]
    draw = decb.raw
    out["decommit_records"] = []
    for i in range(min(dc.value, dec_cap)):
        r = draw[i * 48:(i + 1) * 48]
        out["decommit_records"].append({
            "hash": int.from_bytes(r[0:32], "big"),
            "timestamp": int.from_bytes(r[32:36], "big"),
            "page": int.from_bytes(r[36:40], "big"),
            "length": int.from_bytes(r[40:44], "big"),
            "is_fresh": bool(r[44])})
    sraw = stb.raw
    out["storage"] = {}
    for i in range(sc.value):
        r = sraw[i * 96:(i + 1) * 96]
        address = int.from_bytes(r[12:32], "big")
        key = int.from_bytes(r[32:64], "big")
        out["storage"][(address, key)] = int.from_bytes(r[64:96], "big")
    eraw = evb.raw
    out["events"] = []
    for i in range(ec.value):
        r = eraw[i * 72:(i + 1) * 72]
        out["events"].append({
            "aux": r[0], "is_first": bool(r[1]),
            "tx": int.from_bytes(r[6:8], "big"),
            "key": int.from_bytes(r[8:40], "big"),
            "value": int.from_bytes(r[40:72], "big")})
    return out
