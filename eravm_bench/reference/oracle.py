"""The benchmark's plain reference: the scalar EraVM oracle, built with g++
and bound with ctypes.

`eravm_oracle.cpp` is a frozen copy of the port's C++ oracle with a few
additions (its header says which); its decode and price tables, `tables.h`,
are written at build time by `isa_tables.py`, the instruction set written
down as data here.  Nothing here imports the port: the oracle takes only the
inputs the benchmark made (code words, ergs, arena sizes) and works out the
whole VM state for itself.

`build()` compiles the library once a key (a hash of the source, the
tables, the flags, g++'s version and the machine type) into
`eravm_bench/_build/oracle-<key>/`,
a fixed directory inside the checkout; the build goes to a private directory
that is renamed into place, so racing builds never load a half-written
library.  `run()` releases the interpreter lock while the oracle runs (a
ctypes call does), so lanes run in parallel threads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import pathlib
import platform
import shutil
import subprocess
import tempfile

import numpy as np

from . import isa_tables

_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = _DIR / "eravm_oracle.cpp"
BUILD_ROOT = _DIR.parent / "_build"
FLAGS = ["-O2", "-shared", "-fPIC"]
LIB_NAME = "liberavm_bench_oracle.so"

ST_DONE, ST_MAX_CYCLES, ST_UNSUPPORTED, ST_OOB = 0, 1, 2, 3

#: words of one frame in the state dump
FRAME_WORDS = 25


def state_layout(n_frames: int, stack_words: int, aux_words: int) -> dict:
    """Offsets and shapes of the u32 words of `state_out`, in the order the
    oracle writes them: name -> (offset, shape)."""
    parts = [("timestamp", ()), ("pending_exception", ()),
             ("previous_code_word", (8,)), ("previous_super_pc", ()),
             ("have_previous", ()), ("previous_code_page", ()),
             ("context_u128", (4,)), ("ergs_per_pubdata", ()),
             ("spent_pubdata", ()), ("tx_number", ()), ("page_counter", ()),
             ("depth", ()), ("kv_count", ()), ("j_count", ()),
             ("ev_count", ()), ("frames", (n_frames, FRAME_WORDS)),
             ("stack", (stack_words, 8)), ("stack_tag", (stack_words,)),
             ("aux_heap", (aux_words, 8))]
    out, off = {}, 0
    for name, shape in parts:
        out[name] = (off, shape)
        off += int(np.prod(shape, dtype=np.int64)) if shape else 1
    out["_total"] = (off, ())
    return out


def _key() -> str:
    gxx = subprocess.run(["g++", "-dumpfullversion"], capture_output=True,
                         text=True, check=True).stdout.strip()
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(isa_tables.tables_text().encode())
    for part in (" ".join(FLAGS), gxx, platform.machine()):
        h.update(part.encode() + b"\0")
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the oracle once a key; the library's path.  Raises with the
    compiler's output if g++ fails."""
    out_dir = BUILD_ROOT / f"oracle-{_key()}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        (tmp / "tables.h").write_text(isa_tables.tables_text())
        proc = subprocess.run(
            ["g++", *FLAGS, "-I", str(tmp), "-o", str(tmp / LIB_NAME),
             str(SOURCE)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        try:
            tmp.rename(out_dir)
        except OSError:
            # another process renamed its build into place first
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, u64 = ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64
    ip = ctypes.POINTER(ctypes.c_int)
    lib.eravm_oracle_run.restype = i
    lib.eravm_oracle_run.argtypes = [
        p, i, p, ip, p, i, p, i, p, u64, u64, i, i, i, i, p, p, p,
        p, i, ip, p, i, ip, p, i, ip, p, i, ip, p, i, ip,
        ip, ip, ctypes.POINTER(u64),
        i, ctypes.c_void_p, ctypes.c_void_p, i, i]
    return lib


def run(code_words: list[int], *, ergs: int, max_cycles: int,
        stack_words: int, heap_words: int, aux_words: int, n_frames: int,
        witness_from: int = -1, witness_cap: int = 0, sponge: bool = False,
        entry_address: int = 0x8001, drop_type: int = -1) -> dict:
    """Run one lane's program from its entry for at most `max_cycles`.

    Returns status, cycles, flags, registers (u32 limbs [15, 8]) and their
    pointer tags, the entry heap (u32 limbs [heap_words, 8]), the memory
    records of the cycles from `witness_from` on (uint8 [n, 64], up to
    `witness_cap`), with `sponge` the rolling sponge (u32 [25, 2]) and its
    record count, and `state`, the dump's words by `state_layout` name.
    `drop_type`, the control's, a memory query type whose records are left
    out of the witness and the sponge."""
    lib = _lib()
    code = b"".join(int(w).to_bytes(32, "big") for w in code_words)
    regs = ctypes.create_string_buffer(15 * 32)
    tags = ctypes.create_string_buffer(15)
    heap = ctypes.create_string_buffer(heap_words * 32)
    wit = ctypes.create_string_buffer(max(witness_cap, 1) * 64)
    caps = (4096, 256, 128, 256)      # log, decommit, storage, events
    bufs = [ctypes.create_string_buffer(c * w)
            for c, w in zip(caps, (128, 48, 96, 72))]
    counts = [ctypes.c_int(0) for _ in range(5)]
    cycles, flags = ctypes.c_int(0), ctypes.c_int(0)
    entry_ergs = ctypes.c_uint64(0)
    layout = state_layout(n_frames, stack_words, aux_words)
    state = np.zeros(layout["_total"][0], dtype=np.uint32)
    sp_out = np.zeros(51, dtype=np.uint32)
    bank_lens = (ctypes.c_int * 1)(0)
    status = lib.eravm_oracle_run(
        code, len(code_words), None, bank_lens, None, 0,
        None, 0, None,
        entry_address, ergs, max_cycles, stack_words, heap_words, aux_words,
        regs, tags, heap, wit, witness_cap, ctypes.byref(counts[0]),
        bufs[0], caps[0], ctypes.byref(counts[1]),
        bufs[1], caps[1], ctypes.byref(counts[2]),
        bufs[2], caps[2], ctypes.byref(counts[3]),
        bufs[3], caps[3], ctypes.byref(counts[4]),
        ctypes.byref(cycles), ctypes.byref(flags), ctypes.byref(entry_ergs),
        witness_from, sp_out.ctypes.data if sponge else None,
        state.ctypes.data, n_frames, drop_type)

    def limbs(raw: bytes, n: int) -> np.ndarray:
        """n 32-byte big-endian words -> u32 limbs [n, 8], least first."""
        a = np.frombuffer(raw, dtype=">u4").reshape(n, 8)[:, ::-1]
        return a.astype(np.uint32)

    n_wit = min(counts[0].value, witness_cap)
    out = {
        "status": status, "cycles": cycles.value,
        "flags": np.array([(flags.value >> i) & 1 for i in range(3)],
                          dtype=bool),
        "regs": limbs(regs.raw, 15),
        "reg_ptr": np.frombuffer(tags.raw, dtype=np.uint8).astype(bool),
        "heap": limbs(heap.raw, heap_words),
        "witness_count": counts[0].value,
        "witness": np.frombuffer(wit.raw[:n_wit * 64],
                                 dtype=np.uint8).reshape(n_wit, 64),
        "state": {name: (state[off:off + (int(np.prod(shape)) if shape
                                          else 1)].reshape(shape))
                  for name, (off, shape) in layout.items()
                  if name != "_total"},
    }
    if sponge:
        out["sponge"] = sp_out[:50].reshape(25, 2).copy()
        out["sponge_count"] = int(sp_out[50])
    return out
