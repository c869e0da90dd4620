"""K1's development hooks (DEBUG_SKIP, DEBUG_STAGE, DEBUG_PASSTHROUGH) and
the ablation tools of the port, on the CPU.

The drift tests read the JAX kernel and tools as text (`ast`: no `jax`
import): every DEBUG_SKIP name, `_stage_cut` number and DEBUG_PASSTHROUGH
name there has its counterpart in K1 and the other way round, and the
port's `tools/ablate_fused.py` and `tools/probe_perf.py` keep the JAX tools'
programs and `cfg()`.  The hooks' semantics run on K1's g++ body built with
K1_HOOKS_HOST (one build; the hooks are globals there and compile-time
constants on the card), against the plain engine and against the same body
with the hooks off.
"""

import ast
import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.config import VmConfig
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import programs
from era_zk_evm_tpu_torch.tools import ablate_fused, probe_perf

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_KERNEL = ROOT / "era_zk_evm_tpu" / "models" / "fused_cycle.py"
CYCLE_KERNEL = ROOT / "era_zk_evm_tpu_torch" / "csrc" / "cycle_kernel.cu"
#: the JAX carry names that are no lane field K1 writes back: the cached
#: current frame (K1 keeps it in the callstack arrays) and global_step
#: (the JAX body sets it after the passthrough, so naming it does nothing)
JAX_CARRY_ONLY = {"cur_scal", "cur_this", "cur_sender", "cur_code",
                  "cur_u128", "global_step"}


def _tree(path):
    return ast.parse(path.read_text())


def _jax_hook_names():
    """(DEBUG_SKIP names, DEBUG_PASSTHROUGH names, _stage_cut numbers, the
    nv keys) that the JAX kernel reads."""
    skip, passthrough, stages, nv = set(), set(), [], set()
    for node in ast.walk(_tree(JAX_KERNEL)):
        if isinstance(node, ast.Compare) and isinstance(node.left,
                                                        ast.Constant):
            for op, right in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)) and isinstance(
                        right, ast.Name):
                    {"DEBUG_SKIP": skip, "DEBUG_PASSTHROUGH": passthrough}.get(
                        right.id, set()).add(node.left.value)
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "_stage_cut":
            stages.append(node.args[1].value)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and getattr(
                        t.value, "id", "") == "nv" and isinstance(
                            t.slice, ast.Constant):
                    nv.add(t.slice.value)
    return skip, passthrough, stages, nv


def test_hook_names_match_the_jax_kernel():
    skip, passthrough, stages, nv = _jax_hook_names()
    assert skip == set(fused_cycle.K1_SKIP_BITS)
    assert len(stages) == len(set(stages))
    assert set(stages) == set(fused_cycle.K1_STAGES)
    assert passthrough == {"mem"} <= set(fused_cycle.K1_PASSTHROUGH_BITS)
    assert set(fused_cycle.K1_PASSTHROUGH_BITS) - {"mem"} \
        == nv - JAX_CARRY_ONLY
    # K1's cut points, in the order of the cycle that K1_STAGES gives, and
    # every hook bit read by the kernel
    src = CYCLE_KERNEL.read_text()
    cuts = [int(n) for n in re.findall(r"\bK1_CUT\((\d+),", src)]
    assert cuts == list(fused_cycle.K1_STAGES)
    for prefix, names in (("K1_SKIP", fused_cycle.K1_SKIP_BITS),
                          ("K1_PASS", fused_cycle.K1_PASSTHROUGH_BITS)):
        for name in names:
            assert f"{prefix}_{name.upper()})" in src, name


def _jax_tool(name):
    """A JAX tool's module-level strings and ints, and its `cfg`, evaluated
    from its source with a VmConfig that returns its keywords."""
    tree = _tree(ROOT / "tools" / f"{name}.py")
    consts, cfg = {}, None
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            consts[node.targets[0].id] = node.value.value
        if isinstance(node, ast.FunctionDef) and node.name == "cfg":
            cfg = node
    ns = {"VmConfig": lambda **kw: kw, "N_CYCLES": consts["N_CYCLES"]}
    exec(compile(ast.Module([cfg], []), name, "exec"), ns)
    return consts, ns["cfg"]


@pytest.mark.parametrize("name,port", [("ablate_fused", ablate_fused),
                                       ("probe_perf", probe_perf)])
def test_tools_keep_the_jax_programs_and_cfg(name, port):
    consts, jax_cfg = _jax_tool(name)
    progs = {k: v for k, v in consts.items() if k.startswith("PROG_")}
    assert progs and all(getattr(port, k) == v for k, v in progs.items())
    assert port.N_CYCLES == consts["N_CYCLES"]
    if name == "ablate_fused":
        assert port.PROG_BENCH == programs.WORKLOAD
    for kw in ({}, {"witness": True}, {"witness": False},
               {"stack_words": 128}, {"stack_words": 1024},
               {"heap_words": 16}, {"max_depth": 32}, {"batch": 131072}):
        want = jax_cfg(**kw)
        got = port.cfg(**kw)
        assert {k: getattr(got, k) for k in want} == want, kw


# -------------------------------------------- the hooks on the host build

N_CYCLES = 16
ALU = """
    add 7, r0, r1
    add 35, r0, r2
    add! r1, r2, r3
    xor r3, r2, r4
    and r4, r3, r5
    or r5, r2, r6
    sub r6, r2, r7
    ret r0
"""
# each unit's program, run up to its final ret (which would wipe the
# registers): r3, and r4 where the unit writes two, hold its outputs; the
# aligned heap program never enters the splice
UNIT_PROGRAMS = {
    "mul": "add 7, r0, r1\n add 35, r0, r2\n mul r1, r2, r3, r4\n ret r0",
    "div": "add 70, r0, r1\n add 7, r0, r2\n div r1, r2, r3, r4\n ret r0",
    "shift": "add 1, r0, r1\n add 5, r0, r2\n shl r1, r2, r3\n ret r0",
    "uma_shift": "add 5, r0, r1\n st.h 0, r1\n ld.h 1, r3\n ret r0",
    "stack": ("add 11, r0, r1\n add r1, r0, stack+=[1]\n"
              " add stack-=[1], r0, r3\n ret r0"),
    "heap": "add 9, r0, r1\n st.h 0, r1\n ld.h 0, r3\n ret r0",
    "aligned_heap": ("add 9, r0, r1\n st.h 0, r1\n ld.h 0, r2\n"
                     " st.h 64, r2\n ld.h 64, r3\n ret r0"),
}
#: DEBUG_SKIP name -> (a program that never enters what it skips, one that
#: does)
SKIP_CASES = {
    "mul": (ALU, "mul"), "div": (ALU, "div"), "shift": (ALU, "shift"),
    "uma_shift": ("aligned_heap", "uma_shift"),
    "stack_rw": ("aligned_heap", "stack"), "heap_rw": (ALU, "heap"),
    "stack_rw_rt": ("aligned_heap", "stack"),
    "stack_st_rt": ("aligned_heap", "stack"),
    "stack_st_off": ("aligned_heap", "stack"),
}
ARENAS = ("stack", "stack_ptr_tag", "heap", "aux_heap")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The plain engine's runs are many small torch ops: more intra-op
    threads only add their synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host():
    lib = _build.load_host(hooks=True)
    yield lib
    lib.eravm_k1_hooks_host(0, -1, 0)


def _config(batch):
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    stack_abs_words=64, stack_sp_base=960, heap_words=64,
                    aux_heap_words=16, max_depth=8,
                    queue_capacity=N_CYCLES * 8)


def _entry(sources):
    words = [programs.assemble(UNIT_PROGRAMS.get(s, s)) for s in sources]
    config = _config(len(words))
    return config, pstate.make_entry_state(config, words, ergs=1 << 20,
                                           device="cpu")


def _arrays(st):
    return {k: v.copy() for k, v in pstate.state_to_numpy(st).items()}


def _host_run(host, st, config, skip=(), stage=-1, passthrough=(),
              n=N_CYCLES):
    """One launch of n cycles of K1's g++ body with these hooks, in
    place."""
    host.eravm_k1_hooks_host(
        sum(fused_cycle.K1_SKIP_BITS[n] for n in skip), stage,
        sum(fused_cycle.K1_PASSTHROUGH_BITS[n] for n in passthrough))
    try:
        step0 = st.global_step.min()   # alive until the launch returns
        args = fused_cycle.k1_args(st, config, n, n, None, step0, None)
        assert host.eravm_k1_host(ctypes.byref(args), 0) == 0
    finally:
        host.eravm_k1_hooks_host(0, -1, 0)
    return _arrays(st)


def _differing(a, b):
    return sorted(k for k in a if not np.array_equal(a[k], b[k]))


STAGE_SOURCES = [programs.WORKLOAD, *programs.FAMILY_PROGRAMS.values()]


@pytest.mark.parametrize("stage", list(fused_cycle.K1_STAGES))
def test_stage_cut(host, stage):
    """A cut cycle leaves the lane as it entered but for timestamp and
    writes no row; before the first store, every field of the state is the
    entry's but timestamp (and global_step, which the chunk advances, as
    the JAX body does on a cut too)."""
    config, st = _entry(STAGE_SOURCES)
    entry = _arrays(st)
    got = _host_run(host, st, config, stage=stage)
    entry["global_step"] = entry["global_step"] + N_CYCLES
    if stage in fused_cycle.K1_STAGES_BEFORE_STORES:
        assert _differing(got, entry) in ([], ["timestamp"])
    else:
        for k in ("monotonic_cycle_counter", "lane_error", "done", "depth",
                  "wq_meta", "wq_value", "wq_flags", "wq_count"):
            assert np.array_equal(got[k], entry[k]), k
    # the uncut run changes what the cut kept
    config, st = _entry(STAGE_SOURCES)
    full = _host_run(host, st, config)
    assert {"monotonic_cycle_counter", "wq_flags", "regs"} \
        <= set(_differing(full, entry))


def _reg(arrays, r):
    return arrays["regs"][:, r - 1, 0]


@pytest.mark.parametrize("name", list(fused_cycle.K1_SKIP_BITS))
def test_skip(host, name):
    never, enters = SKIP_CASES[name]
    # a program that never enters the skipped code: the plain engine's
    # every field
    config, st = _entry([never] * 2)
    plain = pstate.clone_state(st)
    got = _host_run(host, st, config, skip={name})
    fused_cycle.run_cycles(plain, config, N_CYCLES)
    assert _differing(got, _arrays(plain)) == []
    # one that enters it, against the same body with the hooks off, up to
    # its ret
    config, st = _entry([enters] * 2)
    entry = _arrays(st)
    n = UNIT_PROGRAMS[enters].count("\n")
    off = _host_run(host, pstate.clone_state(st), config, n=n)
    got = _host_run(host, st, config, skip={name}, n=n)
    if name in ("mul", "div"):
        assert (_reg(off, 3) != 0).all() and (_reg(got, 3) == 0).all()
        assert (_reg(got, 4) == 0).all()
    elif name == "shift":
        assert (_reg(off, 3) == 32).all() and (_reg(got, 3) == 0).all()
    elif name == "uma_shift":
        # the unaligned read takes word 0 as it is (JAX: read_val = w0)
        assert (_reg(off, 3) == 5 << 8).all() and (_reg(got, 3) == 5).all()
    elif name == "heap_rw":
        assert (_reg(off, 3) == 9).all() and (_reg(got, 3) == 0).all()
        assert np.array_equal(got["heap"], entry["heap"])
    else:
        # the stack: every form reads 0 here; stack_rw_rt alone still
        # stores
        assert (_reg(off, 3) == 11).all() and (_reg(got, 3) == 0).all()
        stored = not np.array_equal(got["stack"], entry["stack"])
        assert stored == (name == "stack_rw_rt")
        assert not np.array_equal(off["stack"], entry["stack"])


@pytest.mark.parametrize("name", ["mem", "monotonic_cycle_counter", "regs",
                                  "timestamp"])
def test_passthrough(host, name):
    config, st = _entry([programs.WORKLOAD, "stack", "uma_shift",
                         *programs.FAMILY_PROGRAMS.values()])
    entry = _arrays(st)
    off = _host_run(host, pstate.clone_state(st), config)
    got = _host_run(host, st, config, passthrough={name})
    assert not np.array_equal(got["monotonic_cycle_counter"],
                              entry["monotonic_cycle_counter"]) \
        or name == "monotonic_cycle_counter"
    if name == "mem":
        assert all(np.array_equal(got[k], entry[k]) for k in ARENAS)
        assert not all(np.array_equal(off[k], entry[k]) for k in ARENAS)
        return
    assert np.array_equal(got[name], entry[name])
    assert not np.array_equal(off[name], entry[name])
    if name == "monotonic_cycle_counter":
        # nothing reads it: the rest of the run is the unhooked one
        assert _differing(got, off) == [name]


def test_unknown_hooks_raise(monkeypatch):
    for attr, value in (("DEBUG_SKIP", frozenset({"nope"})),
                        ("DEBUG_STAGE", 14),
                        ("DEBUG_PASSTHROUGH", frozenset({"cur_scal"}))):
        with monkeypatch.context() as m:
            m.setattr(fused_cycle, attr, value)
            with pytest.raises(ValueError, match=attr):
                fused_cycle.k1_hook_flags()
    # the plain engine has no hooks: a hooked chunk on a CPU state raises
    config, st = _entry([ALU])
    monkeypatch.setattr(fused_cycle, "DEBUG_SKIP", frozenset({"mul"}))
    with pytest.raises(ValueError, match="hooks"):
        fused_cycle.cycle_chunk(st, config, 4)


def test_hooks_pick_the_library(monkeypatch):
    """While a hook is set, cycle_chunk's K1 comes from the hooked build
    of those flags; reset, from `_build.load()` again."""
    loads = []
    monkeypatch.setattr(_build, "load", lambda: "default")
    monkeypatch.setattr(_build, "load_hooked",
                        lambda flags: loads.append(flags) or "hooked")
    assert fused_cycle.k1_hook_flags() == []
    assert fused_cycle.k1_library() == "default"
    monkeypatch.setattr(fused_cycle, "DEBUG_SKIP",
                        frozenset({"stack_rw", "heap_rw"}))
    monkeypatch.setattr(fused_cycle, "DEBUG_STAGE", 5)
    monkeypatch.setattr(fused_cycle, "DEBUG_PASSTHROUGH", frozenset({"mem"}))
    assert fused_cycle.k1_library() == "hooked"
    assert loads == [["-DK1_DEBUG_SKIP=48u", "-DK1_DEBUG_STAGE=5",
                      "-DK1_DEBUG_PASSTHROUGH=1u"]]
    monkeypatch.setattr(fused_cycle, "DEBUG_SKIP", frozenset())
    monkeypatch.setattr(fused_cycle, "DEBUG_STAGE", None)
    monkeypatch.setattr(fused_cycle, "DEBUG_PASSTHROUGH", frozenset())
    assert fused_cycle.k1_library() == "default"
    # the tools' lines: the flags of their variants, the hooks reset after
    assert ablate_fused.hook_flags({"mul"}, 3) == (
        "-DK1_DEBUG_SKIP=1u", "-DK1_DEBUG_STAGE=3")
    assert fused_cycle.k1_hook_flags() == []


def test_tool_groups_cover_the_jax_groups():
    """Every JAX group but the word cache's has its port, with the JAX
    lines' programs; the stage group cuts at every stage."""
    tree = _tree(ROOT / "tools" / "ablate_fused.py")
    jax_groups = {n.left.value for n in ast.walk(tree)
                  if isinstance(n, ast.Compare)
                  and isinstance(n.left, ast.Constant)
                  and getattr(n.comparators[0], "id", "") == "groups"}
    assert jax_groups - {"wc"} == set(ablate_fused.GROUPS)
    stages = [kw.get("stage") for *_, kw in ablate_fused.GROUPS["stage"]]
    assert stages == [None, *fused_cycle.K1_STAGES]
    assert set(probe_perf.GROUPS) == {"mix", "arena", "batch", "depth"}
