"""The fold tools of the port (`era_zk_evm_tpu_torch/tools/probe_rolling.py`,
`probe_foldparts.py`, `probe_bsparts.py`, `probe_fold_split.py`,
`probe_bsfold.py`) against the JAX tools of `tools/`, on the CPU.

The drift tests read the JAX tools as text (`ast`: no `jax` import): the
port keeps their constants (B, K, KQ, G8, the 112 slots, p = 0.11, the
seeds), `make_cfg`'s keywords and `WORKLOAD`, draws what they draw, and
every label and group they print has a key in the port tool's output, with
a number or with null and its reason.  The tools run end to end with
`--cpu` at tiny sizes (the plain versions of K1, K2 and P2).  Mode (a)'s
queue, compacted and folded, gives mode (b)'s counts, sponges and digests,
and JAX `run_cycles`' rolling-mode sponge on the programs and geometry of
`tests/test_torch_rolling.py` (a program the suite already compiles);
`rec_words_to_planes` equals the JAX tool's.
"""

import ast
import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import make_entry_state, run_cycles
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import programs
from era_zk_evm_tpu_torch.tools import (
    k1_times, probe_bsfold, probe_bsparts, probe_fold_split, probe_foldparts,
    probe_rolling,
)
from era_zk_evm_tpu_torch.witness.rolling import (
    compact_slot_rows, finalize_rolling,
)

from test_fused_cycle import N_CYCLES
from test_torch_rolling import ERGS, PROGRAMS, _rolling_config
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: each port tool's run at a tiny size: (module, argv)
RUNS = {
    "probe_rolling": (probe_rolling, ["16", "4", "--cpu"]),
    "probe_foldparts": (probe_foldparts, ["--cpu", "--batch", "32"]),
    "probe_bsparts": (probe_bsparts, ["256", "16", "--cpu"]),
    "probe_fold_split": (probe_fold_split,
                         ["--cpu", "--batch", "256", "--kq", "128"]),
    "probe_fold_split pieces": (probe_fold_split, [
        "pieces", "--cpu", "--batch", "256", "--kq", "128"]),
    "probe_bsfold": (probe_bsfold, ["256", "2", "--cpu", "--iters", "2"]),
}


def _tree(name):
    return ast.parse((ROOT / "tools" / f"{name}.py").read_text())


def _function(tree, name):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _consts(tree):
    """The module's assignments of numbers, evaluated in order (an `x if
    argv else default` by its default)."""
    ns = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value = node.value.orelse if isinstance(node.value, ast.IfExp) \
                else node.value
            try:
                ns[node.targets[0].id] = eval(compile(
                    ast.Expression(value), "tool", "eval"), dict(ns))
            except NameError:
                continue
    return {k: v for k, v in ns.items() if isinstance(v, (int, float, str))}


def _defaults(tree, fn):
    """The defaults a function gives its `x = ... if ... else default`
    names."""
    return {n.targets[0].id: n.value.orelse.value
            for n in ast.walk(_function(tree, fn))
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.IfExp)
            and isinstance(n.value.orelse, ast.Constant)}


def _calls(tree, attr):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and attr in (getattr(n.func, "id", None),
                         getattr(n.func, "attr", None))]


def _labels(name):
    """The labels and groups the JAX tool prints a line for (`name`: a
    key of RUNS)."""
    tree = _tree(name.split()[0])

    def keys(var):     # var = {"k": ...} and var["k"] = ...
        out = set()
        for n in ast.walk(tree):
            if isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                        ast.Subscript) \
                    and getattr(n.targets[0].value, "id", "") == var:
                out.add(n.targets[0].slice.value)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict) \
                    and getattr(n.targets[0], "id", "") == var:
                out |= {k.value for k in n.value.keys}
        return out

    def label_args(scope, fn):
        return {a.value for c in _calls(scope, fn)
                for a in list(c.args) + [k.value for k in c.keywords
                                         if k.arg == "label"]
                if isinstance(a, ast.Constant) and isinstance(a.value, str)}

    if name == "probe_rolling":
        return ({"profile"} | {f"fold[{k}]" for k in keys("folds")}
                | label_args(tree, "timed_rates"))
    if name == "probe_foldparts":
        return keys("variants")
    if name == "probe_bsparts":
        return label_args(tree, "timeit")
    if name == "probe_fold_split":
        return label_args(_function(tree, "main"), "bench")
    if name == "probe_fold_split pieces":
        return label_args(_function(tree, "pieces"), "bench")
    heads = set()      # probe_bsfold: print(f"perm G8=..."), ...
    for c in _calls(tree, "print"):
        s = c.args[0]
        first = s.values[0] if isinstance(s, ast.JoinedStr) else s
        if isinstance(first, ast.Constant):
            heads.add(first.value.split()[0].rstrip(":"))
    return heads - {"backend"}     # the port's first line is the card's


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(runs, key, capsys):
    """The tool's rows and printed lines, run once a module."""
    if key not in runs:
        mod, argv = RUNS[key]
        capsys.readouterr()
        runs[key] = mod.main(argv), capsys.readouterr().out.splitlines()
    return runs[key]


# ---- drift against the JAX tools ----------------------------------------

def test_tools_keep_the_jax_constants():
    fp = _consts(_tree("probe_foldparts"))
    assert (fp["B"], fp["K"], fp["KQ"]) == (probe_foldparts.B,
                                            probe_foldparts.K,
                                            probe_foldparts.KQ)
    bp = _consts(_tree("probe_bsparts"))
    assert (bp["B"], bp["K"]) == (probe_bsparts.B, probe_bsparts.K)
    fs = _consts(_tree("probe_fold_split"))
    # probe_fold_split runs at probe_foldparts' shape; its G8 is the bit
    # planes' groups of 256 lanes (states_to_planes)
    assert (fs["B"], fs["K"], fs["KQ"], fs["G8"]) == (
        probe_foldparts.B, probe_foldparts.K, probe_foldparts.KQ,
        probe_foldparts.B // 256)
    # the slots, the validity and the seeds
    for name in ("probe_foldparts", "probe_fold_split"):
        choices = _calls(_tree(name), "choice")
        assert choices and {c.args[1].value for c in choices} \
            == {probe_foldparts.SLOTS}
    (p,) = [n.comparators[0].value for n in ast.walk(_tree("probe_bsparts"))
            if isinstance(n, ast.Compare) and isinstance(n.ops[0], ast.Lt)]
    assert p == probe_bsparts.P_VALID
    for name in ("probe_foldparts", "probe_bsparts", "probe_fold_split"):
        seeds = {c.args[0].value
                 for c in _calls(_tree(name), "RandomState")}
        assert seeds == {probe_foldparts.SEED}
    # the defaults of the tools that take sizes
    bf = _tree("probe_bsfold")
    assert _defaults(bf, "main") == {"batch": probe_bsfold.BATCH,
                                     "kq": probe_bsfold.KQ}
    iters = _function(bf, "probe_perm").args.defaults[0].value
    assert iters == probe_bsfold.ITERS
    assert _defaults(_tree("probe_rolling"), "main") == {
        "batch": probe_rolling.BATCH, "n_cycles": probe_rolling.N_CYCLES}


def test_probe_rolling_keeps_make_cfg_workload_and_groups():
    tree = _tree("probe_rolling")
    ns = {"VmConfig": lambda **kw: kw}
    exec(compile(ast.Module([_function(tree, "make_cfg")], []), "tool",
                 "exec"), ns)
    for batch, n, mode in ((32768, 128, "capture"), (32768, 128, "rolling"),
                           (64, 16, "capture"), (64, 16, "rolling")):
        want = ns["make_cfg"](batch, n, mode)
        got = probe_rolling.make_cfg(batch, n, mode)
        assert {k: getattr(got, k) for k in want} == want, (n, mode)
    (workload,) = [n.value.value for n in tree.body
                   if isinstance(n, ast.Assign)
                   and n.targets[0].id == "WORKLOAD"]
    assert workload == programs.WORKLOAD
    (groups,) = [[e.value for e in n.elts] for n in ast.walk(
        _function(tree, "main")) if isinstance(n, ast.List)
        and all(isinstance(e, ast.Constant) for e in n.elts) and n.elts]
    assert tuple(groups) == probe_rolling.GROUPS


def test_draws_are_the_jax_tools():
    """The JAX tools' calls, as written there, at a small shape: the port's
    int32 draw gives the same values and leaves the generator where they
    leave it (the 112 slots and the p = 0.11 validity follow)."""
    kq, batch = 128, 64
    rng = np.random.RandomState(0)
    meta = rng.randint(0, 1 << 31, size=(kq, 4, batch)).astype(np.uint32)
    val = rng.randint(0, 1 << 31, size=(kq, 8, batch)).astype(np.uint32)
    state = rng.get_state()
    slot_valid = np.zeros(kq, bool)
    slot_valid[rng.choice(kq, 112, replace=False)] = True
    port_rng, pmeta, pval = probe_foldparts.draw(batch, kq)
    assert np.array_equal(pmeta.view(np.uint32), meta)
    assert np.array_equal(pval.view(np.uint32), val)
    port_state = port_rng.get_state()
    assert all(np.array_equal(a, b) for a, b in zip(port_state, state))
    assert np.array_equal(probe_foldparts.active_slots(port_rng, kq),
                          slot_valid)
    # the JAX noperm block: lane l's one record at active slot l % 112
    flags = probe_foldparts.variant_flags(slot_valid, batch)
    act = np.nonzero(slot_valid)[0]
    assert (flags["noperm"] != 0).sum(0).tolist() == [1] * batch
    assert all(flags["noperm"][act[b % len(act)], b] == 5
               for b in range(batch))
    assert np.array_equal(flags["half"],
                          np.where(slot_valid[:, None], 5, 0)
                          * np.ones((1, batch), np.int32))
    assert not flags["none"].any()


@pytest.mark.parametrize("key", list(RUNS))
def test_every_jax_label_has_a_row(key, runs, capsys):
    rows, out = _run(runs, key, capsys)
    labels = _labels(key)
    assert labels and labels <= set(rows), labels - set(rows)
    for label, row in rows.items():
        if "ms" in row and row["ms"] is None:
            assert row["reason"].startswith("no counterpart"), label
        if None in row.values():
            assert row["reason"], label
        assert all(math.isfinite(v) and v > 0 for v in row.values()
                   if isinstance(v, float)), label
    assert out[0].startswith("card: ") and out[-1].startswith('{"tool"')


# ---- the tools at tiny sizes ----------------------------------------------

@pytest.fixture(scope="module")
def modes():
    capture = probe_rolling.capture_run(16, 16, "cpu")
    rolling, counts = probe_rolling.rolling_run(16, 16, "cpu")
    return capture, rolling, counts


def test_capture_queue_folds_to_mode_b(modes):
    capture, rolling, counts = modes
    profile = probe_rolling.profile_row(capture, counts)
    assert profile["mean_lane_records"] > 0
    assert profile["any_valid"] >= profile["all_valid"] > 0
    assert profile["mode_b_mean_records"] == profile["mean_lane_records"]
    block = compact_slot_rows(capture.wq_meta, capture.wq_value,
                              capture.wq_flags)
    row, (wc, cnt) = k1_times.fold_row(block)
    assert torch.equal(wc, rolling.wc_state)
    assert torch.equal(cnt, rolling.wc_count)
    assert torch.equal(finalize_rolling(wc, cnt),
                       finalize_rolling(rolling.wc_state, rolling.wc_count))
    assert row["records"] == int(counts.sum())


def test_tool_checks_raise_on_a_difference(modes):
    capture, rolling, counts = modes
    with pytest.raises(AssertionError, match="lanes"):
        probe_rolling.profile_row(capture, counts + (
            torch.arange(counts.numel()) == 3).to(torch.int32))
    other = dataclasses.replace(rolling, wc_state=rolling.wc_state.clone())
    other.wc_state[5, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="mode \\(b\\)"):
        probe_rolling.capture_fold(capture, other)


def test_rates_take_only_a_profile_that_holds_every_launch(monkeypatch):
    """device_ms divides by the calls only from a profile that holds each
    launch of K1 and K2; one that misses a launch is taken again, then
    the tool raises (the profiler itself is faked: no card here)."""
    cuda = torch.device("cuda")
    profiles = iter([({"k1": [7, 7.0], "k2": [8, 4.0]}, 0.1),
                     ({"k1": [8, 8.0], "k2": [8, 4.4]}, 0.2)])
    monkeypatch.setattr(probe_rolling, "profile_calls",
                        lambda step, calls: next(profiles))
    row = probe_rolling.device_ms(None, 4, 2, "rolling", cuda)
    assert row["profile_tries"] == 2
    assert (row["k1_device_ms"], row["k2_device_ms"],
            row["other_device_ms"]) == (2.0, 1.1, 0.05)
    monkeypatch.setattr(probe_rolling, "profile_calls",
                        lambda step, calls: ({"k1": [3, 3.6], "k2": [0, 0.0]},
                                             1.6))
    with pytest.raises(AssertionError, match="launches"):
        probe_rolling.device_ms(None, 4, 1, "capture", cuda)
    monkeypatch.setattr(probe_rolling, "profile_calls",
                        lambda step, calls: ({"k1": [4, 6.4], "k2": [0, 0.0]},
                                             1.6))
    row = probe_rolling.device_ms(None, 4, 1, "capture", cuda)
    assert (row["k1_device_ms"], row["k2_device_ms"],
            row["other_device_ms"]) == (1.6, None, 0.4)


def test_foldparts_records_and_permutations(runs, capsys):
    rows, _ = _run(runs, "probe_foldparts", capsys)
    B = 32
    got = {v: (rows[v]["records"] / B, rows[v]["permutations"] / B)
           for v in probe_foldparts.VARIANTS}
    assert got == {"none": (0, 0), "noperm": (1, 0), "half": (112, 56)}


def test_k2_bound_counts_odd_positions():
    gen = torch.Generator().manual_seed(3)
    c0 = torch.randint(-2**31, 2**31 - 1, (64,), generator=gen,
                       dtype=torch.int32)
    n = torch.randint(0, 9, (64,), generator=gen, dtype=torch.int32)
    u0 = c0.numpy().view(np.uint32).astype(np.int64)
    want = sum(((u0[b] + i) & 1) == 1 for b in range(64)
               for i in range(int(n[b])))
    work = k1_times.k2_bound(c0, n)
    assert work["permutations"] == want
    assert work["records"] == int(n.sum())
    assert work["bytes"] == int(n.sum()) * 52 + 64 * (4 + 2 * 204)


def test_rec_words_to_planes_matches_jax():
    import jax.numpy as jnp

    spec = importlib.util.spec_from_file_location(
        "tool_probe_bsfold", ROOT / "tools" / "probe_bsfold.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rec = np.random.RandomState(5).randint(
        0, 2**32, size=(2, 12, 256), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(tool.rec_words_to_planes(jnp.asarray(rec)))
    got = probe_bsfold.rec_words_to_planes(torch.from_numpy(rec.view(
        np.int32)))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_capture_fold_matches_jax_rolling_mode():
    """The port's mode (a) run, its queue compacted and folded, against
    JAX run_cycles in rolling mode: wc_state and wc_count bit for bit."""
    config = _rolling_config(len(PROGRAMS))
    words = [assemble_to_code_words(s) for s in PROGRAMS]
    ref = run_cycles(make_entry_state(config, words, ergs=ERGS), config,
                     N_CYCLES)
    cfg = dataclasses.replace(from_jax_config(config),
                              rolling_commitment=False,
                              queue_capacity=N_CYCLES * 8)
    st = pstate.make_entry_state(cfg, words, ergs=ERGS, device="cpu")
    fused_cycle.run_cycles(st, cfg, N_CYCLES, k_inner=16)
    _, (wc, cnt) = k1_times.fold_row(compact_slot_rows(
        st.wq_meta, st.wq_value, st.wq_flags))
    assert np.array_equal(wc.numpy().view(np.uint32),
                          np.asarray(ref.wc_state))
    assert np.array_equal(cnt.numpy().view(np.uint32),
                          np.asarray(ref.wc_count))
    assert int(cnt.min()) > 0
