"""The tool probes P1-P7 of the port (`era_zk_evm_tpu_torch/tools/`) against
their JAX tools, bit for bit, on the CPU: every wrapper takes its plain
version on a CPU tensor.

  * P1 `keccak_rows2d` against JAX `keccak_f1600_array`, chained: what the
    tool's `keccak_pallas_rows2d` computes (its interpret mode is too slow to
    run here);
  * P2 / P5 against the tool's numpy round `_bitslice_round_np` over 24
    rounds, and against JAX `keccak_f1600_array` through JAX
    `planes_to_states`, at G8 = 1;
  * P3 against a numpy replica of the tool's loop body (`probe_vpu_rate`
    returns only a rate), for the three ops;
  * P4 against JAX `ops/keccak._round` iterated with the tool's constant;
  * P6 against the tool's `kernel` in a `pallas_call` in interpret mode,
    with the arena in the tool's batch-last layout and lane-major; its sums
    against numpy where they wrap mod 2^32, and the rule that picks its
    split;
  * P7 against the tool's `build(variant)` with its B and TILE set to 16 and
    `pallas_call` in interpret mode, for every variant;
  * the copies (bit-slice plan, plane converters) against their originals.
The inputs are made with numpy from a seed.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from era_zk_evm_tpu.ops import keccak as jkeccak
from era_zk_evm_tpu_torch.tools import bisect_fold, probe_keccak, probe_uniform
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool_keccak():
    return _tool("probe_keccak")


def _u32(rng, shape):
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


def _jax_chained(states, iters):
    x = jnp.asarray(states)
    for _ in range(iters):
        x = jkeccak.keccak_f1600_array(x)
    return np.asarray(x)


@pytest.mark.parametrize("tile,unroll", [(8, 1), (16, 2)])
def test_p1_rows2d_matches_jax(tile, unroll):
    states = _u32(np.random.RandomState(1), (16, 25, 2))
    got = probe_keccak.keccak_rows2d(_t(states), 2, tile=tile, unroll=unroll)
    assert np.array_equal(_np(got), _jax_chained(states, 2))


def test_p1_rejects_what_the_tool_asserts():
    states = torch.zeros((16, 25, 2), dtype=torch.int32)
    for tile, iters, unroll in [(12, 2, 1), (32, 2, 1), (8, 3, 2)]:
        with pytest.raises(ValueError):
            probe_keccak.keccak_rows2d(states, iters, tile, unroll)


@pytest.fixture(scope="module")
def planes_case():
    # G8 = 1: 256 states, 8 u32 columns of 32 states each
    return _u32(np.random.RandomState(2), (1600, 8, 1))


@pytest.mark.parametrize("fused", [False, True])
def test_p2_p5_bitslice_match_the_tool_and_jax(tool_keccak, planes_case,
                                               fused):
    f = (probe_keccak.keccak_bitslice_fused if fused
         else probe_keccak.keccak_bitslice)
    got = _np(f(_t(planes_case), 1))
    want = planes_case.reshape(1600, 8)
    for r in range(24):
        want = tool_keccak._bitslice_round_np(want, r)
    assert np.array_equal(got.reshape(1600, 8), want)
    states = np.asarray(jkeccak.planes_to_states(jnp.asarray(planes_case)))
    back = jkeccak.states_to_planes(jnp.asarray(_jax_chained(states, 1)))
    assert np.array_equal(got, np.asarray(back))


def _p3_numpy(rs, op, inner, iters):
    # tools/probe_keccak.py:288-299, the body of probe_vpu_rate's kernel
    rows = len(rs)
    rs = list(rs)
    for _ in range(iters):
        for _ in range(inner // rows):
            if op == "xor":
                rs = [rs[j] ^ rs[(j + 1) % rows] for j in range(rows)]
            elif op == "mix":
                rs = [((rs[j] << 1) | (rs[j] >> 31)) ^ rs[(j + 1) % rows]
                      for j in range(rows)]
            elif op == "andnot":
                rs = [rs[j] ^ (~rs[(j + 1) % rows] & rs[(j + 2) % rows])
                      for j in range(rows)]
    return np.stack(rs)


@pytest.mark.parametrize("op", ["xor", "mix", "andnot"])
@pytest.mark.parametrize("shape", [(8, 8, 4), (16, 32)])
def test_p3_alu_chain_matches_the_tool(op, shape):
    st = _u32(np.random.RandomState(3), shape)
    got = probe_keccak.alu_chain(_t(st), op, inner=48, iters=3)
    assert np.array_equal(_np(got), _p3_numpy(st, op, 48, 3))


def test_p4_round_chain_matches_jax():
    states = _u32(np.random.RandomState(4), (8, 25, 2))
    lo = [jnp.asarray(states[:, i, 0]) for i in range(25)]
    hi = [jnp.asarray(states[:, i, 1]) for i in range(25)]
    for _ in range(5):
        lo, hi = jkeccak._round(lo, hi, jnp.uint32(0x12345678),
                                jnp.uint32(0x9ABCDEF0))
    want = np.stack([np.stack(lo, 1), np.stack(hi, 1)], 2)
    got = probe_keccak.round_chain(_t(states), 5)
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("lane_major", [False, True])
@pytest.mark.parametrize("random_index", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
def test_p6_uniform_gather_matches_the_tool(monkeypatch, mode, random_index,
                                            lane_major):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tool = _tool("probe_mosaic_uniform")
    W, TB, REPS = 64, 8, 4
    for name, value in (("W", W), ("TB", TB), ("REPS", REPS)):
        monkeypatch.setattr(tool, name, value)
    arena, idx = probe_uniform.tool_inputs(W, TB, "cpu", random_index)
    call = pl.pallas_call(
        tool.kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec((8, W, TB), lambda i, *_: (0, 0, 0)),
                      pl.BlockSpec((TB,), lambda i, *_: (0,))],
            out_specs=pl.BlockSpec((8, TB), lambda i, *_: (0, 0))),
        out_shape=jax.ShapeDtypeStruct((8, TB), jnp.uint32),
        interpret=True)
    want = call(jnp.asarray([mode], jnp.int32), jnp.asarray(_np(arena)),
                jnp.asarray(_np(idx)))
    if lane_major:      # the same arena laid out [TB, 8, W]
        arena = arena.permute(2, 0, 1).contiguous()
    got = probe_uniform.uniform_gather(arena, idx, REPS, mode, lane_major)
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("layout", sorted(probe_uniform.WORD_LAYOUTS))
def test_p6_word_reads_match_the_tool(monkeypatch, layout):
    """The word reads compute the tool's function on the same arena laid
    out in K1's word layouts (the tool's kernel in interpret mode, mode 0,
    a random index a lane)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tool = _tool("probe_mosaic_uniform")
    W, TB, REPS = 64, 8, 4
    for name, value in (("W", W), ("TB", TB), ("REPS", REPS)):
        monkeypatch.setattr(tool, name, value)
    arena, idx = probe_uniform.tool_inputs(W, TB, "cpu", True)
    call = pl.pallas_call(
        tool.kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec((8, W, TB), lambda i, *_: (0, 0, 0)),
                      pl.BlockSpec((TB,), lambda i, *_: (0,))],
            out_specs=pl.BlockSpec((8, TB), lambda i, *_: (0, 0))),
        out_shape=jax.ShapeDtypeStruct((8, TB), jnp.uint32),
        interpret=True)
    want = call(jnp.asarray([0], jnp.int32), jnp.asarray(_np(arena)),
                jnp.asarray(_np(idx)))
    words, _ = probe_uniform.tool_inputs(W, TB, "cpu", True,
                                         word_layout=layout)
    got = probe_uniform.word_gather(words, idx, REPS, layout)
    assert np.array_equal(_np(got), np.asarray(want))


def test_p6_index_past_the_arena_reads_zero():
    arena, idx = probe_uniform.tool_inputs(64, 8, "cpu", random_index=True)
    idx[3] = 64
    got = probe_uniform.uniform_gather(arena, idx, 3)
    assert not got[:, 3].any() and got[:, 2].equal(3 * arena[:, idx[2], 2])


@pytest.mark.parametrize("reps", [1, 7, 512])
@pytest.mark.parametrize("layout", ["batch_last", "lane_major"]
                         + sorted(probe_uniform.WORD_LAYOUTS))
def test_p6_sums_wrap_mod_2_32(layout, reps):
    """The wrappers (their plain versions on the CPU) against numpy on an
    arena of values near 2^32, so that the sums of REPS gathers wrap; a
    random index, one lane's past the arena."""
    words = layout in probe_uniform.WORD_LAYOUTS
    rng = np.random.RandomState(18)
    canon = (2**32 - 1 - rng.randint(0, 1000, size=(8, 40, 24))).astype(
        np.uint32)
    idx = rng.randint(0, 40, size=24).astype(np.uint32)
    idx[3] = 40
    take = canon[:, np.minimum(idx, 39), np.arange(24)].astype(np.uint64)
    want = np.where(idx < 40, take * reps % 2**32, 0).astype(np.uint32)
    perm = (probe_uniform.WORD_LAYOUTS[layout][1] if words
            else (2, 0, 1) if layout == "lane_major" else (0, 1, 2))
    arena = _t(canon.transpose(perm))
    got = (probe_uniform.word_gather(arena, _t(idx), reps, layout) if words
           else probe_uniform.uniform_gather(arena, _t(idx), reps, 1,
                                             layout == "lane_major"))
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("tb,words,want", [
    (256, False, 16), (4096, False, 4), (32768, False, 1),
    (256, True, 16), (4096, True, 16), (32768, True, 4), (1, False, 16)])
def test_p6_split_fills_a_quarter_of_the_resident_warps(tb, words, want):
    # the smallest power of two up to 16 whose warps reach 16 an SM of
    # the H100's 132 (8 warps a lane group of 32 for the elements, one for
    # the words)
    warps = (1 if words else 8) * -(-tb // 32)
    s = probe_uniform.split_for(warps, 132)
    assert s == want
    assert s == probe_uniform.SPLIT_MAX or warps * s >= 16 * 132
    assert s == 1 or warps * s // 2 < 16 * 132


def test_p6_split_out_of_range_raises():
    arena, idx = probe_uniform.tool_inputs(64, 8, "cpu")
    with pytest.raises(ValueError):
        probe_uniform.uniform_gather(arena, idx, 3, split=17)
    words, _ = probe_uniform.tool_inputs(64, 8, "cpu",
                                         word_layout="lane_words")
    with pytest.raises(ValueError):
        probe_uniform.word_gather(words, idx, 3, "lane_words", split=-1)


@pytest.mark.parametrize("variant", ["old", "wrapb", "sel", "two"])
def test_p7_fold_matches_the_tool(monkeypatch, variant):
    from jax.experimental import pallas as pl

    tool = _tool("bisect_fold")
    monkeypatch.setattr(tool, "B", 16)
    monkeypatch.setattr(tool, "TILE", 16)
    pallas_call = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: pallas_call(
        *a, **{**k, "interpret": True}))
    rng = np.random.RandomState(7)
    flags = rng.randint(0, 8, size=(tool.KQ, 16)).astype(np.uint32)
    st = _u32(rng, (51, 16))
    st[50] = rng.randint(0, 4, size=16)
    want = np.asarray(tool.build(variant)(jnp.asarray(flags),
                                          jnp.asarray(st)))
    got = bisect_fold.fold(_t(flags), _t(st), variant)
    assert np.array_equal(_np(got), want)


def test_p7_new_is_two():
    rng = np.random.RandomState(8)
    flags, st = _t(rng.randint(0, 8, size=(4, 6)).astype(np.uint32)), \
        _t(_u32(rng, (51, 6)))
    assert torch.equal(bisect_fold.fold(flags, st, "new"),
                       bisect_fold.fold(flags, st, "two"))


def test_bitslice_plan_copy_equals_the_tool(tool_keccak):
    assert probe_keccak.bitslice_round_plan() \
        == tool_keccak._bitslice_round_plan()
    assert probe_keccak.rc_planes().numpy().view(np.uint32).tolist() \
        == jkeccak.rc_planes_np().tolist()


def test_plane_converter_copies_equal_jax():
    states = _u32(np.random.RandomState(9), (512, 25, 2))
    planes = probe_keccak.states_to_planes(_t(states))
    want = np.asarray(jkeccak.states_to_planes(jnp.asarray(states)))
    assert np.array_equal(_np(planes), want)
    assert np.array_equal(_np(probe_keccak.planes_to_states(planes)), states)


@pytest.mark.parametrize("module,argv", [
    (probe_keccak, ["--cpu", "--batch", "256", "--iters", "2", "base",
                    "rows2d_t64_u2", "roundrate_t8", "vpu_andnot_r1_t16",
                    "bitslice_g1", "bitslice_fused_g1"]),
    (probe_uniform, ["--cpu", "--w", "64", "--tb", "16", "--reps", "2"]),
    (probe_uniform, ["--cpu", "--w", "64", "--tb", "16", "--reps", "2",
                     "--random", "--lane-major"]),
    (bisect_fold, ["--cpu", "--batch", "8", "old", "new"]),
])
def test_tool_entry_points_run_on_the_cpu(module, argv):
    out = module.main(argv)
    assert out and all(v > 0 for v in out.values())
