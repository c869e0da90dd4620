"""The CUDA kernels' per-lane bodies, compiled for the host with g++,
against the port's plain torch versions, bit for bit.

The wrappers never take this build (on CPU tensors they run the plain
versions); it checks the kernel sources' lane logic where no card or nvcc
exists: K1's memory-witness body, its storage-enabled (kLog) body, its
precompile (kPrecomp) body with the round-witness splice and its ecrecover
(kEc) body, the ecrecover unit alone, K2's fold, K3's chained
permutation and the probes P1-P7 (csrc/probe_keccak.cu, probe_rate.cu,
probe_uniform.cu, bisect_fold.cu).  The kernels themselves are held against
the plain versions on the card by chip_smoke.py.
"""

import ctypes
import dataclasses
import random

import pytest
import torch

from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.config import (
    SLOTS_PER_CYCLE, VmConfig, from_jax_config,
)
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.ops import keccak
from era_zk_evm_tpu_torch.ops import secp256k1
from era_zk_evm_tpu_torch.tools import bisect_fold, probe_keccak, probe_uniform
from era_zk_evm_tpu_torch.testing import (
    block_programs, ec_programs, log_programs, programs,
)
from era_zk_evm_tpu_torch.witness.rolling import rolling_absorb

from test_batched_vm import (
    BASIC_PROGRAMS, CALL_PROGRAMS, CONTEXT_PROGRAMS, CONTROL_FLOW,
    PTR_PROGRAMS, STACK_PROGRAMS, UMA_PROGRAMS,
)
from test_fused_cycle import _log_config
from test_torch_ecrecover import LANE_PROGRAMS, ec_config
from test_torch_precompile import _shifted, precompile_config
from test_torch_secp256k1 import _edge_cases, _random_cases
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

PROGRAMS = (BASIC_PROGRAMS + CONTROL_FLOW + STACK_PROGRAMS + UMA_PROGRAMS
            + CALL_PROGRAMS + CONTEXT_PROGRAMS + PTR_PROGRAMS
            + list(programs.FAMILY_PROGRAMS.values()))


@pytest.fixture(scope="module")
def host():
    return _build.load_host()


def _config(batch, rolling, queue_capacity, code_words=32):
    return VmConfig(batch=batch, code_words=code_words, stack_words=256,
                    stack_abs_words=64, stack_sp_base=960, heap_words=64,
                    aux_heap_words=16, max_depth=8,
                    queue_capacity=0 if rolling else queue_capacity,
                    rolling_commitment=rolling)


def _host_run(host, st, config, n_cycles, k_inner):
    """fused_cycle.run_cycles with the host build in place of the kernels."""
    block = (fused_cycle.new_slot_block(config, k_inner, "cpu")
             if config.rolling_commitment else None)
    pq_block = fused_cycle.new_pq_block(config, k_inner, "cpu")
    done = 0
    while done < n_cycles:
        k = min(k_inner, n_cycles - done)
        step0 = st.global_step.min()
        args = fused_cycle.k1_args(st, config, k, k, block, step0, pq_block)
        assert host.eravm_k1_host(
            ctypes.byref(args), fused_cycle.ecrecover_instance(config)) == 0
        if pq_block is not None:
            fused_cycle.splice_precompile_rows(st, config, pq_block, k)
        if block is not None:
            ptrs = [x.data_ptr() for x in block]
            assert host.eravm_k2_host(*ptrs, st.wc_state.data_ptr(),
                                      st.wc_count.data_ptr(),
                                      k * SLOTS_PER_CYCLE, config.batch) == 0
        done += k


def _assert_same(a, b):
    a, b = pstate.state_to_numpy(a), pstate.state_to_numpy(b)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"host kernel/plain mismatch in fields: {bad}"


@pytest.mark.parametrize("case", ["queue", "rolling", "no_witness",
                                  "queue_overflow", "workload",
                                  "workload_rolling"])
def test_k1_host_build_matches_plain(host, case):
    if case.startswith("workload"):
        words = [programs.assemble(programs.WORKLOAD)] * 4
        config = _config(4, case.endswith("rolling"), 128 * 8, code_words=16)
        n, k_inner, ergs = 256, 128, (1 << 31) - 1
    else:
        words = [programs.assemble(p) for p in PROGRAMS]
        # overflow: a queue of 5 cycles, so the slots of lanes still
        # running after it clamp and set lane_error
        config = _config(len(words), case == "rolling",
                         {"queue_overflow": 5 * 8, "no_witness": 0}
                         .get(case, 48 * 8 * 2))
        n, k_inner, ergs = 48, 20, 1 << 20
    plain = pstate.make_entry_state(config, words, ergs=ergs, device="cpu")
    kern = pstate.clone_state(plain)
    fused_cycle.run_cycles(plain, config, n, k_inner=k_inner)
    _host_run(host, kern, config, n, k_inner)
    _assert_same(plain, kern)
    if case == "queue_overflow":
        assert kern.lane_error.any()


def test_k2_host_build_matches_plain(host):
    rng = random.Random(11)
    gen = torch.Generator().manual_seed(11)
    B, rows = 37, 24
    meta = torch.randint(-2**31, 2**31 - 1, (rows, 4, B), generator=gen,
                         dtype=torch.int32)
    value = torch.randint(-2**31, 2**31 - 1, (rows, 8, B), generator=gen,
                          dtype=torch.int32)
    flags = torch.tensor([[rng.randrange(8) for _ in range(B)]
                          for _ in range(rows)], dtype=torch.int32)
    wc = torch.randint(-2**31, 2**31 - 1, (B, 25, 2), generator=gen,
                       dtype=torch.int32)
    cnt = torch.tensor([rng.randrange(5) for _ in range(B)], dtype=torch.int32)
    wk, ck = wc.clone(), cnt.clone()
    assert host.eravm_k2_host(meta.data_ptr(), value.data_ptr(),
                              flags.data_ptr(), wk.data_ptr(), ck.data_ptr(),
                              rows, B) == 0
    rolling_absorb(wc, cnt, meta, value, flags)
    assert torch.equal(wk, wc) and torch.equal(ck, cnt)


@pytest.mark.parametrize("run", list(log_programs.RUNS))
def test_k1_log_host_build_matches_plain(host, run):
    # the kLog body on the LOG and far-call program sets, with their
    # storage entries and code banks, in chunks of 40 cycles
    config = from_jax_config(_log_config(log_programs.LANES, 128))
    words, entries, banks = log_programs.stage(run)
    plain = pstate.make_entry_state(config, words, ergs=1 << 20,
                                    device="cpu")
    pstate.populate_storage(plain, config, entries)
    pstate.populate_code_bank(plain, config, banks)
    kern = pstate.clone_state(plain)
    fused_cycle.run_cycles(plain, config, 128, k_inner=40)
    _host_run(host, kern, config, 128, 40)
    _assert_same(plain, kern)
    assert kern.lq_count.any()


def _precompile_lanes(case):
    keccak = block_programs.params.KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS
    sha = block_programs.params.SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS
    if case == "programs":
        return list(block_programs.PRECOMPILE_LANES)
    if case == "mix":
        return [(e, src) for e, src, *_ in block_programs.precompile_mix(16)]
    # overflow: the mix's loops at 16 phases
    return ([(keccak, _shifted(block_programs.keccak_mapping_program(32), k))
             for k in range(9)]
            + [(sha, _shifted(block_programs.sha_rounds_program(32, 2), k))
               for k in range(7)])


@pytest.mark.parametrize("case,n,k_inner,queue", [
    ("programs", 32, 5, True), ("programs", 32, 32, False),
    ("mix", 96, 24, True), ("overflow", 64, 16, True)])
def test_k1_precompile_host_build_matches_plain(host, case, n, k_inner,
                                                 queue):
    # the kPrecomp body, its scratch rows spliced at the block clock after
    # every chunk; without the queue, the units alone
    config = from_jax_config(precompile_config())
    if not queue:
        config = dataclasses.replace(config, precompile_queue_capacity=0)
    lanes = _precompile_lanes(case)
    lanes += [lanes[-1]] * (config.batch - len(lanes))
    words = [programs.assemble(src) for _, src in lanes]
    plain = pstate.make_entry_state(config, words, ergs=1 << 20,
                                    entry_address=[e for e, _ in lanes],
                                    device="cpu")
    kern = pstate.clone_state(plain)
    fused_cycle.run_cycles(plain, config, n, k_inner=k_inner)
    _host_run(host, kern, config, n, k_inner)
    _assert_same(plain, kern)
    # every lane logged a precompile call, but the one short of ergs
    assert int((kern.lq_count > 0).sum()) >= config.batch - 1
    assert bool(kern.pq_count.any()) == queue
    assert bool(kern.lane_error.all()) == (case == "overflow")


@pytest.mark.parametrize("iters", [1, 3])
def test_k3_host_build_matches_plain(host, iters):
    gen = torch.Generator().manual_seed(iters)
    states = torch.randint(-2**31, 2**31 - 1, (37, 25, 2), generator=gen,
                           dtype=torch.int32)
    got = states.clone()
    assert host.eravm_k3_host(got.data_ptr(), got.shape[0], iters) == 0
    assert torch.equal(got, keccak.keccak_f1600(states, iters))


def test_ecrecover_unit_host_build_matches_plain(host):
    # csrc/secp256k1.cuh's ecrecover_unit against ops/secp256k1.py on random
    # signatures and every edge case
    cases = _random_cases(16, 31) + _edge_cases()
    digest, r, s = (torch.tensor(
        [secp256k1.to_limbs(c[i]) for c in cases], dtype=torch.int64)
        .to(torch.int32) for i in (0, 2, 3))
    v = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    ok = torch.zeros(len(cases), dtype=torch.int32)
    addr = torch.zeros((len(cases), 8), dtype=torch.int32)
    assert host.eravm_ecrecover_host(
        digest.data_ptr(), v.data_ptr(), r.data_ptr(), s.data_ptr(),
        ok.data_ptr(), addr.data_ptr(), len(cases)) == 0
    want_ok, want_addr = secp256k1.ecrecover_batched(digest, v, r, s)
    assert torch.equal(ok != 0, want_ok)
    assert torch.equal(addr.to(torch.int64) & 0xFFFFFFFF, want_addr)
    assert 16 <= int(ok.sum()) < len(cases)


@pytest.mark.parametrize("case,queue", [("programs", True),
                                        ("programs", False), ("mix", True)])
def test_k1_ecrecover_host_build_matches_plain(host, case, queue):
    # the kEc body on the ecrecover programs (chunks of 8 cycles, the
    # round-witness rows spliced after each) and on the signed-transfer mix
    config = from_jax_config(ec_config())
    if not queue:
        config = dataclasses.replace(config, precompile_queue_capacity=0)
    lanes = LANE_PROGRAMS if case == "programs" else [
        (e, src) for e, src, *_ in ec_programs.ecrecover_mix(config.batch)]
    plain = pstate.make_entry_state(
        config, [programs.assemble(src) for _, src in lanes], ergs=1 << 20,
        entry_address=[e for e, _ in lanes], device="cpu")
    kern = pstate.clone_state(plain)
    # the programs end by cycle 35; the transfers run on
    cycles = 40 if case == "programs" else 64
    fused_cycle.run_cycles(plain, config, cycles, k_inner=8)
    _host_run(host, kern, config, cycles, 8)
    _assert_same(plain, kern)
    assert bool(kern.pq_count.any()) == queue
    assert int(kern.lane_error.sum()) == (case == "programs")


def _random_i32(seed, shape):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         dtype=torch.int32)


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_p1_host_build_matches_plain(host, unroll):
    states = _random_i32(unroll, (24, 25, 2))
    rows = states.reshape(24, 50).T.contiguous()
    assert host.eravm_p1_host(rows.data_ptr(), 24, 4, unroll) == 0
    assert torch.equal(rows.T.reshape(24, 25, 2),
                       probe_keccak.keccak_rows2d(states, 4, 8, unroll))


@pytest.mark.parametrize("fused", [0, 1])
def test_p2_p5_host_build_matches_plain(host, fused):
    planes = _random_i32(11, (1600, 8, 1))
    state, scratch = planes.clone(), torch.empty_like(planes)
    assert host.eravm_p2_host(state.data_ptr(), scratch.data_ptr(), 8, 1,
                              fused) == 0
    assert torch.equal(state, probe_keccak.keccak_bitslice_plain(planes, 1))


@pytest.mark.parametrize("op", ["xor", "mix", "andnot"])
def test_p3_host_build_matches_plain(host, op):
    # 3 x (40 // 8) steps: a remainder after the unrolled trips
    st = _random_i32(8, (8, 24))
    got = st.clone()
    assert host.eravm_p3_host(got.data_ptr(), 8, 24, 15,
                              ["xor", "mix", "andnot"].index(op)) == 0
    assert torch.equal(got, probe_keccak.alu_chain_plain(st, op, 40, 3))


def test_p4_host_build_matches_plain(host):
    states = _random_i32(12, (9, 25, 2))
    got = states.clone()
    assert host.eravm_p4_host(got.data_ptr(), 9, 7) == 0
    assert torch.equal(got, probe_keccak.round_chain_plain(states, 7))


@pytest.mark.parametrize("lane_major", [False, True])
@pytest.mark.parametrize("random_index", [False, True])
def test_p6_host_build_matches_plain(host, random_index, lane_major):
    arena, idx = probe_uniform.tool_inputs(48, 40, "cpu", random_index,
                                           lane_major)
    idx[5] = 48                                   # past the arena: reads 0
    out = torch.empty((8, 40), dtype=torch.int32)
    assert host.eravm_p6_host(arena.data_ptr(), idx.data_ptr(),
                              out.data_ptr(), 48, 40, 5, lane_major) == 0
    assert torch.equal(out, probe_uniform.uniform_gather_plain(
        arena, idx, 5, lane_major))


@pytest.mark.parametrize("variant", ["old", "wrapb", "sel", "two"])
def test_p7_host_build_matches_plain(host, variant):
    gen = torch.Generator().manual_seed(13)
    flags = torch.randint(0, 8, (bisect_fold.KQ, 33), generator=gen,
                          dtype=torch.int32)
    st = _random_i32(14, (51, 33))
    st[50] = torch.randint(0, 4, (33,), generator=gen, dtype=torch.int32)
    got = st.clone()
    assert host.eravm_p7_host(flags.data_ptr(), got.data_ptr(), 33,
                              bisect_fold.KQ,
                              bisect_fold.VARIANTS[variant]) == 0
    assert torch.equal(got, bisect_fold.fold_plain(flags, st, variant))
