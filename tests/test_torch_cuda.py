"""K1 (all four instances), K2, K3 and the probes P1-P7 against their plain
versions on a CUDA card, and execute_block on the card against the same call
on the CPU (the keccak256 / sha256 mix and the signed-transfer mix).

Imports no jax, so it also runs on the GPU machine, where the suite's
conftest (which configures jax) cannot load:
    pytest --noconftest -m cuda tests/test_torch_cuda.py
Without a card every test here skips.  The full-size comparison is
chip_smoke.py.
"""

import pytest
import torch

from era_zk_evm_tpu_torch.config import VmConfig
from era_zk_evm_tpu_torch.models import batched_vm, fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.ops import keccak
from era_zk_evm_tpu_torch import block
from era_zk_evm_tpu_torch.tools import bisect_fold, probe_keccak, probe_uniform
from era_zk_evm_tpu_torch.testing import (
    block_programs, ec_programs, log_programs, programs,
)
from era_zk_evm_tpu_torch.witness.rolling import rolling_absorb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _config(batch, rolling):
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    stack_abs_words=64, stack_sp_base=960, heap_words=64,
                    aux_heap_words=16, max_depth=8,
                    queue_capacity=0 if rolling else 64 * 8,
                    rolling_commitment=rolling)


@pytest.mark.cuda
@pytest.mark.parametrize("rolling", [False, True])
def test_k1_matches_plain(cuda, rolling):
    words = [programs.assemble(p) for p in programs.FAMILY_PROGRAMS.values()]
    config = _config(len(words), rolling)
    ks = pstate.make_entry_state(config, words, ergs=1 << 20, device=cuda)
    ps = pstate.clone_state(ks)
    before = fused_cycle.K1_LAUNCHES
    fused_cycle.run_cycles(ks, config, 64, k_inner=24)
    assert fused_cycle.K1_LAUNCHES - before == 3
    batched_vm.run_cycles(ps, config, 64)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"


@pytest.mark.cuda
def test_k2_matches_plain(cuda):
    gen = torch.Generator().manual_seed(5)
    B, rows = 300, 40
    meta = torch.randint(-2**31, 2**31 - 1, (rows, 4, B), generator=gen,
                         dtype=torch.int32)
    value = torch.randint(-2**31, 2**31 - 1, (rows, 8, B), generator=gen,
                          dtype=torch.int32)
    flags = torch.randint(0, 8, (rows, B), generator=gen, dtype=torch.int32)
    wc = torch.randint(-2**31, 2**31 - 1, (B, 25, 2), generator=gen,
                       dtype=torch.int32)
    cnt = torch.randint(0, 5, (B,), generator=gen, dtype=torch.int32)
    block = tuple(x.to(cuda) for x in (meta, value, flags))
    wk, ck = wc.to(cuda), cnt.to(cuda)
    fused_cycle.rolling_fold(wk, ck, block, rows)
    rolling_absorb(wc, cnt, meta, value, flags)
    assert torch.equal(wk.cpu(), wc) and torch.equal(ck.cpu(), cnt)


@pytest.mark.cuda
def test_k1_rejects_a_wrong_layout(cuda):
    config = _config(2, rolling=False)
    words = [programs.assemble(programs.WORKLOAD)] * 2
    st = pstate.make_entry_state(config, words, device=cuda)
    st.regs = st.regs.transpose(1, 2)          # not contiguous
    with pytest.raises(ValueError):
        fused_cycle.cycle_chunk(st, config, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("run", list(log_programs.RUNS))
def test_k1_log_matches_plain(cuda, run):
    # the storage-enabled instance on the LOG and far-call program sets
    config = VmConfig(batch=log_programs.LANES, code_words=32,
                      stack_words=256, stack_abs_words=64, stack_sp_base=960,
                      heap_words=64, aux_heap_words=16, max_depth=8,
                      queue_capacity=128 * 8 * 2, storage_slots=8,
                      journal_slots=16, event_slots=16,
                      log_queue_capacity=256, heap_frames=4, code_pages=4,
                      decommit_queue_capacity=256)
    words, entries, banks = log_programs.stage(run)
    ks = pstate.make_entry_state(config, words, ergs=1 << 20, device=cuda)
    pstate.populate_storage(ks, config, entries)
    pstate.populate_code_bank(ks, config, banks)
    ps = pstate.clone_state(ks)
    fused_cycle.run_cycles(ks, config, 128, k_inner=40)
    batched_vm.run_cycles(ps, config, 128)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert ks.lq_count.any()


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 5])
def test_k3_matches_plain(cuda, iters):
    gen = torch.Generator().manual_seed(iters)
    states = torch.randint(-2**31, 2**31 - 1, (1000, 25, 2), generator=gen,
                           dtype=torch.int32)
    before = keccak.K3_LAUNCHES
    got = keccak.keccak_f1600(states.to(cuda), iters)
    assert keccak.K3_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), keccak.keccak_f1600(states, iters))
    inplace = states.to(cuda)
    assert keccak.keccak_f1600_(inplace, iters) is inplace
    assert keccak.K3_LAUNCHES == before + 2
    assert torch.equal(inplace.cpu(), got.cpu())


def _precompile_config(batch, chunk=32):
    # tests/test_torch_precompile.py::precompile_config
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    stack_abs_words=64, stack_sp_base=960, heap_words=32,
                    aux_heap_words=16, max_depth=8, queue_capacity=4 * chunk * 8,
                    storage_slots=8, journal_slots=64, event_slots=16,
                    log_queue_capacity=4 * chunk, heap_frames=2, code_pages=2,
                    decommit_queue_capacity=4 * chunk,
                    precompile_keccak_blocks=2, precompile_sha_rounds=2,
                    precompile_queue_capacity=chunk * 11)


@pytest.mark.cuda
@pytest.mark.parametrize("k_inner", [5, 32])
def test_k1_precompile_matches_plain(cuda, k_inner):
    # the kPrecomp instance and the round-witness splice on the precompile
    # programs and the precompile mix, 96 cycles
    lanes = list(block_programs.PRECOMPILE_LANES) + [
        (e, src) for e, src, *_ in block_programs.precompile_mix(17, seed=3)]
    config = _precompile_config(len(lanes))
    ks = pstate.make_entry_state(
        config, [programs.assemble(src) for _, src in lanes], ergs=1 << 20,
        entry_address=[e for e, _ in lanes], device=cuda)
    ps = pstate.clone_state(ks)
    before = fused_cycle.K1_PRECOMPILE_LAUNCHES
    fused_cycle.run_cycles(ks, config, 96, k_inner=k_inner)
    assert fused_cycle.K1_PRECOMPILE_LAUNCHES - before == -(-96 // k_inner)
    batched_vm.run_cycles(ps, config, 96)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert ks.pq_count.any()


def _ec_config(batch, chunk=32):
    # tests/test_torch_ecrecover.py::ec_config at `batch` lanes
    return VmConfig(batch=batch, code_words=64, stack_words=2048,
                    heap_words=64, max_depth=8, queue_capacity=96 * 8,
                    storage_slots=16, journal_slots=32, event_slots=32,
                    log_queue_capacity=96, heap_frames=2, code_pages=2,
                    decommit_queue_capacity=96, precompile_keccak_blocks=3,
                    precompile_sha_rounds=3, precompile_ecrecover=True,
                    precompile_queue_capacity=chunk * 16)


@pytest.mark.cuda
@pytest.mark.parametrize("k_inner", [8, 32])
def test_k1_ecrecover_matches_plain(cuda, k_inner):
    # the kEc instance on the ecrecover programs and the signed-transfer
    # mix, 64 cycles, against the plain cycle step on the card
    lanes = ec_programs.EC_LANES + [
        (e, src) for e, src, *_ in ec_programs.ecrecover_mix(17, seed=3)]
    config = _ec_config(len(lanes))
    ks = pstate.make_entry_state(
        config, [programs.assemble(src) for _, src in lanes], ergs=1 << 20,
        entry_address=[e for e, _ in lanes], device=cuda)
    ps = pstate.clone_state(ks)
    before = fused_cycle.K1_ECRECOVER_LAUNCHES
    fused_cycle.run_cycles(ks, config, 64, k_inner=k_inner)
    assert fused_cycle.K1_ECRECOVER_LAUNCHES - before == -(-64 // k_inner)
    batched_vm.run_cycles(ps, config, 64)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert ks.pq_count.any()


def _block_on_card_and_cpu(cuda, config, txs, kw, counter):
    before = getattr(fused_cycle, counter)
    got = block.execute_block(config, txs, device=cuda, **kw)
    assert getattr(fused_cycle, counter) > before
    want = block.execute_block(config, txs, device="cpu", **kw)
    assert got.all_ok and want.all_ok
    for a, b in zip(want.txs, got.txs):
        assert (a.tx, a.status, a.cycles) == (b.tx, b.status, b.cycles)
        assert (a.registers == b.registers).all()
        assert sorted(a.streams) == sorted(b.streams)
        for name in a.streams:
            assert (a.streams[name] == b.streams[name]).all()
        assert a.net_states == b.net_states
    assert want.tx_commitments == got.tx_commitments
    assert want.commitments == got.commitments
    assert want.sorted_log_products == got.sorted_log_products
    assert want.block_log_product == got.block_log_product


@pytest.mark.cuda
def test_execute_block_on_the_card_matches_the_cpu(cuda):
    txs = [block.TxSpec(program=programs.assemble(src), ergs=1 << 22,
                        entry_address=entry, cost_hint=n)
           for entry, src, n, _ in block_programs.precompile_mix(40, seed=3)]
    kw = dict(chunk=32, order="cost_desc", refill_frac=0.25,
              tail_chunk_mult=1, adaptive_chunk=True,
              drain_compact_frac={"memory": 0.5, "log": 0.5, "decommit": 0.5,
                                  "precompile": 0.5})
    _block_on_card_and_cpu(cuda, _precompile_config(8), txs, kw,
                           "K1_PRECOMPILE_LAUNCHES")


@pytest.mark.cuda
def test_execute_block_ecrecover_on_the_card_matches_the_cpu(cuda):
    # 16 signed transfers on 8 lanes, refilled at half the lanes (so the
    # plain CPU run recovers in few distinct cycles)
    txs = [block.TxSpec(program=programs.assemble(src), ergs=1 << 22,
                        entry_address=entry, cost_hint=n)
           for entry, src, n, *_ in ec_programs.ecrecover_mix(16, seed=3)]
    kw = dict(chunk=32, order="cost_desc", refill_frac=0.5,
              tail_chunk_mult=1, adaptive_chunk=True,
              drain_compact_frac={"memory": 0.5, "log": 0.5, "decommit": 0.5,
                                  "precompile": 0.5})
    _block_on_card_and_cpu(cuda, _ec_config(8), txs, kw,
                           "K1_ECRECOVER_LAUNCHES")


def _random_i32(seed, shape):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         dtype=torch.int32)


def _on_card_and_cpu(cuda, fn, count, *inputs):
    """fn on the card (one launch of the probe whose count is named) and on
    the CPU (its plain version), equal."""
    before = getattr(*count)
    got = fn(*(x.to(cuda) for x in inputs))
    assert getattr(*count) == before + 1
    assert torch.equal(got.cpu(), fn(*inputs))


@pytest.mark.cuda
@pytest.mark.parametrize("tile,unroll", [(64, 1), (512, 2), (2048, 4)])
def test_p1_matches_plain(cuda, tile, unroll):
    _on_card_and_cpu(cuda, lambda s: probe_keccak.keccak_rows2d(
        s, 4, tile, unroll), (probe_keccak, "P1_LAUNCHES"),
        _random_i32(1, (4096, 25, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_p2_p5_match_plain(cuda, fused):
    f = (probe_keccak.keccak_bitslice_fused if fused
         else probe_keccak.keccak_bitslice)
    _on_card_and_cpu(cuda, lambda p: f(p, 2),
                     (probe_keccak, "P5_LAUNCHES" if fused else "P2_LAUNCHES"),
                     _random_i32(2, (1600, 8, 5)))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["xor", "mix", "andnot"])
def test_p3_matches_plain(cuda, op):
    _on_card_and_cpu(cuda, lambda s: probe_keccak.alu_chain(s, op, 48, 5),
                     (probe_keccak, "P3_LAUNCHES"),
                     _random_i32(3, (8, 8, 100)))


@pytest.mark.cuda
def test_p4_matches_plain(cuda):
    _on_card_and_cpu(cuda, lambda s: probe_keccak.round_chain(s, 50),
                     (probe_keccak, "P4_LAUNCHES"),
                     _random_i32(4, (300, 25, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("random_index", [False, True])
@pytest.mark.parametrize("lane_major", [False, True])
def test_p6_matches_plain(cuda, mode, random_index, lane_major):
    arena, idx = probe_uniform.tool_inputs(64, 1000, "cpu", random_index,
                                           lane_major)
    idx[7] = 64                                   # past the arena: reads 0
    _on_card_and_cpu(cuda, lambda a, i: probe_uniform.uniform_gather(
        a, i, 9, mode, lane_major), (probe_uniform, "P6_LAUNCHES"), arena,
        idx)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["old", "wrapb", "sel", "two"])
def test_p7_matches_plain(cuda, variant):
    gen = torch.Generator().manual_seed(7)
    flags = torch.randint(0, 8, (bisect_fold.KQ, 700), generator=gen,
                          dtype=torch.int32)
    st = _random_i32(8, (51, 700))
    st[50] = torch.randint(0, 4, (700,), generator=gen, dtype=torch.int32)
    _on_card_and_cpu(cuda, lambda f, s: bisect_fold.fold(f, s, variant),
                     (bisect_fold, "P7_LAUNCHES"), flags, st)
