"""K1 (both instances), K2 and K3 against their plain versions on a CUDA
card.

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
from era_zk_evm_tpu_torch.testing import log_programs, programs
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
