"""K1 (all four instances), K2, K3, the ragged sponge, the round-witness
splice, the ecrecover unit alone, the keccak256 / sha256 units alone and
the probes P1-P7 against their plain
versions on a CUDA card, execute_block on the card
against the same call on the CPU (the keccak256 / sha256 mix and the
signed-transfer mix), its objects form against its packed form on the
card, the sorted queue and device fold on the card against the CPU, the
segmented executor on K1 against the plain engine, a checkpoint loaded
onto the card, a debug trace on the card against the CPU's, the mesh's
run_block on two shards of the card against one unsharded run, a config
with the precompile units asked for and off on the card against the plain
engine, and the golden differential harness with the engine on the card.

Imports no jax, so it also runs on the GPU machine, where the suite's
conftest (which configures jax) cannot load:
    pytest --noconftest -m cuda tests/test_torch_cuda.py
Without a card every test here skips.  The full-size comparison is
chip_smoke.py.
"""

import dataclasses

import pytest
import torch

from era_zk_evm_tpu_torch.config import VmConfig
from era_zk_evm_tpu_torch.models import batched_vm, executor, fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.models.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from era_zk_evm_tpu_torch.ops import keccak, secp256k1
from era_zk_evm_tpu_torch import block
from era_zk_evm_tpu_torch.tools import bisect_fold, probe_keccak, probe_uniform
from era_zk_evm_tpu_torch.testing import (
    block_programs, ec_programs, log_programs, programs, splice_cases,
    spill_programs, witness_programs,
)
from era_zk_evm_tpu_torch.testing.debug_trace import trace_cycles
from era_zk_evm_tpu_torch.witness import device_fold, packed, sorted_queue
from era_zk_evm_tpu_torch.witness.rolling import rolling_absorb_rows


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
def test_k1_rolling_with_queue_matches_plain(cuda):
    """The rolling commitment beside the memory queue: K1 writes both, K2
    folds the block, equal to the plain engine (digests included)."""
    import dataclasses

    from era_zk_evm_tpu_torch.witness.rolling import finalize_rolling

    words = [programs.assemble(p) for p in programs.FAMILY_PROGRAMS.values()]
    config = dataclasses.replace(_config(len(words), True),
                                 queue_capacity=64 * 8)
    ks = pstate.make_entry_state(config, words, ergs=1 << 20, device=cuda)
    ps = pstate.clone_state(ks)
    fused_cycle.run_cycles(ks, config, 64, k_inner=24)
    batched_vm.run_cycles(ps, config, 64)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert torch.equal(finalize_rolling(ks.wc_state, ks.wc_count),
                       finalize_rolling(ps.wc_state, ps.wc_count))
    assert ks.wq_count.any() and ks.wc_count.any()


@pytest.mark.cuda
def test_k1_records_are_the_plain_compaction(cuda):
    # mode (b): K1's record block (rows below each lane's count, and the
    # counts) against the plain engine's slot rows, compacted
    from era_zk_evm_tpu_torch.witness.rolling import compact_slot_rows

    words = [programs.assemble(p) for p in programs.FAMILY_PROGRAMS.values()]
    config = _config(len(words), True)
    ks = pstate.make_entry_state(config, words, ergs=1 << 20, device=cuda)
    ps = pstate.clone_state(ks)
    block = fused_cycle.new_slot_block(config, 24, cuda)
    fused_cycle.cycle_chunk(ks, config, 24, 24, block)
    dense = tuple(torch.empty(x.shape, dtype=torch.int32, device=cuda)
                  for x in block[:3])
    for c in range(24):
        batched_vm.cycle_step(ps, config, tuple(x[c * 8:(c + 1) * 8]
                                                for x in dense))
    want = compact_slot_rows(*dense)
    assert torch.equal(block[3], want[3]) and int(want[3].max()) > 0
    live = torch.arange(24 * 8, device=cuda)[:, None] < want[3][None, :]
    for got, exp, keep in zip(block[:3], want[:3],
                              (live[:, None], live[:, None], live)):
        assert torch.equal(torch.where(keep, got, 0), exp)


@pytest.mark.cuda
def test_k1_grid_spans_the_sms(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for batch in (4096, 32768):
        threads = fused_cycle.k1_threads(batch)
        assert threads in (32, 64, 128)
        assert -(-batch // threads) >= min(sms, batch // 32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random", "far_call"])
def test_k1_fuzz_matches_plain(cuda, name):
    from era_zk_evm_tpu_torch.testing import fuzz_programs

    config, ks = fuzz_programs.entry_state(name, device=cuda)
    ps = pstate.clone_state(ks)
    fused_cycle.run_cycles(ks, config, fuzz_programs.MAX_CYCLES, k_inner=40)
    batched_vm.run_cycles(ps, config, fuzz_programs.MAX_CYCLES)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert a["done"].all() and not a["lane_error"].any()


@pytest.mark.cuda
def test_k2_matches_plain(cuda):
    # a compacted block: each lane's first count rows, the rest poison;
    # counts 0, 1 and full among random ones, wc_count of both parities
    gen = torch.Generator().manual_seed(5)
    B, rows = 300, 40
    meta = torch.randint(-2**31, 2**31 - 1, (rows, 4, B), generator=gen,
                         dtype=torch.int32)
    value = torch.randint(-2**31, 2**31 - 1, (rows, 8, B), generator=gen,
                          dtype=torch.int32)
    flags = torch.randint(0, 4, (rows, B), generator=gen,
                          dtype=torch.int32) | 4
    count = torch.randint(0, rows + 1, (B,), generator=gen, dtype=torch.int32)
    count[:3] = torch.tensor([0, 1, rows])
    live = torch.arange(rows)[:, None] < count[None, :]
    meta = torch.where(live[:, None, :], meta, -7)
    value = torch.where(live[:, None, :], value, -7)
    flags = torch.where(live, flags, -7)
    wc = torch.randint(-2**31, 2**31 - 1, (B, 25, 2), generator=gen,
                       dtype=torch.int32)
    cnt = torch.randint(0, 5, (B,), generator=gen, dtype=torch.int32)
    block = tuple(x.to(cuda) for x in (meta, value, flags, count))
    wk, ck = wc.to(cuda), cnt.to(cuda)
    before = fused_cycle.K2_LAUNCHES
    fused_cycle.rolling_fold(wk, ck, block)
    torch.cuda.synchronize()
    assert fused_cycle.K2_LAUNCHES == before + 1
    rolling_absorb_rows(wc, cnt, meta, value, flags, count)
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
@pytest.mark.parametrize("iters", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 131072])
def test_k3_matches_plain(cuda, n, iters):
    # the ragged last block (127, 129, 1000), one state, and the
    # fingerprints' shape 131072 x 1; the plain version on the card
    gen = torch.Generator().manual_seed(n + iters)
    states = torch.randint(-2**31, 2**31 - 1, (n, 25, 2), generator=gen,
                           dtype=torch.int32).to(cuda)
    want = keccak.keccak_f1600_plain(states, iters)
    before = keccak.K3_LAUNCHES
    got = keccak.keccak_f1600(states, iters)
    assert keccak.K3_LAUNCHES == before + (iters > 0)
    assert torch.equal(got, want)
    inplace = states.clone()
    assert keccak.keccak_f1600_(inplace, iters) is inplace
    assert keccak.K3_LAUNCHES == before + 2 * (iters > 0)
    assert torch.equal(inplace, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
def test_k3_unaligned_states(cuda, offset):
    # states that start 4, 8 or 12 bytes past a 16-byte boundary stage
    # word by word; 16 bytes past it, by 16-byte loads
    gen = torch.Generator().manual_seed(offset)
    buf = torch.randint(-2**31, 2**31 - 1, (300 * 50 + offset,),
                        generator=gen, dtype=torch.int32).to(cuda)
    states = buf[offset:].view(300, 25, 2)
    want = keccak.keccak_f1600_plain(states, 2)
    head = buf[:offset].clone()
    assert keccak.keccak_f1600_(states, 2) is states
    assert torch.equal(states, want)
    assert torch.equal(buf[:offset], head)


@pytest.mark.cuda
def test_sponge_matches_plain(cuda):
    """The ragged sponge on the edge lengths of a rate block and a mixed
    batch: one launch, equal to the plain version on the CPU; the block
    path's entries (one launch for the digests, one for the folds) too."""
    import numpy as np

    from era_zk_evm_tpu_torch.witness import packed

    rng = np.random.default_rng(7)
    lengths = [0, 1, 33, 34, 35, 67, 68] + list(rng.integers(0, 700, 100))
    streams = [rng.integers(0, 1 << 32, int(n), dtype=np.uint32)
               for n in lengths]
    words = torch.from_numpy(np.concatenate(streams).view(np.int32))
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int64))
    want = keccak.keccak256_ragged(words, offsets)
    before = keccak.K3S_LAUNCHES
    got = keccak.keccak256_ragged(words.to(cuda), offsets.to(cuda))
    assert keccak.K3S_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)
    digests = packed.stream_digests(streams, cuda)
    folds = packed.fold_digest_rows(digests[:100].view(4, 25, 8))
    assert keccak.K3S_LAUNCHES == before + 3
    assert torch.equal(digests.cpu(), want)
    assert torch.equal(folds.cpu(), packed.fold_digest_rows(
        want[:100].view(4, 25, 8)))


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


@pytest.mark.cuda
def test_k1_precompile_unaligned_matches_plain(cuda):
    # the kPrecomp instance on two-block keccak256 inputs at unaligned
    # offsets, one past the units' limit, and sha256 at an odd word
    lanes = list(block_programs.UNALIGNED_LANES)
    config = _precompile_config(len(lanes))
    ks = pstate.make_entry_state(
        config, [programs.assemble(src) for _, src in lanes], ergs=1 << 20,
        entry_address=[e for e, _ in lanes], device=cuda)
    ps = pstate.clone_state(ks)
    fused_cycle.run_cycles(ks, config, 40, k_inner=40)
    batched_vm.run_cycles(ps, config, 40)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert int(ks.lane_error.sum()) == 1


@pytest.mark.cuda
def test_precompile_units_match_plain(cuda):
    # the keccak256 / sha256 units alone on 4096 random calls (every length
    # up to one block past the limit, any offset, frames past the arena's
    # end, offsets past 2**32, sha256 rounds 0 to 3) against the plain
    # version on the CPU
    config = _precompile_config(4096)
    gen = torch.Generator().manual_seed(14)
    n, n_words = 4096, 64
    arena = torch.randint(-2**31, 2**31 - 1, (n_words, 8, n), generator=gen,
                          dtype=torch.int32)
    kind = torch.randint(0, 2, (n,), generator=gen)
    base = torch.randint(0, 2, (n,), generator=gen) * 32
    in_off = torch.randint(0, 40 * 32, (n,), generator=gen)
    in_off[::7] = 2**32 - torch.randint(1, 300, (len(in_off[::7]),),
                                        generator=gen)
    in_len = torch.randint(0, 3 * 136 + 1, (n,), generator=gen)
    rounds = torch.randint(0, 4, (n,), generator=gen)
    call = torch.stack([kind, base, in_off, in_len, rounds], dim=1).to(
        torch.int32)
    before = fused_cycle.PRECOMPILE_UNIT_LAUNCHES
    out, err = fused_cycle.precompile_units(config, arena.to(cuda),
                                            call.to(cuda))
    assert fused_cycle.PRECOMPILE_UNIT_LAUNCHES == before + 1
    want, want_err = fused_cycle.precompile_units(config, arena, call)
    assert torch.equal(out.cpu(), want)
    assert torch.equal(err.cpu(), want_err)
    assert 0 < int(want_err.sum()) < n


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


@pytest.mark.cuda
def test_ecrecover_unit_matches_plain(cuda):
    # the unit alone (a signature a thread) on 256 random signatures and
    # every crafted one, against the plain recovery on the CPU
    cases = [c[:4] for c in ec_programs.ecrecover_vectors(256, seed=5)] \
        + ec_programs.crafted_signatures()
    digest, r, s = (torch.tensor(
        [secp256k1.to_limbs(c[i]) for c in cases], dtype=torch.int64)
        .to(torch.int32) for i in (0, 2, 3))
    v = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    before = secp256k1.EC_UNIT_LAUNCHES
    ok, addr = secp256k1.ecrecover_unit(
        *(t.to(cuda) for t in (digest, v, r, s)))
    assert secp256k1.EC_UNIT_LAUNCHES == before + 1
    want_ok, want_addr = secp256k1.ecrecover_batched(digest, v, r, s)
    assert torch.equal(ok.cpu(), want_ok)
    assert torch.equal(addr.cpu(), want_addr)
    assert int(ok.sum()) >= 256


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(splice_cases.SPLICE_CASES))
def test_splice_matches_plain(cuda, case):
    # the splice kernel against splice_precompile_rows on the CPU, on
    # scratch blocks whose rows past each lane's data rows hold garbage;
    # twice, so that the second launch finds the flag kernel's ticket
    # counter back at 0
    config, plain, block, n = splice_cases.splice_case(case)
    kern, kblock = splice_cases.to_device(plain, block, cuda)
    again = splice_cases.to_device(plain, block, cuda)[0]
    before = fused_cycle.PQ_SPLICE_LAUNCHES
    fused_cycle.splice_rows(kern, config, kblock, n)
    fused_cycle.splice_rows(again, config, kblock, n)
    assert fused_cycle.PQ_SPLICE_LAUNCHES == before + 2
    fused_cycle.splice_precompile_rows(plain, config, block, n)
    for field in splice_cases.SPLICE_FIELDS:
        assert torch.equal(getattr(kern, field).cpu(),
                           getattr(plain, field)), field
        assert torch.equal(getattr(again, field).cpu(),
                           getattr(plain, field)), field
    for field in ("pq_meta", "pq_value", "pq_flags"):
        assert not bool((getattr(kern, field) == splice_cases.GARBAGE).any())


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


@pytest.mark.cuda
def test_objects_block_on_the_card_matches_the_packed_block(cuda):
    txs = [block.TxSpec(program=programs.assemble(src), ergs=1 << 22,
                        entry_address=entry, cost_hint=n)
           for entry, src, n, _ in block_programs.precompile_mix(40, seed=5)]
    config = _precompile_config(8)
    obj = block.execute_block(config, txs, chunk=32, device=cuda,
                              streams="objects")
    pk = block.execute_block(config, txs, chunk=32, device=cuda)
    assert obj.all_ok and pk.all_ok
    for name in ("tx_commitments", "commitments", "sorted_log_products",
                 "block_log_product"):
        assert getattr(obj, name) == getattr(pk, name), name
    for a, b in zip(obj.txs, pk.txs):
        assert (a.cycles, a.net_states) == (b.cycles, b.net_states)
        assert (a.registers == b.registers).all()
        assert sorted(a.streams) == sorted(b.streams)
        for name, stream in a.streams.items():
            assert packed.queries_from_packed(name, b.streams[name]) \
                == stream, (a.tx, name)


@pytest.mark.cuda
def test_sorted_queue_on_the_card_matches_the_cpu(cuda):
    config = witness_programs.sorted_queue_config(8)
    words = [programs.assemble(p) for p in (witness_programs.PROG,
                                            witness_programs.PROG2)] * 4
    st = pstate.make_entry_state(config, words, ergs=1 << 20, device="cpu")
    fused_cycle.run_cycles(st, config, 32)
    card = pstate.state_from_numpy(pstate.state_to_numpy(st), cuda)

    def run(s):
        (lo, hi), valid = sorted_queue.log_queue_fingerprints(s)
        lanes = sorted_queue.grand_product(lo, hi, valid)
        return (lo, hi, valid, *lanes,
                *sorted_queue.block_grand_product(*lanes),
                *sorted_queue.sort_log_queue(s))

    before = keccak.K3_LAUNCHES
    got = run(card)
    assert keccak.K3_LAUNCHES == before + 1
    for a, b in zip(got, run(st)):
        assert torch.equal(a.cpu(), b)
    rows = device_fold.finalize_rolling_device(
        _random_i32(9, (33, 25, 2)), _random_i32(10, (33,)))
    before = keccak.K3S_LAUNCHES
    digest = device_fold.keccak256_device_stream(rows.to(cuda))
    assert keccak.K3S_LAUNCHES == before + 1
    assert torch.equal(digest.cpu(),
                       device_fold.keccak256_device_stream(rows))


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
@pytest.mark.parametrize("shape,iters", [((8, 5), 2), ((1, 1), 3),
                                         ((3, 7), 0), ((3, 7), 3)])
@pytest.mark.parametrize("fused", [False, True])
def test_p2_p5_match_plain(cuda, fused, shape, iters):
    # 40 columns fill whole blocks of warps; 1 and 21 fill no block
    f = (probe_keccak.keccak_bitslice_fused if fused
         else probe_keccak.keccak_bitslice)
    _on_card_and_cpu(cuda, lambda p: f(p, iters),
                     (probe_keccak, "P5_LAUNCHES" if fused else "P2_LAUNCHES"),
                     _random_i32(2, (1600,) + shape))


@pytest.mark.cuda
def test_p6_chain_matches_plain(cuda):
    gen = torch.Generator().manual_seed(6)
    arena = torch.randperm(4096, generator=gen).to(torch.int32)
    start = torch.randint(0, 4096, (96,), generator=gen, dtype=torch.int32)
    _on_card_and_cpu(cuda, lambda a, s: probe_uniform.chain_gather(a, s, 33),
                     (probe_uniform, "P6C_LAUNCHES"), arena, start)


@pytest.mark.cuda
def test_p6_lines_match_plain(cuda):
    _on_card_and_cpu(cuda, lambda a: probe_uniform.line_sum(a, 256, 8, 77),
                     (probe_uniform, "P6C_LAUNCHES"),
                     _random_i32(7, (16 * 8 * 256,)))


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
@pytest.mark.parametrize("layout", sorted(probe_uniform.WORD_LAYOUTS))
@pytest.mark.parametrize("random_index", [False, True])
def test_p6_word_reads_match_plain(cuda, random_index, layout):
    arena, idx = probe_uniform.tool_inputs(64, 1000, "cpu", random_index,
                                           word_layout=layout)
    idx[7] = 64                                   # past the arena: reads 0
    _on_card_and_cpu(cuda, lambda a, i: probe_uniform.word_gather(
        a, i, 9, layout), (probe_uniform, "P6_LAUNCHES"), arena, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("tb", [77, 1000])
@pytest.mark.parametrize("reps", [1, 7, 37])
@pytest.mark.parametrize("split", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("layout", ["batch_last", "lane_major"]
                         + sorted(probe_uniform.WORD_LAYOUTS))
def test_p6_split_matches_plain(cuda, layout, split, reps, tb):
    # S warps sharing a lane group's gathers, REPS below S and not a
    # multiple of it, TB not a multiple of 32; an index past the arena;
    # values near 2^32, so the sums wrap
    words = layout in probe_uniform.WORD_LAYOUTS
    arena, idx = probe_uniform.tool_inputs(64, tb, "cpu", True,
                                           layout == "lane_major",
                                           layout if words else None)
    arena = -1 - arena                       # 2^32 - 1, 2^32 - 2, ...
    idx[7] = 64
    if words:
        fn = lambda a, i: probe_uniform.word_gather(  # noqa: E731
            a, i, reps, layout, split)
    else:
        fn = lambda a, i: probe_uniform.uniform_gather(  # noqa: E731
            a, i, reps, 1, layout == "lane_major", split)
    _on_card_and_cpu(cuda, fn, (probe_uniform, "P6_LAUNCHES"), arena, idx)


@pytest.mark.cuda
def test_p6_empty_launch_counts(cuda):
    before = probe_uniform.P6C_LAUNCHES
    probe_uniform.empty_launch(cuda)
    torch.cuda.synchronize()
    assert probe_uniform.P6C_LAUNCHES == before + 1


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


def _segment_config(batch):
    # tests/test_executor.py's tight geometry with bench_farcall's stack
    return VmConfig(batch=batch, code_words=64, stack_words=256,
                    stack_abs_words=64, stack_sp_base=960, heap_words=16,
                    aux_heap_words=8, max_depth=15, queue_capacity=6 * 8,
                    storage_slots=8, journal_slots=64, event_slots=64,
                    log_queue_capacity=16, heap_frames=4, code_pages=3,
                    decommit_queue_capacity=16)


def _segment_programs(batch, callees):
    return [spill_programs.caller(callees[b % 4:] + callees[:b % 4],
                                  1000 * (b + 1), 12 + b % 5, 4 + b % 3)
            for b in range(batch)]


@pytest.mark.cuda
def test_segmented_executor_k1_matches_plain(cuda):
    # every segment and replay on K1 against the plain engine on the CPU:
    # every state field, host store and drained stream
    callees = spill_programs.callees(4)
    config = _segment_config(8)
    runs = []
    for dev, engine in ((cuda, fused_cycle.run_cycles),
                        ("cpu", batched_vm.run_cycles)):
        st = spill_programs.stage(config, _segment_programs(8, callees),
                                  callees, callees[:2], dev)
        hosts = spill_programs.cold_code_hosts(config, callees[2:])
        before = fused_cycle.K1_LAUNCHES
        runs.append(executor.run_block_segments(st, config, engine, 240, 6,
                                                hosts=hosts)
                    + (fused_cycle.K1_LAUNCHES - before,))
    (k_st, k_hosts, k_got, k1), (p_st, p_hosts, p_got, _) = runs
    assert k1 >= 240 // 6 and bool(k_st.done.all())
    assert not bool(k_st.lane_error.any())
    a, b = pstate.state_to_numpy(k_st), pstate.state_to_numpy(p_st)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert k_got == p_got
    for kh, ph in ((k_hosts.storage, p_hosts.storage),
                   (k_hosts.code, p_hosts.code)):
        assert [sorted(m) for m in kh.maps] == [sorted(m) for m in ph.maps]
    assert all(k_hosts.storage.maps) and all(k_hosts.code.maps)


@pytest.mark.cuda
def test_load_checkpoint_onto_the_card(cuda, tmp_path):
    config = VmConfig(batch=4, queue_capacity=512, heap_words=16,
                      stack_words=2048, code_words=16, max_depth=4,
                      rolling_commitment=True)
    words = [programs.assemble(programs.WORKLOAD)] * 4
    cpu = pstate.make_entry_state(config, words, ergs=1 << 20, device="cpu")
    fused_cycle.run_cycles(cpu, config, 15)
    save_checkpoint(tmp_path / "ckpt", cpu, config)
    loaded, loaded_cfg = load_checkpoint(tmp_path / "ckpt")
    assert loaded_cfg == config and loaded.done.device.type == "cuda"
    before = fused_cycle.K1_LAUNCHES
    fused_cycle.run_cycles(loaded, config, 25)
    assert fused_cycle.K1_LAUNCHES > before
    fused_cycle.run_cycles(cpu, config, 25)
    a, b = pstate.state_to_numpy(loaded), pstate.state_to_numpy(cpu)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"resumed on the card != CPU in fields: {bad}"


@pytest.mark.cuda
def test_trace_on_the_card_matches_the_cpu(cuda):
    callees = spill_programs.callees(4)
    config = dataclasses.replace(_segment_config(4), queue_capacity=64 * 8,
                                 log_queue_capacity=64, code_pages=5,
                                 storage_slots=32, heap_frames=8,
                                 decommit_queue_capacity=64)
    words = [spill_programs.caller(callees, 1000 * (b + 1), 3, 4)
             for b in range(4)]
    traces = []
    for dev in (cuda, "cpu"):
        st = spill_programs.stage(config, words, callees, callees, dev)
        before = fused_cycle.K1_LAUNCHES
        traces.append(trace_cycles(st, config, 64, lanes=[0, 3],
                                   with_registers=True)[1])
        launches = fused_cycle.K1_LAUNCHES - before
        assert launches == (64 if dev is cuda else 0)
    assert traces[0] == traces[1]
    assert any("far_call" in s.asm for s in traces[0][0])
    assert not any(s.lane_error for s in traces[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("rolling", [False, True])
def test_run_block_on_two_shards_matches_unsharded(cuda, rolling):
    """parallel.run_block on a mesh of [cuda:0] * 2 equals one unsharded
    run on the card, every field and the aggregates."""
    from era_zk_evm_tpu_torch.parallel import make_mesh, run_block, shard_state
    from era_zk_evm_tpu_torch.parallel.mesh import block_aggregates

    words = [programs.assemble(p) for p in programs.FAMILY_PROGRAMS.values()]
    words += words[:len(words) % 2]
    config = _config(len(words), rolling)
    one = pstate.make_entry_state(config, words, ergs=1 << 20, device=cuda)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 2)
    sharded = shard_state(pstate.clone_state(one), mesh)
    before = fused_cycle.K1_LAUNCHES
    sharded, agg = run_block(sharded, config, 48, k_inner=24)
    assert fused_cycle.K1_LAUNCHES - before == 4
    fused_cycle.run_cycles(one, config, 48, k_inner=24)
    a = pstate.state_to_numpy(one)
    b = pstate.state_to_numpy(sharded.gather(cuda))
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"sharded/unsharded mismatch in fields: {bad}"
    want = block_aggregates(one, config)
    for k in want:
        assert torch.equal(agg[k].cpu(), want[k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["X", "Y"])
def test_units_off_config_on_the_card_matches_plain(cuda, name):
    """Configs X and Y (testing/units_off.py: the precompile units,
    ecrecover or a precompile queue asked for without what they need)
    through K1 on the card, equal to the plain engine on the CPU."""
    from era_zk_evm_tpu_torch.testing import units_off

    config = units_off.configs(3)[name]
    words = [programs.assemble(s) for s in units_off.PROGRAMS]
    ks, ps = (pstate.make_entry_state(config, words, ergs=units_off.ERGS,
                                      entry_address=units_off.ENTRY,
                                      device=d) for d in (cuda, "cpu"))
    before = fused_cycle.K1_LAUNCHES
    fused_cycle.run_cycles(ks, config, units_off.N_CYCLES)
    assert fused_cycle.K1_LAUNCHES - before == 1
    fused_cycle.run_cycles(ps, config, units_off.N_CYCLES)
    a, b = pstate.state_to_numpy(ks), pstate.state_to_numpy(ps)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"kernel/plain mismatch in fields: {bad}"
    assert a["lane_error"].tolist() == units_off.LANE_ERRORS[name]


@pytest.mark.cuda
def test_diff_run_on_the_card(cuda):
    """The golden-backed differential harness with the engine on the card
    (K1's kLog instance), on the far-call programs and their contracts."""
    from era_zk_evm_tpu_torch.testing.differential import diff_run

    before = fused_cycle.K1_LAUNCHES
    diff_run(log_programs.FAR_PROGRAMS, contracts=log_programs.CONTRACTS,
             max_cycles=128, device=cuda)
    assert fused_cycle.K1_LAUNCHES > before
