"""The compacted record block of the rolling commitment: K2's g++ body
against its plain version `rolling_absorb_rows`, the plain compaction
`compact_slot_rows` against a row-by-row reference, and the compact plain
fold against the dense one (`rolling_absorb`, which tests/test_torch_rolling.py
and tests/test_torch_commitments.py hold against JAX), bit for bit.
No XLA program is compiled here.
"""

import numpy as np
import pytest
import torch

from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.config import VmConfig
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.witness.rolling import (
    compact_slot_rows, finalize_rolling, rolling_absorb, rolling_absorb_rows,
)

from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

ROWS = 24


@pytest.fixture(scope="module")
def host():
    return _build.load_host()


def _i32(rng, shape):
    return torch.from_numpy(
        rng.integers(0, 2**32, size=shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32))


def _dense_block(rng, rows, B, p_valid=0.5):
    """A random dense slot block: valid slots (bit 2) with random rw and ptr
    bits, invalid ones all zero as K1 and the plain engine write them."""
    valid = rng.random((rows, B)) < p_valid
    meta = _i32(rng, (rows, 4, B)) * torch.from_numpy(valid)[:, None, :]
    value = _i32(rng, (rows, 8, B)) * torch.from_numpy(valid)[:, None, :]
    flags = torch.from_numpy(
        (rng.integers(0, 4, size=(rows, B)) | 4) * valid).to(torch.int32)
    return meta, value, flags


def _sponges(rng, B):
    """Random sponges and counts, odd and even alternating across lanes."""
    wc = _i32(rng, (B, 25, 2))
    cnt = torch.from_numpy(rng.integers(0, 1000, size=B) * 2
                           + np.arange(B) % 2).to(torch.int32)
    return wc, cnt


@pytest.mark.parametrize("B", [37, 67])
def test_k2_host_build_matches_rows_plain(host, B):
    # counts 0, 1 and full among random ones; within each 32-lane group the
    # lanes mix counts and wc_count parities
    rng = np.random.default_rng(B)
    meta, value, _ = _dense_block(rng, ROWS, B, p_valid=1.0)
    flags = torch.from_numpy(rng.integers(0, 4, size=(ROWS, B)) | 4) \
        .to(torch.int32)
    count = torch.from_numpy(rng.integers(0, ROWS + 1, size=B)) \
        .to(torch.int32)
    count[0:3] = torch.tensor([0, 1, ROWS])
    count[32:35] = torch.tensor([ROWS, 0, 1])
    wc, cnt = _sponges(rng, B)
    assert len(set((cnt[:32] % 2).tolist())) == 2
    # rows past a lane's count are poison: neither version may read them
    rows = torch.arange(ROWS)[:, None] < count[None, :]
    meta = torch.where(rows[:, None, :], meta, -7)
    value = torch.where(rows[:, None, :], value, -7)
    flags = torch.where(rows, flags, -7)
    wk, ck = wc.clone(), cnt.clone()
    assert host.eravm_k2_host(meta.data_ptr(), value.data_ptr(),
                              flags.data_ptr(), count.data_ptr(),
                              wk.data_ptr(), ck.data_ptr(), ROWS, B) == 0
    want = cnt + count
    rolling_absorb_rows(wc, cnt, meta, value, flags, count)
    assert torch.equal(wk, wc) and torch.equal(ck, cnt)
    assert torch.equal(cnt, want)


def _compact_reference(meta, value, flags):
    """Row by row: each lane's valid slots in slot order, zero rows after."""
    S, B = flags.shape
    out = [torch.zeros_like(x) for x in (meta, value, flags)]
    count = torch.zeros(B, dtype=torch.int32)
    for b in range(B):
        for s in range(S):
            if int(flags[s, b]) & 4:
                r = int(count[b])
                out[0][r, :, b] = meta[s, :, b]
                out[1][r, :, b] = value[s, :, b]
                out[2][r, b] = flags[s, b]
                count[b] += 1
    return (*out, count)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_slot_rows_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    block = _dense_block(rng, ROWS, 41, p_valid=(0.1, 0.5, 0.9)[seed])
    got = compact_slot_rows(*block)
    want = _compact_reference(*block)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[3].dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_compact_fold_matches_dense_fold(seed):
    # rolling_absorb_rows of the compaction == rolling_absorb of the dense
    # block, sponge, count and digest; with every slot valid and none too
    rng = np.random.default_rng(seed)
    B = 40
    p_valid = (0.11, 0.5, 0.9, 1.0, 0.0)[seed]
    block = _dense_block(rng, ROWS, B, p_valid)
    wc, cnt = _sponges(rng, B)
    wd, cd = wc.clone(), cnt.clone()
    rolling_absorb(wd, cd, *block)
    rolling_absorb_rows(wc, cnt, *compact_slot_rows(*block))
    assert torch.equal(wc, wd) and torch.equal(cnt, cd)
    assert torch.equal(finalize_rolling(wc, cnt), finalize_rolling(wd, cd))


def test_rolling_fold_on_cpu_takes_the_rows_plain():
    # the wrapper's CPU branch folds rows 0 .. count - 1 and launches no
    # kernel; the block new_slot_block makes has K1's shapes
    config = VmConfig(batch=6, code_words=16, stack_words=256,
                      stack_abs_words=64, stack_sp_base=960, heap_words=64,
                      aux_heap_words=16, max_depth=8, queue_capacity=0,
                      rolling_commitment=True)
    block = fused_cycle.new_slot_block(config, 3, "cpu")
    assert [tuple(x.shape) for x in block] == [(24, 4, 6), (24, 8, 6),
                                               (24, 6), (6,)]
    rng = np.random.default_rng(7)
    for dst, src in zip(block, compact_slot_rows(*_dense_block(rng, 24, 6))):
        dst.copy_(src)
    wc, cnt = _sponges(rng, 6)
    want_wc, want_cnt = wc.clone(), cnt.clone()
    rolling_absorb_rows(want_wc, want_cnt, *block)
    before = fused_cycle.K2_LAUNCHES
    fused_cycle.rolling_fold(wc, cnt, block)
    assert fused_cycle.K2_LAUNCHES == before
    assert torch.equal(wc, want_wc) and torch.equal(cnt, want_cnt)
