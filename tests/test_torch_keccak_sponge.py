"""The port's ragged keccak256 sponge (`ops.keccak.keccak256_ragged`, its
kernel `csrc/keccak_sponge.cu`) against the golden keccak256 of the JAX
package (`era_zk_evm_tpu/golden/precompiles.py`, pure Python), bit for bit.

Two things are held against the golden digests and against each other: the
plain version `keccak256_ragged_plain` (what the wrapper runs on CPU
tensors) and the kernel's per-stream body compiled with g++
(`eravm_k3s_host`).  The streams are made with numpy from a seed: the edge
lengths around a 34-word rate block (the empty stream, n % 34 in {0, 1,
33}, two blocks of padding alone), a mixed batch of 64 random lengths, and
one stream of the block fold's shape (8192 digests, 1928 blocks).  Then the
block path's entries on the CPU: `commit_packed_streams` and
`fold_digests_device` (the ragged sponge through `stream_digests` /
`fold_digest_rows`).  Nothing here compiles an XLA program."""

import numpy as np
import pytest
import torch

from era_zk_evm_tpu.golden.precompiles import keccak256
from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.ops import keccak
from era_zk_evm_tpu_torch.witness import packed

from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

EDGE_LENGTHS = (0, 1, 33, 34, 35, 67, 68)
#: the block fold's shape: 8192 tx digests of 8 words, 1928 rate blocks
FOLD_DIGESTS = 8192


def _streams(lengths, rng) -> list[np.ndarray]:
    return [rng.integers(0, 1 << 32, int(n), dtype=np.uint32)
            for n in lengths]


@pytest.fixture(scope="module")
def cases() -> dict:
    rng = np.random.default_rng(20240607)
    return {"edge": _streams(EDGE_LENGTHS, rng),
            "mixed": _streams(rng.integers(0, 12 * 34, 64), rng),
            "fold": _streams([8 * FOLD_DIGESTS], rng)}


def _golden(streams) -> list[bytes]:
    return [keccak256(s.astype("<u4").tobytes()) for s in streams]


def _ragged(streams):
    """(words int32[W], offsets int64[T + 1]) on the CPU."""
    words = np.concatenate(streams) if streams else np.zeros(0, np.uint32)
    offsets = np.zeros(len(streams) + 1, dtype=np.int64)
    np.cumsum([s.size for s in streams], out=offsets[1:])
    return torch.from_numpy(words.view(np.int32)), torch.from_numpy(offsets)


@pytest.fixture(scope="module")
def golden(cases) -> dict:
    return {name: _golden(streams) for name, streams in cases.items()}


@pytest.fixture(scope="module")
def plain(cases) -> dict:
    """The plain version's digests of every case, on one intra-op thread
    (many small torch ops: the fold's 1928 steps take ~9 s once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: packed.digest_bytes(
            keccak.keccak256_ragged_plain(*_ragged(streams)))
            for name, streams in cases.items()}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["edge", "mixed", "fold"])
def test_plain_matches_golden(plain, golden, case):
    assert plain[case] == golden[case]


@pytest.mark.parametrize("case", ["edge", "mixed", "fold"])
def test_host_build_matches_plain(cases, plain, golden, case):
    words, offsets = _ragged(cases[case])
    out = torch.empty((len(cases[case]), 8), dtype=torch.int32)
    assert _build.load_host().eravm_k3s_host(
        words.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        len(cases[case])) == 0
    got = packed.digest_bytes(out)
    assert got == plain[case]
    assert got == golden[case]


def test_wrapper_dispatch(cases, golden):
    """On CPU tensors the wrapper runs the plain version (no launch counted)
    whatever the order; it refuses malformed arguments."""
    words, offsets = _ragged(cases["edge"])
    before = keccak.K3S_LAUNCHES
    order = torch.arange(len(EDGE_LENGTHS) - 1, -1, -1, dtype=torch.int32)
    got = keccak.keccak256_ragged(words, offsets, order)
    assert keccak.K3S_LAUNCHES == before
    assert packed.digest_bytes(got) == golden["edge"]
    empty = keccak.keccak256_ragged(words[:0],
                                    torch.zeros(1, dtype=torch.int64))
    assert tuple(empty.shape) == (0, 8)
    with pytest.raises(ValueError, match="words"):
        keccak.keccak256_ragged(words.to(torch.int64), offsets)
    with pytest.raises(ValueError, match="offsets"):
        keccak.keccak256_ragged(words, offsets.to(torch.int32))
    with pytest.raises(ValueError, match="order"):
        keccak.keccak256_ragged(words, offsets, order[1:])


@pytest.mark.parametrize("width", [1, 16, 32])
def test_commit_packed_streams_matches_golden(cases, golden, width,
                                             one_intra_op_thread):  # noqa: F811
    """The edge and mixed streams as records of `width` words (cut to whole
    records), through the block path's entry on the CPU; their digests'
    fold, and the fold of nothing."""
    streams = [s[:s.size - s.size % width].reshape(-1, width)
               for s in cases["edge"] + cases["mixed"]]
    got = packed.commit_packed_streams(streams, "cpu")
    assert got == _golden(streams)
    assert packed.fold_digests_device(got, "cpu") == keccak256(b"".join(got))
    assert packed.fold_digests_device(got[:17], "cpu") \
        == keccak256(b"".join(got[:17]))         # 136 words: n % 34 == 0
    assert packed.fold_digests_device([], "cpu") == keccak256(b"")


def test_fold_rows_match_golden(cases, golden,
                                one_intra_op_thread):  # noqa: F811
    """`fold_digest_rows` over F digest lists at once (one launch on the
    card): each row the keccak256 of its list's digests."""
    rows = torch.from_numpy(np.stack(
        [np.frombuffer(d, dtype="<u4") for d in golden["mixed"]])
        .view(np.int32))
    folds = packed.digest_bytes(packed.fold_digest_rows(rows.view(4, 16, 8)))
    assert folds == [keccak256(b"".join(golden["mixed"][16 * f:16 * f + 16]))
                     for f in range(4)]
    assert packed.digest_bytes(packed.fold_digest_rows(rows[:0].view(2, 0, 8))
                               ) == [keccak256(b"")] * 2
