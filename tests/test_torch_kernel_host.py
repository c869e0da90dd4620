"""The CUDA kernels' per-lane bodies, compiled for the host with g++,
against the port's plain torch versions, bit for bit.

The wrappers never take this build (on CPU tensors they run the plain
versions); it checks the kernel sources' lane logic where no card or nvcc
exists: K1's memory-witness body, its storage-enabled (kLog) body, its
precompile (kPrecomp) body with the round-witness splice and its ecrecover
(kEc) body, the ecrecover unit alone (with its field arithmetic and its
endomorphism split against Python ints), the keccak256 / sha256 units
alone (against the JAX package's golden hashes), the splice kernel's body,
K1's compacted record block, K2's fold of it, K3's chained
permutation and the probes P1-P7 (csrc/probe_keccak.cu, probe_rate.cu,
probe_uniform.cu, bisect_fold.cu; P2 / P5 a warp a column, over 32
emulated lanes, with rho's lane map).  The kernels themselves are held against
the plain versions on the card by chip_smoke.py.
"""

import copy
import ctypes
import dataclasses
import random

import pytest
import torch

import numpy as np

from era_zk_evm_tpu.golden.precompiles import (
    SHA256_IV, ecrecover_inner, keccak256, keccak_f1600 as golden_f1600,
    sha256_compress,
)

from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.config import (
    VmConfig, from_jax_config, precompile_queue_slots,
)
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.ops import keccak
from era_zk_evm_tpu_torch.ops import secp256k1
from era_zk_evm_tpu_torch.tools import bisect_fold, probe_keccak, probe_uniform
from era_zk_evm_tpu_torch.testing import (
    block_programs, ec_programs, log_programs, programs, splice_cases,
)
from era_zk_evm_tpu_torch.witness.rolling import (
    compact_slot_rows, rolling_absorb_rows,
)

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


def _host_run(host, st, config, n_cycles, k_inner, blocks=None):
    """fused_cycle.run_cycles with the host build in place of the kernels.
    The record block's rows are poisoned before each chunk (K2 must read
    only the rows below a lane's count), and so are the round-witness
    scratch rows (the splice must read only the rows that K1's emit words
    name); `blocks`, when given, receives a copy of each chunk's block as
    K1 wrote it."""
    block = (fused_cycle.new_slot_block(config, k_inner, "cpu")
             if config.rolling_commitment else None)
    pq_block = fused_cycle.new_pq_block(config, k_inner, "cpu")
    done = 0
    while done < n_cycles:
        k = min(k_inner, n_cycles - done)
        if block is not None:
            for x in block:
                x.fill_(-7)
        if pq_block is not None:
            for x in pq_block[:3]:
                x.fill_(splice_cases.GARBAGE)
        step0 = st.global_step.min()
        args = fused_cycle.k1_args(st, config, k, k, block, step0, pq_block)
        assert host.eravm_k1_host(
            ctypes.byref(args), fused_cycle.ecrecover_instance(config)) == 0
        if pq_block is not None:
            _host_splice(host, st, config, pq_block, k)
        if block is not None:
            if blocks is not None:
                blocks.append(tuple(x.clone() for x in block))
            ptrs = [x.data_ptr() for x in block]
            assert host.eravm_k2_host(*ptrs, st.wc_state.data_ptr(),
                                      st.wc_count.data_ptr(),
                                      block[0].shape[0], config.batch) == 0
        done += k


def _host_splice(host, st, config, pq_block, n):
    """The splice kernel's host build (csrc/pq_splice.cu), in place."""
    scratch = torch.empty(host.eravm_pq_splice_scratch(
        config.batch, n, pq_block[0].shape[1]), dtype=torch.int32)
    args = fused_cycle.splice_args(st, config, pq_block, n, scratch)
    assert host.eravm_pq_splice_host(ctypes.byref(args)) == 0


def assert_compacted(got, want):
    """Two compacted blocks (meta, value, flags, count) agree: the counts,
    and every row below a lane's count."""
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        n = w.shape[0]
        keep = (torch.arange(n)[:, None] < want[3][None, :]).reshape(
            n, *([1] * (w.dim() - 2)), w.shape[-1])
        assert torch.equal(torch.where(keep, g[:n], 0),
                           torch.where(keep, w, 0))


def _assert_same(a, b):
    a, b = pstate.state_to_numpy(a), pstate.state_to_numpy(b)
    bad = [k for k in a if not (a[k] == b[k]).all()]
    assert not bad, f"host kernel/plain mismatch in fields: {bad}"


@pytest.mark.parametrize("case", ["queue", "rolling", "no_witness",
                                  "queue_overflow", "workload",
                                  "workload_rolling"])
def test_k1_host_build_matches_plain(host, case, monkeypatch):
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
    # the plain engine's dense slot rows of each chunk, as the CPU path
    # hands them to the compaction
    dense = []

    def spy(*rows):
        dense.append(tuple(x.clone() for x in rows))
        return compact_slot_rows(*rows)

    monkeypatch.setattr(fused_cycle, "compact_slot_rows", spy)
    fused_cycle.run_cycles(plain, config, n, k_inner=k_inner)
    blocks = []
    _host_run(host, kern, config, n, k_inner, blocks)
    _assert_same(plain, kern)
    if case == "queue_overflow":
        assert kern.lane_error.any()
    # K1's record block is the plain compaction of the dense rows
    assert len(blocks) == len(dense) == (
        -(-n // k_inner) if config.rolling_commitment else 0)
    for got, rows in zip(blocks, dense):
        assert_compacted(got, compact_slot_rows(*rows))
    if config.rolling_commitment:
        assert 0 < int(blocks[0][3].max()) < blocks[0][0].shape[0]


def test_k2_host_build_matches_plain(host):
    # K2 over a compacted block: each lane's first count rows
    rng = random.Random(11)
    gen = torch.Generator().manual_seed(11)
    B, rows = 37, 24
    meta = torch.randint(-2**31, 2**31 - 1, (rows, 4, B), generator=gen,
                         dtype=torch.int32)
    value = torch.randint(-2**31, 2**31 - 1, (rows, 8, B), generator=gen,
                          dtype=torch.int32)
    flags = torch.tensor([[rng.randrange(8) | 4 for _ in range(B)]
                          for _ in range(rows)], dtype=torch.int32)
    count = torch.tensor([rng.randrange(rows + 1) for _ in range(B)],
                         dtype=torch.int32)
    wc = torch.randint(-2**31, 2**31 - 1, (B, 25, 2), generator=gen,
                       dtype=torch.int32)
    cnt = torch.tensor([rng.randrange(5) for _ in range(B)], dtype=torch.int32)
    wk, ck = wc.clone(), cnt.clone()
    assert host.eravm_k2_host(meta.data_ptr(), value.data_ptr(),
                              flags.data_ptr(), count.data_ptr(),
                              wk.data_ptr(), ck.data_ptr(), rows, B) == 0
    rolling_absorb_rows(wc, cnt, meta, value, flags, count)
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


def test_k1_precompile_unaligned_host_build_matches_plain(host):
    # the kPrecomp body on inputs the mix never has: two-block keccak256
    # calls at unaligned offsets (the limb-level absorb's funnel shift by
    # in_off & 3 bytes and its chunk offset), one past the units' limit, and
    # sha256 at an odd word
    lanes = list(block_programs.UNALIGNED_LANES)
    config = from_jax_config(precompile_config())
    lanes += [lanes[0]] * (config.batch - len(lanes))
    words = [programs.assemble(src) for _, src in lanes]
    plain = pstate.make_entry_state(config, words, ergs=1 << 20,
                                    entry_address=[e for e, _ in lanes],
                                    device="cpu")
    kern = pstate.clone_state(plain)
    fused_cycle.run_cycles(plain, config, 40, k_inner=40)
    _host_run(host, kern, config, 40, 40)
    _assert_same(plain, kern)
    assert kern.lane_error.tolist()[:6] == [False] * 3 + [True] + [False] * 2
    assert int(kern.pq_count.sum()) > 0


# the units-alone geometry: two frames a lane on each arena, as
# precompile_config's heap (32 words) and aux heap (16)
_UNIT_FRAMES = {"heap": 32, "aux": 16}


def _unit_cases(case):
    """[(arena, slot, kind, in_off, in_len, rounds)] of one units-alone
    case: keccak256 lengths at in_off & 31 in {0, 1, 7, 31}, inputs that run
    past the frame's last word (into the next frame, or past the arena),
    the aux heap's frames, offsets whose byte address passes 2**32 (where
    a block's u32 offset wraps to the frame's start), and sha256 rounds up
    to one over the limit."""
    if case.startswith("keccak-"):
        n = int(case.split("-")[1])
        return [("heap", slot, 0, 32 * w + r, n, 0)
                for slot, w in ((0, 0), (1, 1)) for r in (0, 1, 7, 31)]
    if case == "last-word":
        return [("heap", slot, 0, 31 * 32 + r, n, 0)
                for slot in (0, 1) for r, n in ((0, 32), (1, 64), (31, 200))]
    if case == "wrap":
        return [("heap", slot, 0, 2**32 - d, n, 0)
                for slot, d, n in ((0, 5, 200), (1, 136, 271), (0, 140, 271),
                                   (1, 1, 40))]
    if case == "aux":
        return [("aux", slot, 0, 32 * w + r, n, 0)
                for slot, w, r, n in ((0, 0, 0, 64), (1, 3, 7, 137),
                                      (0, 14, 31, 271), (1, 15, 1, 32))] \
            + [("aux", 1, 1, 13, 0, 2), ("aux", 0, 1, 15, 0, 1)]
    rounds = int(case.split("-")[1])
    return [("heap", slot, 1, w, 0, rounds)
            for slot, w in ((0, 0), (0, 5), (1, 29), (1, 31))]


def _unit_bytes(arena, lane, base, first, n_words):
    """The big-endian bytes of frame words first, first + 1, ... as the
    unit reads them (zeros past the arena)."""
    out = b""
    for idx in range(first, first + n_words):
        i = (base + idx) & 0xFFFFFFFF
        limbs = arena[i, :, lane] if i < arena.shape[0] else [0] * 8
        out += b"".join((int(x) & 0xFFFFFFFF).to_bytes(4, "big")
                        for x in reversed(list(limbs)))
    return out


@pytest.mark.parametrize("case", [f"keccak-{n}" for n in (
    0, 1, 31, 32, 135, 136, 137, 271, 272)] + ["last-word", "aux", "wrap"]
    + [f"sha-{r}" for r in (1, 2, 3)])
def test_units_host_build_matches_golden(host, case):
    # the keccak256 / sha256 units alone (the window, the limb-level absorb
    # and the compression of K1's unit) against the JAX package's golden
    # keccak256 and sha256 compression, and both against the plain version
    # (precompile_units' on the CPU); past the limits (272 bytes: three
    # blocks; three rounds) lane_error and the plain version's output
    config = from_jax_config(precompile_config())
    calls = _unit_cases(case)
    kind = calls[0][0]
    W = _UNIT_FRAMES[kind]
    n = len(calls)
    rng = np.random.RandomState(len(case) * 1000 + n)
    arena = rng.randint(-2**31, 2**31, size=(2 * W, 8, n)).astype(np.int32)
    call = np.array([[k, slot * W, o, ln, r]
                     for _, slot, k, o, ln, r in calls]).astype(np.int32)
    out = torch.zeros((n, 8), dtype=torch.int32)
    err = torch.zeros((n,), dtype=torch.int32)
    arena_t, call_t = torch.from_numpy(arena), torch.from_numpy(call)
    args = _build.UnitsArgs(arena_t.data_ptr(), call_t.data_ptr(),
                            out.data_ptr(), err.data_ptr(), n, 2 * W,
                            config.precompile_keccak_blocks,
                            config.precompile_sha_rounds,
                            precompile_queue_slots(config)[0])
    assert host.eravm_units_host(ctypes.byref(args)) == 0
    want, want_err = fused_cycle.precompile_units(config, arena_t, call_t)
    assert torch.equal(out.to(torch.int64) & 0xFFFFFFFF, want)
    assert torch.equal(err != 0, want_err)
    mk, ms = config.precompile_keccak_blocks, config.precompile_sha_rounds
    for i, (_, slot, k, o, ln, r) in enumerate(calls):
        over = ln // 136 + 1 > mk if k == 0 else r > ms
        assert bool(err[i]) == over
        if over or o + ln > 2**32:      # past 2**32: the plain version's
            continue
        if k == 0:
            data = _unit_bytes(arena, i, slot * W, o >> 5,
                               ((o & 31) + ln + 31) >> 5)
            golden = keccak256(data[o & 31:(o & 31) + ln])
        else:
            st = list(SHA256_IV)
            for j in range(r):
                st = sha256_compress(
                    st, _unit_bytes(arena, i, slot * W, o + 2 * j, 2))
            golden = b"".join(x.to_bytes(4, "big") for x in st)
        assert _ints(out[i:i + 1]) == [int.from_bytes(golden, "big")]


@pytest.mark.parametrize("iters", [1, 3])
def test_k3_host_build_matches_plain(host, iters):
    gen = torch.Generator().manual_seed(iters)
    states = torch.randint(-2**31, 2**31 - 1, (37, 25, 2), generator=gen,
                           dtype=torch.int32)
    got = states.clone()
    assert host.eravm_k3_host(got.data_ptr(), got.shape[0], iters) == 0
    assert torch.equal(got, keccak.keccak_f1600(states, iters))


def _u32_states(seed, n):
    """n random states over the whole u32 range, the first ones at its
    edges (all zero bits, all one bits, only the top bit of each word)."""
    st = np.random.default_rng(seed).integers(0, 1 << 32, (n, 25, 2),
                                              dtype=np.uint64)
    for i, word in enumerate((0, 0xFFFFFFFF, 0x80000000)[:n]):
        st[i] = word
    return torch.from_numpy(st.astype(np.uint32).view(np.int32))


def _golden_chain(state, iters):
    lanes = [(int(lo) & 0xFFFFFFFF) | ((int(hi) & 0xFFFFFFFF) << 32)
             for lo, hi in state.tolist()]
    for _ in range(iters):
        lanes = golden_f1600(lanes)
    return [[v & 0xFFFFFFFF, v >> 32] for v in lanes]


@pytest.mark.parametrize("iters", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000])
def test_k3_host_build_matches_plain_and_golden(host, n, iters):
    # K3's lane body (csrc/keccak_f.cu, keccak.cuh's permutation)
    # against the plain version, and a spread of its states against the
    # JAX package's golden permutation on Python ints
    states = _u32_states(100 * n + iters, n)
    got = states.clone()
    assert host.eravm_k3_host(got.data_ptr(), n, iters) == 0
    assert torch.equal(got, keccak.keccak_f1600(states, iters))
    u32 = got.numpy().view(np.uint32)
    for i in sorted({0, 1, 2, n // 2, n - 1} & set(range(n))):
        assert u32[i].tolist() == _golden_chain(states[i], iters)


#: eravm_perm_host's forms of keccak.cuh: keccak_f1600, keccak_f1600_unit,
#: 24 chained keccak_round, and keccak_rounds at the other loop trips that
#: tools/unit_variants.py builds
PERM_FORMS = {"keccak_f1600": 0, "unit": -1, "round_x24": -2, "trip2": 2,
              "trip24": 24}


@pytest.mark.parametrize("form", sorted(PERM_FORMS))
def test_permutation_forms_agree_on_the_host(host, form):
    states = _u32_states(7, 48)
    got = states.clone()
    assert host.eravm_perm_host(got.data_ptr(), 48, PERM_FORMS[form]) == 0
    assert torch.equal(got, keccak.keccak_f1600(states, 1))
    assert got.numpy().view(np.uint32)[5].tolist() \
        == _golden_chain(states[5], 1)


def _limbs(values):
    return torch.tensor([secp256k1.to_limbs(v) for v in values],
                        dtype=torch.int64).to(torch.int32)


def _ints(t):
    return [sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(row))
            for row in t.tolist()]


def _field_values():
    p, n = secp256k1.P_INT, secp256k1.N_INT
    rng = random.Random(41)
    near = [2**256 - 2**32 - 977 + d for d in (-2, -1, 0, 1, 2)]
    return [0, 1, 2, p - 1, n - 1, p, n, n + 1, 2**256 - 1, 2**255] + near \
        + [rng.getrandbits(256) for _ in range(48)] \
        + [rng.randrange(p - 2**40, p) for _ in range(6)]


@pytest.mark.parametrize("op,fn", [
    (0, lambda a, b, p, n: a * b % p), (1, lambda a, b, p, n: a * b % n),
    (2, lambda a, b, p, n: a * a % p), (3, lambda a, b, p, n: a * a % n),
    (4, lambda a, b, p, n: pow(a, p - 2, p)),
    (5, lambda a, b, p, n: pow(a, n - 2, n)),
    (6, lambda a, b, p, n: pow(a, (p + 1) // 4, p))])
def test_field_arithmetic_host_build_matches_python(host, op, fn):
    # the unit's multiplication, square (fixed-step reductions mod p and n)
    # and addition-chain powers, on any 256-bit inputs: canonical results
    a = _field_values()
    b = a[::-1]
    out = torch.zeros((len(a), 8), dtype=torch.int32)
    assert host.eravm_fe_host(_limbs(a).data_ptr(), _limbs(b).data_ptr(),
                              out.data_ptr(), len(a), op) == 0
    p, n = secp256k1.P_INT, secp256k1.N_INT
    assert _ints(out) == [fn(x, y, p, n) for x, y in zip(a, b)]


def test_endomorphism_split_host_build(host):
    # k = k1 + k2 lambda (mod n), both halves under 2**129, each walked as
    # an odd magnitude (even ones plus 1) with its sign
    n, lam = secp256k1.N_INT, _build.secp_glv()["lam"]
    rng = random.Random(43)
    ks = [0, 1, 2, n - 1, n - 2, n // 2, n // 3, 2**128, 2**128 - 1,
          2**129, 2**255, _build.secp_glv()["lam"]] \
        + [rng.randrange(n) for _ in range(500)]
    out = torch.zeros((len(ks), 2, 7), dtype=torch.int32)
    assert host.eravm_secp_split_host(_limbs(ks).data_ptr(), out.data_ptr(),
                                      len(ks)) == 0
    for k, row in zip(ks, out.tolist()):
        halves = []
        for m0, m1, m2, m3, m4, neg, even in row:
            m = sum((x & 0xFFFFFFFF) << (32 * i)
                    for i, x in enumerate((m0, m1, m2, m3, m4)))
            assert m & 1 and even in (0, 1) and neg in (0, 1)
            halves.append((m - even) * (-1 if neg else 1))
        assert (halves[0] + halves[1] * lam - k) % n == 0, hex(k)
        assert all(abs(h) < 2**129 for h in halves), hex(k)


def test_ecrecover_unit_host_build_matches_plain(host):
    # csrc/secp256k1.cuh's ecrecover_unit against ops/secp256k1.py and the
    # JAX package's golden ecrecover_inner on random signatures, every edge
    # case and the crafted ones (R = +-G, sums at infinity, u1 = 0, ...)
    cases = _random_cases(16, 31) + _edge_cases() \
        + ec_programs.crafted_signatures()
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
    golden = [ecrecover_inner(*c) if c[1] <= 1 else None for c in cases]
    assert [a if o else None for a, o in zip(_ints(addr), ok.tolist())] \
        == golden


@pytest.mark.parametrize("case", list(splice_cases.SPLICE_CASES))
def test_splice_host_build_matches_plain(host, case):
    # csrc/pq_splice.cu's body against splice_precompile_rows on random
    # scratch blocks whose rows past each lane's data rows hold garbage:
    # every state field the splice touches, and no garbage word copied
    config, plain, block, n = splice_cases.splice_case(case)
    kern = copy.deepcopy(plain)
    blocks0 = plain.pq_blocks.clone()
    fused_cycle.splice_precompile_rows(plain, config, block, n)
    _host_splice(host, kern, config, block, n)
    for field in splice_cases.SPLICE_FIELDS:
        assert torch.equal(getattr(kern, field), getattr(plain, field)), field
    for field in ("pq_meta", "pq_value", "pq_flags"):
        assert not bool((getattr(kern, field) == splice_cases.GARBAGE).any())
    flagged = int((block[3][:n] != 0).any(1).sum())
    assert bool((kern.pq_blocks - blocks0 == flagged).all())
    assert (flagged == 0) == (case == "none_flagged")


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


@pytest.mark.parametrize("columns", [1, 8, 24])
@pytest.mark.parametrize("iters", [0, 1, 2])
@pytest.mark.parametrize("fused", [0, 1])
def test_p2_p5_host_build_matches_plain(host, fused, iters, columns):
    # p2_kernel's phase functions over 32 emulated lanes a column; 24
    # columns fill no block of several warps
    planes = _random_i32(11, (1600, min(columns, 8), max(columns // 8, 1)))
    state = planes.clone()
    assert host.eravm_p2_host(state.data_ptr(), columns, iters, fused) == 0
    assert torch.equal(state,
                       probe_keccak.keccak_bitslice_plain(planes, iters))


def test_p2_rho_lane_map():
    # the table of csrc/probe_keccak.cu's p2_rho_source in numpy: output
    # register h (z = 2t + h) of keccak lane (y, 2x + 3y) takes, for r =
    # rho(x, y) even, register h of lane t - r/2, for r odd register 1 - h
    # of lane t - (r + 1)/2 (h = 0) or t - (r - 1)/2 (h = 1), mod 32
    rot = np.array(keccak.KECCAK_ROTATIONS)
    x, y = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    x, y = x.ravel(), y.ravel()
    dst = y + 5 * ((2 * x + 3 * y) % 5)
    r = rot[x + 5 * y]
    t = np.arange(32)[None, :, None]
    h = np.arange(2)[None, None, :]
    r3 = r[:, None, None]
    hs = np.where(r3 % 2 == 0, h, 1 - h)
    k = np.where(r3 % 2 == 0, r3 // 2, np.where(h == 0, (r3 + 1) // 2,
                                                (r3 - 1) // 2))
    src_plane = (x + 5 * y)[:, None, None] * 64 + 2 * ((t - k) % 32) + hs
    out = np.empty(1600, dtype=np.int64)
    out[(dst[:, None, None] * 64 + 2 * t + h).ravel()] = src_plane.ravel()
    # a permutation of the 1600 planes, equal to chi's first source in the
    # round plan, and to what p2_rho moves in the host build
    assert sorted(out) == list(range(1600))
    plan = np.array(probe_keccak.bitslice_round_plan())
    assert np.array_equal(out, plan[:, 0])
    got = torch.empty(1600, dtype=torch.int32)
    assert _build.load_host().eravm_p2_rho_host(got.data_ptr()) == 0
    assert np.array_equal(got.numpy(), out)


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
                              out.data_ptr(), 48, 40, 5, 0, lane_major,
                              1) == 0
    assert torch.equal(out, probe_uniform.uniform_gather_plain(
        arena, idx, 5, lane_major))


@pytest.mark.parametrize("layout", sorted(probe_uniform.WORD_LAYOUTS))
@pytest.mark.parametrize("random_index", [False, True])
def test_p6_word_host_build_matches_plain(host, random_index, layout):
    arena, idx = probe_uniform.tool_inputs(48, 40, "cpu", random_index,
                                           word_layout=layout)
    idx[5] = 48                                   # past the arena: reads 0
    out = torch.empty((8, 40), dtype=torch.int32)
    assert host.eravm_p6w_host(arena.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), 48, 40, 5,
                               probe_uniform.WORD_LAYOUTS[layout][0], 1) == 0
    assert torch.equal(out, probe_uniform.word_gather_plain(
        arena, idx, 5, layout))


def _p6_split_inputs(lane_major=False, word_layout=None):
    """P6's arena at W = 48, TB = 40 with values near 2^32 (2^32 - 1,
    2^32 - 2, ...: the sums wrap) and an index whose first 32 lanes hold
    the tool's 37 (mode 1's uniform warp) and whose last 8 are random, one
    past the arena."""
    arena, idx = probe_uniform.tool_inputs(48, 40, "cpu", True, lane_major,
                                           word_layout)
    idx[:32] = probe_uniform.INDEX
    idx[35] = 48
    return -1 - arena, idx


@pytest.mark.parametrize("lane_major", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("reps", [1, 7, 512])
@pytest.mark.parametrize("split", [1, 3, 4, 8])
def test_p6_split_host_build_matches_plain(host, split, reps, mode,
                                           lane_major):
    # the gathers of each lane split over S warps, REPS below S and not a
    # multiple of it, their sums added as the kernel's first warp adds them
    arena, idx = _p6_split_inputs(lane_major)
    out = torch.empty((8, 40), dtype=torch.int32)
    assert host.eravm_p6_host(arena.data_ptr(), idx.data_ptr(),
                              out.data_ptr(), 48, 40, reps, mode, lane_major,
                              split) == 0
    assert torch.equal(out, probe_uniform.uniform_gather_plain(
        arena, idx, reps, lane_major))


@pytest.mark.parametrize("layout", sorted(probe_uniform.WORD_LAYOUTS))
@pytest.mark.parametrize("reps", [1, 7, 512])
@pytest.mark.parametrize("split", [1, 3, 4, 8])
def test_p6_word_split_host_build_matches_plain(host, split, reps, layout):
    arena, idx = _p6_split_inputs(word_layout=layout)
    out = torch.empty((8, 40), dtype=torch.int32)
    assert host.eravm_p6w_host(arena.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), 48, 40, reps,
                               probe_uniform.WORD_LAYOUTS[layout][0],
                               split) == 0
    assert torch.equal(out, probe_uniform.word_gather_plain(
        arena, idx, reps, layout))


@pytest.mark.parametrize("self_loop", [False, True])
def test_p6_chain_host_build_matches_plain(host, self_loop):
    # P6's dependent-load chain: a random permutation, or arena[i] = i
    # (each lane reads its own word again, as on the card)
    gen = torch.Generator().manual_seed(17)
    arena = (torch.arange(64, dtype=torch.int32) if self_loop
             else torch.randperm(64, generator=gen).to(torch.int32))
    start = torch.randint(0, 64, (32,), generator=gen, dtype=torch.int32)
    out = torch.empty(32, dtype=torch.int32)
    assert host.eravm_p6c_host(arena.data_ptr(), start.data_ptr(),
                               out.data_ptr(), 32, 7, 0) == 0
    want = probe_uniform.chain_gather_plain(arena, start, 7)
    assert torch.equal(out, want)
    assert torch.equal(probe_uniform.chain_gather(arena, start, 7), want)
    assert torch.equal(want, start) == self_loop


@pytest.mark.parametrize("reps", [5, 40])
def test_p6_lines_host_build_matches_plain(host, reps):
    # P6's request-rate probe: 3 blocks of 40 lanes over 16 lines each (a
    # remainder of the 16-line cycle at 40 loads)
    arena = _random_i32(18, (16 * 3 * 40 + 7,))
    out = torch.empty((3, 40), dtype=torch.int32)
    assert host.eravm_p6c_host(arena.data_ptr(), arena.data_ptr(),
                               out.data_ptr(), 40, reps, 3) == 0
    want = probe_uniform.line_sum_plain(arena, 40, 3, reps)
    assert torch.equal(out, want)
    assert torch.equal(probe_uniform.line_sum(arena, 40, 3, reps), want)


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
