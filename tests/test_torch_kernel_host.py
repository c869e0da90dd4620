"""The CUDA kernels' per-lane bodies, compiled for the host with g++,
against the port's plain torch versions, bit for bit.

The wrappers never take this build (on CPU tensors they run the plain
versions); it checks the kernel sources' lane logic where no card or nvcc
exists: K1's memory-witness body and its storage-enabled (kLog) body, K2's
fold and K3's chained permutation.  The kernels themselves are held against
the plain versions on the card by chip_smoke.py.
"""

import ctypes
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
from era_zk_evm_tpu_torch.testing import log_programs, programs
from era_zk_evm_tpu_torch.witness.rolling import rolling_absorb

from test_batched_vm import (
    BASIC_PROGRAMS, CALL_PROGRAMS, CONTEXT_PROGRAMS, CONTROL_FLOW,
    PTR_PROGRAMS, STACK_PROGRAMS, UMA_PROGRAMS,
)
from test_fused_cycle import _log_config

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
    done = 0
    while done < n_cycles:
        k = min(k_inner, n_cycles - done)
        step0 = st.global_step.min()
        args = fused_cycle.k1_args(st, config, k, k, block, step0)
        assert host.eravm_k1_host(ctypes.byref(args)) == 0
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


@pytest.mark.parametrize("iters", [1, 3])
def test_k3_host_build_matches_plain(host, iters):
    gen = torch.Generator().manual_seed(iters)
    states = torch.randint(-2**31, 2**31 - 1, (37, 25, 2), generator=gen,
                           dtype=torch.int32)
    got = states.clone()
    assert host.eravm_k3_host(got.data_ptr(), got.shape[0], iters) == 0
    assert torch.equal(got, keccak.keccak_f1600(states, iters))
