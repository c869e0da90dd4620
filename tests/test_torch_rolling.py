"""The rolling commitment in the port: its plain keccak-f, the sponge the
engine builds in rolling mode, and the finalized digests, against the JAX
package and its golden host spec."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from era_zk_evm_tpu.golden.precompiles import keccak_f1600
from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig, make_entry_state, run_cycles
from era_zk_evm_tpu.witness.commitment import (
    device_queue_streams, rolling_commit,
)
from era_zk_evm_tpu_torch.config import from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.ops.keccak import keccak_f1600_array
from era_zk_evm_tpu_torch.witness.rolling import (
    digests_to_bytes, finalize_rolling,
)

from test_batched_vm import STACK_PROGRAMS, UMA_PROGRAMS
from test_fused_cycle import N_CYCLES, _config

PROGRAMS = [UMA_PROGRAMS[1], STACK_PROGRAMS[0]]
ERGS = 1 << 20


def _rolling_config(batch):
    # the geometry of test_fused_cycle's rolling sponge test
    return VmConfig(batch=batch, code_words=32, stack_words=256,
                    sweep_gating=False, stack_abs_words=64, stack_sp_base=960,
                    heap_words=32, aux_heap_words=8, max_depth=8,
                    queue_capacity=0, rolling_commitment=True)


@pytest.fixture(scope="module")
def rolling_runs():
    config = _rolling_config(len(PROGRAMS))
    words = [assemble_to_code_words(s) for s in PROGRAMS]
    ref = run_cycles(make_entry_state(config, words, ergs=ERGS), config,
                     N_CYCLES)
    st = pstate.make_entry_state(from_jax_config(config), words, ergs=ERGS,
                                 device="cpu")
    fused_cycle.run_cycles(st, from_jax_config(config), N_CYCLES, k_inner=16)
    return ref, st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_keccak_matches_golden(seed):
    rng = random.Random(seed)
    states = [[rng.getrandbits(64) for _ in range(25)] for _ in range(6)]
    states.append([0] * 25)
    states.append([(1 << 64) - 1] * 25)
    arr = np.array([[[x & 0xFFFFFFFF, x >> 32] for x in s] for s in states],
                   dtype=np.uint32)
    out = keccak_f1600_array(torch.from_numpy(arr.view(np.int32)))
    out = out.numpy().view(np.uint32)
    for i, s in enumerate(states):
        got = [int(out[i, k, 0]) | (int(out[i, k, 1]) << 32)
               for k in range(25)]
        assert got == keccak_f1600(s)


def test_rolling_sponge_matches_jax(rolling_runs):
    ref, st = rolling_runs
    got = pstate.state_to_numpy(st)
    bad = [f.name for f in dataclasses.fields(ref)
           if not (np.asarray(getattr(ref, f.name)) == got[f.name]).all()]
    assert not bad, f"port/jax mismatch in fields: {bad}"
    assert got["wc_count"].all()


def test_digests_match_rolling_commit_of_golden_streams(rolling_runs):
    """finalize_rolling of the port's sponge == the host spec over the
    memory-query stream a JAX queue-mode run records for the same programs."""
    _, st = rolling_runs
    config = _config(len(PROGRAMS))
    words = [assemble_to_code_words(s) for s in PROGRAMS]
    queued = run_cycles(make_entry_state(config, words, ergs=ERGS), config,
                        N_CYCLES)
    streams = device_queue_streams(queued)
    expect = [rolling_commit(s) for s in streams]
    got = digests_to_bytes(finalize_rolling(st.wc_state, st.wc_count))
    assert got == expect
    assert [len(s) for s in streams] == st.wc_count.tolist()
