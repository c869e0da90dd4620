"""The rolling commitment beside the memory queue in the port: the config
the reference's jnp engine runs (`tests/test_commitments.py`'s rolling
test), through the port's plain engine and through the g++ host build of K1
with K2, against JAX `run_cycles` field for field, and the finalized digests
against `device_rolling_commitments` and golden `rolling_commit`.

The JAX side runs exactly `test_commitments.py`'s `VmConfig`, programs and
64 cycles, so it shares that file's compiled program."""

import dataclasses

import numpy as np
import pytest

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import VmConfig, make_entry_state, run_cycles
from era_zk_evm_tpu.testing.differential import run_golden
from era_zk_evm_tpu.witness.commitment import (
    device_rolling_commitments, rolling_commit,
)
from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.config import check_slice, from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.witness.rolling import (
    digests_to_bytes, finalize_rolling,
)

from test_commitments import PROGRAMS
from test_torch_kernel_host import _host_run
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

MAX_CYCLES = 64
ERGS = 1 << 20


def _jax_config(queue_capacity=MAX_CYCLES * 8):
    # test_commitments.py's TestRollingCommitment config
    return VmConfig(batch=len(PROGRAMS), queue_capacity=queue_capacity,
                    heap_words=64, stack_words=2048, code_words=64,
                    max_depth=8, rolling_commitment=True)


def _port_run(engine, config, n=MAX_CYCLES, k_inner=32):
    words = [assemble_to_code_words(p) for p in PROGRAMS]
    st = pstate.make_entry_state(config, words, ergs=ERGS, device="cpu")
    if engine == "plain":
        fused_cycle.run_cycles(st, config, n, k_inner=k_inner)
    else:
        _host_run(_build.load_host(), st, config, n, k_inner)
    return st


@pytest.fixture(scope="module")
def reference():
    config = _jax_config()
    words = [assemble_to_code_words(p) for p in PROGRAMS]
    state = run_cycles(make_entry_state(config, words, ergs=ERGS), config,
                       MAX_CYCLES)
    golden = []
    for src in PROGRAMS:
        _, tools, _ = run_golden(src, MAX_CYCLES, ergs=ERGS)
        golden.append(rolling_commit(
            [q for _, q in tools.witness.memory_queries]))
    return state, device_rolling_commitments(state), golden


def test_rolling_with_a_queue_is_in_the_slice():
    check_slice(from_jax_config(_jax_config()))


@pytest.mark.parametrize("engine", ["plain", "host_kernel"])
def test_rolling_and_queue_match_jax(reference, engine):
    ref, jax_digests, golden = reference
    st = _port_run(engine, from_jax_config(_jax_config()))
    got = pstate.state_to_numpy(st)
    bad = [f.name for f in dataclasses.fields(ref)
           if not (np.asarray(getattr(ref, f.name)) == got[f.name]).all()]
    assert not bad, f"port/jax mismatch in fields: {bad}"
    assert not got["lane_error"].any() and got["wq_count"].all()
    digests = digests_to_bytes(finalize_rolling(st.wc_state, st.wc_count))
    assert digests == jax_digests == golden


@pytest.mark.parametrize("engine", ["plain", "host_kernel"])
def test_rolling_absorbs_past_a_queue_overflow(reference, engine):
    """With a queue of 5 cycles the queue overflows (lane_error, clamped
    rows), but the sponge still takes every valid slot: its digests equal
    the golden ones, and the kernel equals the plain engine."""
    _, _, golden = reference
    config = from_jax_config(_jax_config(queue_capacity=5 * 8))
    st = _port_run(engine, config)
    got = pstate.state_to_numpy(st)
    assert got["lane_error"].any()
    assert digests_to_bytes(finalize_rolling(st.wc_state, st.wc_count)) \
        == golden
    if engine == "host_kernel":
        plain = pstate.state_to_numpy(_port_run("plain", config))
        bad = [k for k in got if not (got[k] == plain[k]).all()]
        assert not bad, f"host kernel/plain mismatch in fields: {bad}"
