"""The port's plain cycle step against the JAX engine `run_cycles`: every
BatchedVmState field, bit for bit, for each opcode family of the slice.

One JAX run covers all program sets as one batch (one compile, in the
`test_fused_cycle._config` geometry); the tests then compare each family's
lanes.  On CPU tensors the port's dispatcher runs the plain versions of its
kernels, through the same chunking as on the GPU.
"""

import dataclasses
import random

import numpy as np
import pytest

from era_zk_evm_tpu.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu.models import make_entry_state, run_cycles
from era_zk_evm_tpu_torch.config import BATCH_LAST_FIELDS, from_jax_config
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate

from test_batched_vm import (
    BASIC_PROGRAMS, CALL_PROGRAMS, CONTEXT_PROGRAMS, CONTROL_FLOW,
    PTR_PROGRAMS, STACK_PROGRAMS, UMA_PROGRAMS,
)
from test_fused_cycle import N_CYCLES, _config
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

USER_MODE_MASKING = """
    add 2000, r0, r9
    near_call r9, @k, @h
    done:
    ret r0
    k:
    ctx.inc_tx
    ret r0
    h:
    add 3, r0, r3
    jump @done
"""
UNSUPPORTED_LOG = """
    add 1, r0, r1
    log.sread r1, r2
    ret r0
"""

FAMILIES = {
    "basic": BASIC_PROGRAMS, "control_flow": CONTROL_FLOW,
    "stack": STACK_PROGRAMS, "uma": UMA_PROGRAMS, "near_calls": CALL_PROGRAMS,
    "context": CONTEXT_PROGRAMS, "ptr_and_panics": PTR_PROGRAMS,
    "user_mode_masking": [USER_MODE_MASKING],
    "unsupported_log": [UNSUPPORTED_LOG],
}
PROGRAMS = [p for progs in FAMILIES.values() for p in progs]
ERGS = 1 << 20


def _lanes(arrays, lo, hi):
    return {k: (v[..., lo:hi] if k in BATCH_LAST_FIELDS else v[lo:hi])
            for k, v in arrays.items()}


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _assert_same(ref, got):
    bad = [k for k in ref if ref[k].shape != got[k].shape
           or not (ref[k] == got[k]).all()]
    assert not bad, f"port/jax mismatch in fields: {bad}"


def _port_entry(config, words):
    return pstate.make_entry_state(from_jax_config(config), words, ergs=ERGS,
                                   device="cpu")


@pytest.fixture(scope="module")
def reference():
    """(config, words, JAX state after N_CYCLES as numpy)."""
    config = _config(len(PROGRAMS))
    words = [assemble_to_code_words(s) for s in PROGRAMS]
    ref = run_cycles(make_entry_state(config, words, ergs=ERGS), config,
                     N_CYCLES)
    return config, words, _jax_numpy(ref)


@pytest.fixture(scope="module")
def port_run(reference):
    config, words, _ = reference
    st = _port_entry(config, words)
    fused_cycle.run_cycles(st, from_jax_config(config), N_CYCLES)
    return pstate.state_to_numpy(st)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family, reference, port_run):
    lo = 0
    for name, progs in FAMILIES.items():
        if name == family:
            break
        lo += len(progs)
    hi = lo + len(FAMILIES[family])
    ref = _lanes(reference[2], lo, hi)
    got = _lanes(port_run, lo, hi)
    _assert_same(ref, got)
    if family == "unsupported_log":
        assert got["lane_error"].all()
    else:
        assert got["done"].all()


def test_chunk_remainder(reference):
    # n_cycles not divisible by k_inner: full chunks + a remainder chunk
    config, words, ref = reference
    st = _port_entry(config, words)
    fused_cycle.run_cycles(st, from_jax_config(config), N_CYCLES, k_inner=20)
    _assert_same(ref, pstate.state_to_numpy(st))


def test_resume_preserves_block_clock(reference):
    # two calls on one state == one long run: the queue clock survives
    config, words, ref = reference
    st = _port_entry(config, words)
    pc = from_jax_config(config)
    fused_cycle.run_cycles(st, pc, N_CYCLES // 2, k_inner=16)
    fused_cycle.run_cycles(st, pc, N_CYCLES // 2, k_inner=16)
    _assert_same(ref, pstate.state_to_numpy(st))


def test_random_arith_programs():
    rng = random.Random(0xF05ED)
    ops = ["add", "sub", "and", "or", "xor", "shl", "shr", "rol", "ror",
           "mul", "div", "sub!", "add!"]
    programs = []
    for _ in range(4):
        lines = [f"add {rng.randrange(1, 1 << 16)}, r0, r{j}"
                 for j in range(1, 6)]
        for _ in range(24):
            op = rng.choice(ops)
            a, b, d = (rng.randrange(1, 15) for _ in range(3))
            if op in ("mul", "div"):
                lines.append(f"{op} r{a}, r{b}, r{d}, r{rng.randrange(1, 15)}")
            else:
                lines.append(f"{op} r{a}, r{b}, r{d}")
        lines.append("ret r0")
        programs.append("\n".join(lines))
    config = _config(len(programs))
    words = [assemble_to_code_words(s) for s in programs]
    ref = run_cycles(make_entry_state(config, words, ergs=ERGS), config, 40)
    st = _port_entry(config, words)
    fused_cycle.run_cycles(st, from_jax_config(config), 40)
    _assert_same(_jax_numpy(ref), pstate.state_to_numpy(st))
