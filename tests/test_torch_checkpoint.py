"""The port's checkpoint / resume (`models/checkpoint.py`).

The round trip of `tests/test_aux_subsystems.py:132-165`: a run
checkpointed after 15 cycles and resumed for 25 equals the run straight
through, every field, bit for bit.  And the format is the JAX package's:
a JAX checkpoint loads into the port equal to `state_from_numpy` of the
JAX arrays, and a port checkpoint loads through JAX's `load_checkpoint`
equal to the JAX state, dtypes included.  No cycle program is compiled:
the JAX states are built from numpy arrays.
"""

import dataclasses

import numpy as np
import pytest

from era_zk_evm_tpu.models import checkpoint as jcheckpoint
from era_zk_evm_tpu_torch.config import VmConfig
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.models.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from era_zk_evm_tpu_torch.testing.programs import assemble
from test_torch_spill import _jax
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

SRC = """
    add 1, r0, r10
    add 30, r0, r1
    loop:
    add r2, r1, r2
    st.h 0, r2
    sub! r1, r10, r1
    jump.if_ne @loop
    ret r0
"""
# tests/test_aux_subsystems.py's config
CONFIG = VmConfig(batch=4, queue_capacity=512, heap_words=16,
                  stack_words=2048, code_words=16, max_depth=4,
                  rolling_commitment=True)


def _entry():
    return pstate.make_entry_state(CONFIG, [assemble(SRC)] * 4,
                                   ergs=1 << 20, device="cpu")


def _assert_equal(a: dict, b: dict, dtypes: bool = False):
    bad = [k for k in a if not np.array_equal(a[k], b[k])
           or (dtypes and a[k].dtype != b[k].dtype)]
    assert not bad, f"fields differ: {bad}"


def test_roundtrip_bit_exact(tmp_path):
    full = fused_cycle.run_cycles(_entry(), CONFIG, 40)
    part = fused_cycle.run_cycles(_entry(), CONFIG, 15)
    save_checkpoint(tmp_path / "ckpt", part, CONFIG)
    loaded, config = load_checkpoint(tmp_path / "ckpt", device="cpu")
    assert config == CONFIG and loaded.done.device.type == "cpu"
    resumed = fused_cycle.run_cycles(loaded, config, 25)
    _assert_equal(pstate.state_to_numpy(full),
                  pstate.state_to_numpy(resumed))
    assert int(resumed.monotonic_cycle_counter.min()) == 40
    assert int(resumed.wc_count.min()) > 0


@pytest.fixture
def midway():
    """The state 15 cycles in: (numpy arrays, JAX config, JAX state)."""
    arrays = pstate.state_to_numpy(fused_cycle.run_cycles(_entry(), CONFIG,
                                                          15))
    return (arrays,) + _jax(CONFIG, arrays)


def test_jax_checkpoint_loads_into_port(tmp_path, midway):
    arrays, jcfg, jst = midway
    jcheckpoint.save_checkpoint(tmp_path / "j", jst, jcfg)
    loaded, config = load_checkpoint(tmp_path / "j", device="cpu")
    assert dataclasses.asdict(config) == dataclasses.asdict(jcfg)
    _assert_equal(pstate.state_to_numpy(pstate.state_from_numpy(arrays,
                                                                 "cpu")),
                  pstate.state_to_numpy(loaded), dtypes=True)


def test_port_checkpoint_loads_into_jax(tmp_path, midway):
    arrays, jcfg, jst = midway
    save_checkpoint(tmp_path / "p", pstate.state_from_numpy(arrays, "cpu"),
                    CONFIG)
    loaded, config = jcheckpoint.load_checkpoint(tmp_path / "p")
    assert config == jcfg
    _assert_equal({f.name: np.asarray(getattr(jst, f.name))
                   for f in dataclasses.fields(jst)},
                  {f.name: np.asarray(getattr(loaded, f.name))
                   for f in dataclasses.fields(loaded)}, dtypes=True)
