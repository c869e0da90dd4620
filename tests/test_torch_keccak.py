"""The plain version of the K3 kernel, `ops.keccak.keccak_f1600(states,
iters)` on CPU tensors, against the JAX package's `keccak_f1600_array`
chained `iters` times and against the scalar golden permutation.

`tests/test_keccak_kernel.py` holds the TPU kernels K3 and K4 equal to
`keccak_f1600_array`, so equality here ties the port to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from era_zk_evm_tpu.golden.precompiles import keccak_f1600 as golden_f1600
from era_zk_evm_tpu.ops.keccak import keccak_f1600_array
from era_zk_evm_tpu_torch.ops import keccak
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

N = 64


def _states(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, size=(N, 25, 2), dtype=np.uint64) \
        .astype(np.uint32)


@pytest.mark.parametrize("iters", [1, 3])
def test_plain_keccak_matches_jax_and_golden(iters):
    st = _states(iters)
    got = keccak.keccak_f1600(torch.from_numpy(st.view(np.int32)), iters)
    got = got.numpy().view(np.uint32)

    ref = jnp.asarray(st)
    for _ in range(iters):
        ref = keccak_f1600_array(ref)
    assert np.array_equal(got, np.asarray(ref))

    for i in range(0, N, 16):
        lanes = [int(lo) | (int(hi) << 32) for lo, hi in st[i]]
        for _ in range(iters):
            lanes = golden_f1600(lanes)
        want = np.array([[v & 0xFFFFFFFF, v >> 32] for v in lanes],
                        dtype=np.uint32)
        assert np.array_equal(got[i], want)


def test_keccak_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        keccak.keccak_f1600(torch.zeros((4, 25), dtype=torch.int32))
    with pytest.raises(ValueError):
        keccak.keccak_f1600(torch.zeros((4, 25, 2), dtype=torch.int64))
    launches = keccak.K3_LAUNCHES
    keccak.keccak_f1600(torch.zeros((4, 25, 2), dtype=torch.int32), 2)
    assert keccak.K3_LAUNCHES == launches      # the plain version: no launch


def test_in_place_keccak_matches_the_copying_one():
    st = torch.from_numpy(_states(5).view(np.int32))
    want = keccak.keccak_f1600(st, 2)
    got = st.clone()
    assert keccak.keccak_f1600_(got, 2) is got
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        keccak.keccak_f1600_(torch.zeros((4, 25, 2), dtype=torch.int64))
