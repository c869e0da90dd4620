"""The port's copy of the ISA layer (`era_zk_evm_tpu_torch/isa/`) and of the
keccak constants, against the JAX package's originals: any drift fails here.

The port imports nothing of `era_zk_evm_tpu`, so it keeps its own copy of the
jax-free layers it needs; these tests hold the copy equal to the source.
"""

import importlib.util
import pathlib
import random

import numpy as np
import pytest

import test_batched_far_call
import test_batched_vm
from era_zk_evm_tpu.golden import precompiles as jgolden
from era_zk_evm_tpu.isa import abi as jabi
from era_zk_evm_tpu.isa import assembler as jasm
from era_zk_evm_tpu.isa import encoding as jenc
from era_zk_evm_tpu.isa import opcodes as jops
from era_zk_evm_tpu.isa import params as jparams
from era_zk_evm_tpu_torch.isa import abi as pabi
from era_zk_evm_tpu_torch.isa import assembler as pasm
from era_zk_evm_tpu_torch.isa import encoding as penc
from era_zk_evm_tpu_torch.isa import opcodes as pops
from era_zk_evm_tpu_torch.isa import params as pparams
from era_zk_evm_tpu_torch.ops import keccak as pkeccak

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def _program_sets() -> dict:
    """Every module-level program set of the two test modules: lists of
    sources, and (address, source) contract lists."""
    sets = {}
    for mod in (test_batched_vm, test_batched_far_call):
        for name, value in vars(mod).items():
            if not name.isupper() or not isinstance(value, list) or not value:
                continue
            srcs = [v[1] if isinstance(v, tuple) else v for v in value]
            if all(isinstance(s, str) for s in srcs):
                sets[f"{mod.__name__}.{name}"] = srcs
    return sets


PROGRAM_SETS = _program_sets()


def test_params_constants_equal():
    names = [n for n in vars(jparams) if n.isupper()]
    assert names == [n for n in vars(pparams) if n.isupper()]
    for n in names:
        assert getattr(pparams, n) == getattr(jparams, n), n


def test_decode_tables_equal():
    jd, pd = jops.decode_consts(), pops.decode_consts()
    assert list(jd) == list(pd)
    for k in jd:
        assert np.array_equal(jd[k], pd[k]), k
    jt, pt = jops.table_arrays(), pops.table_arrays()
    assert list(jt) == list(pt)
    for k in jt:
        assert np.array_equal(jt[k], pt[k]), k
    assert [dataclass_fields(v) for v in jops.VARIANTS] \
        == [dataclass_fields(v) for v in pops.VARIANTS]
    assert penc.VARIANT_MASK == jenc.VARIANT_MASK
    assert penc.exception_revert_encoding() == jenc.exception_revert_encoding()


def dataclass_fields(variant) -> tuple:
    return tuple(int(x) if isinstance(x, int) else x
                 for x in vars(variant).values())


def test_abi_encodings_agree_on_seeded_inputs():
    rng = random.Random(0x15A)
    for _ in range(64):
        words = [rng.getrandbits(256) for _ in range(rng.randrange(1, 9))]
        assert pabi.code_hash_for_bytecode(words) \
            == jabi.code_hash_for_bytecode(words)
        fp = [rng.getrandbits(32) for _ in range(4)]
        mode = rng.randrange(3)
        ergs, shard = rng.getrandbits(32), rng.getrandbits(8)
        ctor, system = rng.random() < 0.5, rng.random() < 0.5
        assert pabi.FarCallABI(
            pabi.FatPointer(*fp), ergs, shard, pabi.ForwardingMode(mode),
            ctor, system).to_u256() == jabi.FarCallABI(
            jabi.FatPointer(*fp), ergs, shard, jabi.ForwardingMode(mode),
            ctor, system).to_u256()
        assert pabi.RetABI(pabi.FatPointer(*fp),
                           pabi.ForwardingMode(mode)).to_u256() \
            == jabi.RetABI(jabi.FatPointer(*fp),
                           jabi.ForwardingMode(mode)).to_u256()


@pytest.mark.parametrize("name", sorted(PROGRAM_SETS) + ["bench.WORKLOAD",
                                                          "bench.STORAGE_WORKLOAD"])
def test_assembler_words_equal(name):
    if name.startswith("bench."):
        srcs = [getattr(_bench(), name.split(".")[1])]
    else:
        srcs = PROGRAM_SETS[name]
    for src in srcs:
        assert pasm.assemble_to_code_words(src) \
            == jasm.assemble_to_code_words(src)


def test_keccak_constants_equal():
    assert pkeccak.KECCAK_RC == jgolden.KECCAK_RC
    assert pkeccak.KECCAK_ROTATIONS == jgolden.KECCAK_ROTATIONS
