"""The port's copy of the golden oracle (`era_zk_evm_tpu_torch/golden/`) and
its test harness against their sources, and the one set of query classes.

Each golden module, and `testing/harness.py`, must equal the JAX source
with only its relative imports changed (they point at the port's `isa/`,
which `tests/test_torch_isa.py` holds equal to its own source).  The query
structs exist once in the port (`golden/queries.py`; `witness/queries.py`
re-exports them), so a golden stream and a device stream compare equal as
lists, and the constants the port's ops share with golden are golden's.
"""

import pathlib
import random
import re

import pytest

from era_zk_evm_tpu_torch import golden
from era_zk_evm_tpu_torch.golden import precompiles as gp
from era_zk_evm_tpu_torch.golden import queries as gq
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.ops import keccak, secp256k1, sha256
from era_zk_evm_tpu_torch.testing import differential
from era_zk_evm_tpu_torch.testing import vm_programs as vp
from era_zk_evm_tpu_torch.witness import commitment, packed, queries

from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "era_zk_evm_tpu"
PORT = ROOT / "era_zk_evm_tpu_torch"
COPIES = sorted(
    [f"golden/{p.name}" for p in (SRC / "golden").glob("*.py")]
    + ["testing/harness.py"])
_RELATIVE = re.compile(r"^(\s*from \.+)(\w[\w.]*)? import ", re.M)


def _without_relative_imports(text: str) -> str:
    return _RELATIVE.sub(r"\1<rel> import ", text)


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_its_source(path):
    mine = (PORT / path).read_text()
    theirs = (SRC / path).read_text()
    # the relative imports resolve inside the port (no absolute import of
    # the JAX package: tests/test_torch_slice.py scans every port module)
    assert _without_relative_imports(mine) \
        == _without_relative_imports(theirs), path


def test_golden_modules_all_copied():
    assert sorted(p.name for p in (PORT / "golden").glob("*.py")) \
        == sorted(p.name for p in (SRC / "golden").glob("*.py"))


def test_one_set_of_query_classes():
    for name in ("MemoryType", "MemoryQuery", "LogQuery",
                 "DecommittmentQuery", "RefundType", "EventMessage"):
        assert getattr(queries, name) is getattr(gq, name), name
        assert getattr(golden, name) is getattr(gq, name), name
    assert packed.MemoryQuery is gq.MemoryQuery
    assert commitment.MemoryQuery is gq.MemoryQuery


def test_golden_and_device_streams_compare_equal():
    # the same program through golden and the port's engine: the memory
    # witness streams are equal as lists of one class's structs
    src = vp.UMA_PROGRAMS[0]
    _, tools, _ = differential.run_golden(src, 64, ergs=1 << 20)
    want = [q for _, q in tools.witness.memory_queries]
    from era_zk_evm_tpu_torch.config import VmConfig
    from era_zk_evm_tpu_torch.isa.assembler import assemble_to_code_words

    config = VmConfig(batch=1, queue_capacity=64 * 8, heap_words=64,
                      stack_words=2048, code_words=64, max_depth=8)
    st = pstate.make_entry_state(config, [assemble_to_code_words(src)],
                                 ergs=1 << 20, device="cpu")
    fused_cycle.run_cycles(st, config, 64)
    got = commitment.device_queue_streams(st)[0]
    assert want and got == want


def test_ops_constants_are_golden():
    assert keccak.KECCAK_RC is gp.KECCAK_RC
    assert keccak.KECCAK_ROTATIONS is gp.KECCAK_ROTATIONS
    assert sha256.SHA256_K is gp.SHA256_K and sha256.SHA256_IV is gp.SHA256_IV
    assert (secp256k1.P_INT, secp256k1.N_INT, secp256k1.GX_INT,
            secp256k1.GY_INT) == (gp.SECP_P, gp.SECP_N, gp.SECP_GX,
                                  gp.SECP_GY)
    assert secp256k1.ecrecover_scalar is gp.ecrecover_inner


def test_host_keccak_equals_golden():
    # ops/keccak's formulation of the permutation against golden's
    rng = random.Random(11)
    for _ in range(8):
        lanes = [rng.getrandbits(64) for _ in range(25)]
        assert keccak.keccak_f1600_ints(lanes) == gp.keccak_f1600(lanes)
    for n in (0, 1, 135, 136, 137, 300):
        data = bytes(rng.getrandbits(8) for _ in range(n))
        assert keccak.keccak256(data) == gp.keccak256(data)
