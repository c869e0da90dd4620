"""The port against the native C++ oracle on the cross-engine fuzz campaigns.

The two native-oracle campaigns of `tests/test_cross_engine_fuzz.py` (48
random programs; the callers of two random far-call scenarios with their
contracts), through the port's plain engine and through the g++ host build
of K1's storage instance (kLog), 160 cycles each.  Compared lane by lane
with the port's own copy of the oracle (`era_zk_evm_tpu_torch.native`)
through `native.compare.compare_lanes`, the comparison `chip_smoke.py`
also holds K1 to on the card: status, cycles, registers and pointer tags,
flags, the entry frame's heap, and the memory, log and decommit witness
streams byte for byte.  No XLA program is compiled.  The jax-free copies of
the generators (`testing/fuzz_programs.py`) are held equal to their
sources."""

import random

import pytest

from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.native import ST_DONE, run_oracle
from era_zk_evm_tpu_torch.native.compare import compare_lanes
from era_zk_evm_tpu_torch.testing import fuzz_programs as fz

from test_torch_kernel_host import _host_run
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module", params=["random", "far_call"])
def oracle(request):
    config, words, bank, entries = fz.campaign(request.param)
    native = [run_oracle(w, ergs=fz.ERGS, max_cycles=fz.MAX_CYCLES,
                         witness_cap=fz.MAX_CYCLES * 8, contracts=bank,
                         storage_entries=list(entries))
              for w in words]
    return request.param, native


@pytest.mark.parametrize("engine", ["plain", "host_kernel"])
def test_port_matches_the_native_oracle(oracle, engine):
    name, native = oracle
    config, st = fz.entry_state(name, device="cpu")
    if engine == "plain":
        fused_cycle.run_cycles(st, config, fz.MAX_CYCLES, k_inner=40)
    else:
        _host_run(_build.load_host(), st, config, fz.MAX_CYCLES, 40)
    got = pstate.state_to_numpy(st)
    assert not got["lane_error"].any()
    assert got["done"].all()
    assert [want["status"] for want in native] == [ST_DONE] * len(native)
    assert compare_lanes(st, native, range(len(native))) == ([], len(native))
    if name == "far_call":
        assert any(want["decommit_records"] for want in native)


def test_generator_copies_equal_their_sources():
    from tests.test_batched_far_call import _random_far_call_scenario
    from tests.test_batched_vm import _random_program

    for seed in (fz.PROGRAM_SEED, 7):
        a, b = random.Random(seed), random.Random(seed)
        assert [fz.random_program(a) for _ in range(48)] \
            == [_random_program(b) for _ in range(48)]
    for seed in fz.FAR_CALL_SEEDS:
        assert fz.random_far_call_scenario(seed) \
            == _random_far_call_scenario(seed)
