"""The port against the native C++ oracle on the cross-engine fuzz campaigns.

The two native-oracle campaigns of `tests/test_cross_engine_fuzz.py` (48
random programs; the callers of two random far-call scenarios with their
contracts), through the port's plain engine and through the g++ host build
of K1's storage instance (kLog), 160 cycles each.  Compared lane by lane
with `era_zk_evm_tpu.native.run_oracle`: status, cycles, registers and
pointer tags, flags, the entry frame's heap, and the memory, log and
decommit witness streams byte for byte.  No XLA program is compiled.  The
jax-free copies of the generators (`testing/fuzz_programs.py`) are held
equal to their sources."""

import random

import numpy as np
import pytest

from era_zk_evm_tpu.native import ST_DONE, run_oracle
from era_zk_evm_tpu.utils import from_limbs
from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.models import fused_cycle
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import fuzz_programs as fz
from era_zk_evm_tpu_torch.witness import packed

from test_torch_kernel_host import _host_run
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401


def _records(words: np.ndarray, valid: np.ndarray, b: int) -> list[bytes]:
    """Lane b's valid record rows as serialized bytes."""
    rows = words[b][valid[b]]
    return [r.astype("<u4").tobytes() for r in rows]


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
    mem_words, mem_valid = (x.numpy() for x in packed.memory_record_words(st))
    log_words, log_valid = (x.numpy() for x in packed.log_record_words(st))
    for b, want in enumerate(native):
        assert want["status"] == ST_DONE, (b, want["status"])
        assert want["cycles"] == int(got["monotonic_cycle_counter"][b]), b
        for i in range(15):
            assert want["registers"][i] == from_limbs(got["regs"][b, i]), \
                (b, f"r{i + 1}")
            assert want["reg_ptr"][i] == bool(got["reg_ptr"][b, i]), \
                (b, f"r{i + 1}")
        assert want["flags"] == tuple(bool(x) for x in got["flags"][b]), b
        heap = [from_limbs(got["heap"][b, i]) for i in range(64)]
        assert heap == want["heap"], b
        assert _records(mem_words.view(np.uint32), mem_valid, b) \
            == want["witness_records"], b
        assert _records(log_words.view(np.uint32), log_valid, b) \
            == want["log_records"], b
        if name == "far_call":
            # one decommit row a cycle, valid ones flagged by bit 0
            meta, h = got["dq_meta"][b], got["dq_hash"][b]
            rows = np.flatnonzero(meta[:, 3] & 1)
            assert len(rows) == int(got["dq_count"][b]), b
            assert [(from_limbs(h[i]), int(meta[i, 0]), int(meta[i, 1]),
                     int(meta[i, 2]), bool(meta[i, 3] & 2))
                    for i in rows] == \
                [(d["hash"], d["timestamp"], d["page"], d["length"],
                  d["is_fresh"]) for d in want["decommit_records"]], b


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
