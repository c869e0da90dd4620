"""The port's spill protocols (`era_zk_evm_tpu_torch/models/spill.py`).

Each host step against the JAX function on the same numpy state, every
state field and every host map equal (the JAX steps are numpy plus
`jnp.asarray`: no cycle program is compiled): `normalize_callstack`,
`spill_storage_kv`, `rehydrate_keys`, `reclaim_heap_frames`,
`spill_code_bank`, `rehydrate_code`, `compact_log_state_host` and both
`_touched_*` detectors.  The states are drawn from a seed over the whole
u32 range, so storage keys, code hashes and frame rows have limbs with
bit 31 set (the port carries u32 as int32: a host-map key built from the
signed values would never match).  Then the seven scenarios of
`tests/test_spill.py`, port against port (segmented equals one-shot),
through the plain engine (`batched_vm.run_cycles`) and through K1's body
as g++ builds it for the host, in `fused_cycle`'s launch plumbing
(`k1_args`).
"""

import ctypes
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from era_zk_evm_tpu.models import spill as jspill
from era_zk_evm_tpu.models import state as jstate
from era_zk_evm_tpu.utils import u256_host as ju256
from era_zk_evm_tpu_torch import _build
from era_zk_evm_tpu_torch.config import CS, VmConfig
from era_zk_evm_tpu_torch.isa import params as P
from era_zk_evm_tpu_torch.isa.abi import (
    FarCallABI, FatPointer, ForwardingMode, RetABI, code_hash_for_bytecode,
)
from era_zk_evm_tpu_torch.isa.assembler import assemble_to_code_words
from era_zk_evm_tpu_torch.models import batched_vm, fused_cycle, spill
from era_zk_evm_tpu_torch.models import state as pstate
from era_zk_evm_tpu_torch.testing import spill_programs
from era_zk_evm_tpu_torch.utils import u256_host
from era_zk_evm_tpu_torch.witness.commitment import (
    device_decommit_streams, device_log_streams, device_queue_streams,
    serialize_decommittment, serialize_log_query, serialize_memory_query,
)
from era_zk_evm_tpu_torch.witness.queries import LogQuery
from test_spill import PROG, RECURSE
from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

TOP = 0x80000000          # bit 31 of a limb
#: a storage key base with bit 31 set in every limb
HIGH_KEY = sum(TOP << (32 * i) for i in range(8))


# --------------------------------------------------------------------------
# the two packages on one numpy state


def _jax(config: VmConfig, arrays: dict):
    """The JAX config and state of `arrays`, copied (on the CPU a JAX
    array may share a numpy array's memory, and `state_to_numpy` of a CPU
    state shares the tensors')."""
    return (jstate.VmConfig(**dataclasses.asdict(config)),
            jstate.BatchedVmState(**{k: jnp.asarray(np.array(v))
                                     for k, v in arrays.items()}))


def _port(arrays: dict):
    return pstate.state_from_numpy(arrays, "cpu")


def assert_same_state(jst, pst):
    got = pstate.state_to_numpy(pst)
    bad = [f.name for f in dataclasses.fields(jst)
           if not np.array_equal(np.asarray(getattr(jst, f.name)),
                                 got[f.name])]
    assert not bad, f"port/jax mismatch in fields: {bad}"


def _plain(value):
    """Host-map values as plain nested tuples / dicts of ints."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        assert value.dtype == np.uint32
        return tuple(map(_plain, value)) if value.ndim > 1 \
            else tuple(int(x) for x in value)
    return value


def assert_same_maps(jmaps, pmaps):
    for jm, pm in zip(jmaps, pmaps, strict=True):
        assert all(isinstance(x, int) and 0 <= x < (1 << 32)
                   for k in pm for x in k)
        assert list(jm) == list(pm)                     # insertion order
        assert _plain(jm) == _plain(pm)


def _u32(rng, *shape):
    """u32 values over the whole range: about half have bit 31 set."""
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _config(**kw):
    base = dict(batch=6, code_words=4, stack_words=1040, heap_words=4,
                aux_heap_words=2, max_depth=8, storage_slots=8,
                journal_slots=6, event_slots=4, log_queue_capacity=4,
                heap_frames=4, code_pages=4)
    return VmConfig(**{**base, **kw})


# --------------------------------------------------------------------------
# copies


def test_u256_host_copy_equals_original():
    names = [n for n, _ in inspect.getmembers(ju256, inspect.isfunction)]
    assert names
    for name in names:
        assert inspect.getsource(getattr(u256_host, name)) \
            == inspect.getsource(getattr(ju256, name)), name
    assert (u256_host.NUM_LIMBS, u256_host.U32_MASK) \
        == (ju256.NUM_LIMBS, ju256.U32_MASK)
    import era_zk_evm_tpu.utils as jutils
    import era_zk_evm_tpu_torch.utils as putils

    public = [n for n in dir(jutils) if not n.startswith("_")
              and n != "u256_host"]
    assert public == [n for n in dir(putils) if not n.startswith("_")
                      and n != "u256_host"]


# --------------------------------------------------------------------------
# host steps, one by one


def _callstack_state(rng, config, depths):
    st = pstate._empty_numpy(config)
    for name in spill.CS_ARRAYS:
        st[name][:] = _u32(rng, *st[name].shape)
    st["depth"][:] = depths
    return st


def _frames(rng, config, counts):
    out = []
    for n in counts:
        out.append([{name: _u32(rng, *shape) for name, shape in (
            ("cs_this_address", (5,)), ("cs_msg_sender", (5,)),
            ("cs_code_address", (5,)), ("cs_context_u128", (4,)),
            ("cs_scalars", (len(CS),)))} for _ in range(n)])
    return out


@pytest.mark.parametrize("lo,hi", [(2, 3), (3, 6), (6, 6), (1, 2)])
def test_normalize_callstack_matches_jax(lo, hi):
    rng = np.random.default_rng(1)
    config = _config()
    arrays = _callstack_state(rng, config, [6, 5, 1, 2, 4, 3])
    frames = _frames(rng, config, [0, 3, 4, 0, 2, 7])
    jcfg, jst = _jax(config, arrays)
    jspilled = jspill.SpilledFrames(
        [[{k: v.copy() for k, v in f.items()} for f in lane]
         for lane in frames])
    pst = _port(arrays)
    pspilled = spill.SpilledFrames(
        [[{k: v.copy() for k, v in f.items()} for f in lane]
         for lane in frames])
    jst, jspilled = jspill.normalize_callstack(jst, jcfg, jspilled, lo, hi)
    out, pspilled = spill.normalize_callstack(pst, config, pspilled, lo, hi)
    assert out is pst
    assert_same_state(jst, pst)
    assert [[_plain(f) for f in lane] for lane in pspilled.frames] \
        == [[_plain(f) for f in lane] for lane in jspilled.frames]


def _storage_state(rng, config):
    B, S, J = config.batch, config.storage_slots, config.journal_slots
    st = pstate._empty_numpy(config)
    st["st_key"][:] = _u32(rng, B, S, 14)
    st["st_val"][:] = _u32(rng, B, S, 8)
    st["st_used"][:] = rng.random((B, S)) < 0.8
    st["st_used"][0] = True
    st["st_count"][:] = [S, S, 5, 0, 7, S]
    st["j_count"][:] = [0, 3, 2, 0, J, 1]
    for b in range(B):
        n = int(st["st_count"][b])
        live = [i for i in range(n) if st["st_used"][b, i]] or [0]
        st["j_slot"][b] = rng.choice(live, size=J)
    return st


def _host_storage(rng, config, keys_per_lane):
    return [{tuple(int(x) for x in _u32(rng, 14)): _u32(rng, 8)
             for _ in range(n)} for n in keys_per_lane]


@pytest.mark.parametrize("keep", [0, 2])
def test_spill_storage_kv_matches_jax(keep):
    rng = np.random.default_rng(2)
    config = _config()
    arrays = _storage_state(rng, config)
    maps = _host_storage(rng, config, [2, 0, 1, 0, 0, 3])
    jcfg, jst = _jax(config, arrays)
    jhost = jspill.HostStorage([dict(m) for m in maps])
    pst = _port(arrays)
    phost = spill.HostStorage([dict(m) for m in maps])
    jst, jhost = jspill.spill_storage_kv(jst, jcfg, jhost, keep)
    _, phost = spill.spill_storage_kv(pst, config, phost, keep)
    assert_same_state(jst, pst)
    assert_same_maps(jhost.maps, phost.maps)
    assert any(k[0] & TOP for m in phost.maps for k in m)


def test_rehydrate_keys_matches_jax():
    rng = np.random.default_rng(3)
    config = _config()
    arrays = _storage_state(rng, config)
    arrays["st_count"][:] = [3, 0, 5, 0, 6, 8]
    maps = _host_storage(rng, config, [3, 4, 0, 2, 2, 1])
    # every lane asks for some of its keys (as the detectors' sets, built
    # in the same order) and one it does not hold
    needed = [set(list(m)[:3]) | {tuple(range(14))} for m in maps]
    needed[5] = set()
    jcfg, jst = _jax(config, arrays)
    jhost = jspill.HostStorage([dict(m) for m in maps])
    pst = _port(arrays)
    phost = spill.HostStorage([dict(m) for m in maps])
    jst = jspill.rehydrate_keys(jst, jcfg, jhost, needed)
    assert spill.rehydrate_keys(pst, config, phost, needed) is pst
    assert_same_state(jst, pst)
    assert_same_maps(jhost.maps, phost.maps)


def _frame_state(rng, config):
    B, F, D = config.batch, config.heap_frames, config.max_depth
    st = pstate._empty_numpy(config)
    st["heap"][:] = _u32(rng, *st["heap"].shape)
    st["aux_heap"][:] = _u32(rng, *st["aux_heap"].shape)
    st["stack"][:] = _u32(rng, *st["stack"].shape)
    pages = rng.permutation(np.arange(100, 100 + 2 * F)).astype(np.uint32)
    st["hp_page"][:] = pages[:F] | np.uint32(TOP)
    st["ap_page"][:] = pages[F:]
    st["frame_count"][:] = [1, 2, 4, 3, 4, 5]
    st["depth"][:] = [1, 2, 3, 5, 2, 4]
    st["cs_scalars"][:, :, CS["heap_slot"]] = rng.integers(0, 2, (B, D))
    st["cs_scalars"][4, :, CS["heap_slot"]] = 3
    # tagged pointers to some pages: registers and stack words (limb 1)
    st["reg_ptr"][1, 3] = st["reg_ptr"][3, 0] = st["reg_ptr"][5, 2] = True
    st["regs"][1, 3, 1] = st["hp_page"][1, 1]
    st["regs"][3, 0, 1] = st["ap_page"][3, 2]
    st["regs"][5, 2, 1] = st["hp_page"][5, 3]
    st["regs"][2, 4, 1] = st["hp_page"][2, 3]          # untagged: dead
    words = st["stack"].reshape(B, -1, 8)
    words[4, 17, 1] = st["ap_page"][4, 2]
    words[2, 9, 1] = st["hp_page"][2, 2]
    st["stack_ptr_tag"][4, 17] = st["stack_ptr_tag"][2, 9] = True
    return st


def test_reclaim_heap_frames_matches_jax():
    rng = np.random.default_rng(4)
    config = _config()
    arrays = _frame_state(rng, config)
    jcfg, jst = _jax(config, arrays)
    pst = _port(arrays)
    jst = jspill.reclaim_heap_frames(jst, jcfg)
    assert spill.reclaim_heap_frames(pst, config) is pst
    assert_same_state(jst, pst)
    fc = pstate.state_to_numpy(pst)["frame_count"]
    assert (fc < arrays["frame_count"]).any() \
        and (fc == arrays["frame_count"]).any()


def _bank_state(rng, config):
    B, P_, D = config.batch, config.code_pages, config.max_depth
    st = pstate._empty_numpy(config)
    st["cb_hash"][:] = _u32(rng, B, P_, 8)
    st["cb_len"][:] = rng.integers(1, config.code_words + 1, (B, P_))
    st["cb_page"][:] = rng.integers(0, 4, (B, P_)) * 8
    st["cb_valid"][:] = rng.random((B, P_)) < 0.8
    st["cb_valid"][:, 0] = True
    st["cb_valid"][1] = True
    st["code"][:] = _u32(rng, *st["code"].shape)
    st["depth"][:] = [1, 2, 3, 1, 2, 4]
    st["cs_scalars"][:, :, CS["code_page"]] = rng.integers(0, 4, (B, D)) * 8
    st["previous_code_page"][:] = rng.integers(0, 4, B) * 8
    st["default_aa_hash"][:] = _u32(rng, B, 8)
    st["default_aa_hash"][2] = st["cb_hash"][2, 3]
    return st


@pytest.mark.parametrize("keep,pins", [(0, False), (1, False), (0, True)])
def test_spill_code_bank_matches_jax(keep, pins):
    rng = np.random.default_rng(5)
    config = _config()
    arrays = _bank_state(rng, config)
    pin_hashes = None
    if pins:
        pin_hashes = [{tuple(int(x) for x in arrays["cb_hash"][b, s])}
                      for b, s in enumerate([1, 2, 3, 1, 2, 3])]
        pin_hashes[3] = set()
    jcfg, jst = _jax(config, arrays)
    jhost = jspill.HostCodeBank.empty(config.batch)
    pst = _port(arrays)
    phost = spill.HostCodeBank.empty(config.batch)
    jst, jhost = jspill.spill_code_bank(jst, jcfg, jhost, keep, pin_hashes)
    _, phost = spill.spill_code_bank(pst, config, phost, keep, pin_hashes)
    assert_same_state(jst, pst)
    assert_same_maps(jhost.maps, phost.maps)
    assert any(phost.maps)


def test_spill_code_bank_full_banks_unchanged():
    rng = np.random.default_rng(6)
    config = _config()
    arrays = _bank_state(rng, config)
    arrays["cb_valid"][:] = True
    pst = _port(arrays)
    pins = [{tuple(int(x) for x in h) for h in lane}
            for lane in arrays["cb_hash"]]
    _, host = spill.spill_code_bank(pst, config,
                                    spill.HostCodeBank.empty(6), 0, pins)
    assert not any(host.maps)
    assert_same_state(_jax(config, arrays)[1], pst)


def test_rehydrate_code_matches_jax():
    rng = np.random.default_rng(7)
    config = _config()
    arrays = _bank_state(rng, config)
    arrays["cb_valid"][:, 1:] = False
    arrays["cb_valid"][4, 2] = True         # a hole below the free slots
    CW = config.code_words
    maps = [{tuple(int(x) for x in _u32(rng, 8)): {
        "page": int(rng.integers(0, 64)), "len": int(rng.integers(1, CW)),
        "words": _u32(rng, CW, 8)} for _ in range(n)}
        for n in [3, 1, 0, 2, 4, 1]]
    needed = [set(list(m)[:2]) | {tuple(range(8))} for m in maps]
    needed[1] = set()
    jcfg, jst = _jax(config, arrays)
    jhost = jspill.HostCodeBank([dict(m) for m in maps])
    pst = _port(arrays)
    phost = spill.HostCodeBank([dict(m) for m in maps])
    jst = jspill.rehydrate_code(jst, jcfg, jhost, needed)
    assert spill.rehydrate_code(pst, config, phost, needed) is pst
    assert_same_state(jst, pst)
    assert_same_maps(jhost.maps, phost.maps)


def _executor_config(batch=2, **kw):
    # tests/test_executor.py's tight geometry
    return VmConfig(**{**dict(
        batch=batch, code_words=32, stack_words=2048, heap_words=16,
        aux_heap_words=8, max_depth=15, queue_capacity=8 * 8,
        storage_slots=8, journal_slots=64, event_slots=64,
        log_queue_capacity=16, heap_frames=4, code_pages=3,
        decommit_queue_capacity=16), **kw})


def _executor_state(config, programs, callees, staged):
    return spill_programs.stage(config, programs, callees, staged, "cpu")


@pytest.fixture(scope="module")
def mid_run():
    """The executor's program 40 cycles in (recursion unwound, storage
    writes and far calls under way): (config, port state)."""
    callees = spill_programs.callees(3)
    config = _executor_config(queue_capacity=0, log_queue_capacity=64,
                              decommit_queue_capacity=0, code_pages=4,
                              storage_slots=16)
    # storage keys with bit 31 set in their limbs
    programs = [spill_programs.caller(callees, HIGH_KEY + 1000 * (b + 1), 5,
                                      6) for b in range(2)]
    st = _executor_state(config, programs, callees, callees)
    batched_vm.run_cycles(st, config, 40)
    assert not bool(st.lane_error.any()) and int(st.lq_count.min()) > 4
    return config, st


def test_compact_log_state_host_matches_jax(mid_run):
    config, st = mid_run
    arrays = pstate.state_to_numpy(st)
    assert arrays["j_count"].min() > 0 and arrays["ev_count"].min() > 0
    jcfg, jst = _jax(config, arrays)
    pst = _port(arrays)
    jst = jspill.compact_log_state_host(jst, jcfg)
    assert spill.compact_log_state_host(pst, config) is pst
    assert_same_state(jst, pst)
    quiet = dataclasses.replace(config, journal_slots=0, event_slots=0)
    assert spill.compact_log_state_host(pst, quiet) is pst


def _synthetic_logs():
    """Log queries whose keys, addresses and read values have limbs with
    bit 31 set, with the filters' edge cases."""
    deployer = P.DEPLOYER_SYSTEM_CONTRACT_ADDRESS
    big = sum((TOP | (0x1234567 * (i + 1))) << (32 * i) for i in range(8))
    marker = 0x01 << 248        # the versioned hash's marker byte

    def q(aux, address, key, read, rw):
        return LogQuery(timestamp=1, tx_number_in_block=0, aux_byte=aux,
                        shard_id=1, address=address, key=key,
                        read_value=read, written_value=0, rw_flag=rw,
                        rollback=False, is_service=False)

    lane = [q(P.STORAGE_AUX_BYTE, (TOP << 128) | 5, big, 0, True),
            q(P.STORAGE_AUX_BYTE, deployer, big >> 3, big | marker, False),
            q(P.STORAGE_AUX_BYTE, deployer, 7, marker | TOP, True),
            q(P.EVENT_AUX_BYTE, deployer, big, big, False),
            q(P.STORAGE_AUX_BYTE, deployer, big, big, False)]
    return [lane, lane[::-1], []]


def test_detectors_match_jax(mid_run):
    config, st = mid_run
    logs = device_log_streams(st)
    # the segment loops' detector, on the packed log records
    got = spill._touched_in_log_queue(st)
    want = (spill._touched_storage_keys(logs),
            spill._touched_code_hashes(logs))
    assert got == want and all(want[0]) and all(want[1])
    assert [[list(s) for s in t] for t in got] \
        == [[list(s) for s in t] for t in want]
    assert all(any(k[0] & TOP for k in lane) for lane in got[0])
    assert all(any(h[0] & TOP or h[1] & TOP for h in lane)
               for lane in got[1])
    for logs in (logs, _synthetic_logs()):
        for port_fn, jax_fn in (
                (spill._touched_storage_keys, jspill._touched_storage_keys),
                (spill._touched_code_hashes, jspill._touched_code_hashes)):
            got, want = port_fn(logs), jax_fn(logs)
            assert got == want and any(got)
            # the same iteration order: rehydration fills slots in it
            assert [list(s) for s in got] == [list(s) for s in want]
    keys = spill._touched_storage_keys(_synthetic_logs())[0]
    assert any(k[0] & TOP for k in keys) and any(k[12] & TOP for k in keys)
    hashes = spill._touched_code_hashes(_synthetic_logs())[0]
    # the marker byte (bits 240..247) cleared, the top bits kept
    assert any(h[0] & TOP and h[7] & TOP and not (h[7] >> 16) & 0xFF
               for h in hashes)


# --------------------------------------------------------------------------
# the seven scenarios of tests/test_spill.py, port against port


@pytest.fixture(scope="module")
def host():
    return _build.load_host()


def _k1_host_engine(lib):
    """run_cycles(state, config, n) through K1's body as g++ builds it for
    the host, launched through fused_cycle.k1_args."""
    def run(st, config, n):
        step0 = st.global_step.min()    # alive until the call returns
        args = fused_cycle.k1_args(st, config, n, n, None, step0)
        assert lib.eravm_k1_host(ctypes.byref(args), 0) == 0
        return st
    return run


@pytest.fixture(params=["plain", "k1_host"])
def engine(request):
    """The plain engine's run_cycles, or K1's body's."""
    if request.param == "plain":
        return batched_vm.run_cycles
    return _k1_host_engine(request.getfixturevalue("host"))


def _serialized(streams, ser):
    return [[ser(q) for q in lane] for lane in streams]


def _merged_storage(arrays, host_maps=None):
    out = []
    for b in range(arrays["st_key"].shape[0]):
        m = {k: tuple(int(x) for x in v)
             for k, v in (host_maps[b].items() if host_maps else ())}
        for i in np.nonzero(arrays["st_used"][b])[0]:
            m[tuple(int(x) for x in arrays["st_key"][b, i])] = \
                tuple(int(x) for x in arrays["st_val"][b, i])
        out.append(m)
    return out


def test_queue_drain_segmented_equals_one_shot(engine):
    words = [assemble_to_code_words(PROG)] * 2
    kw = dict(batch=2, heap_words=16, stack_words=2048, code_words=64,
              max_depth=8, storage_slots=8, journal_slots=16,
              event_slots=16)
    big = VmConfig(queue_capacity=32 * 8, log_queue_capacity=32, **kw)
    small = VmConfig(queue_capacity=8 * 8, log_queue_capacity=8, **kw)
    ref = engine(pstate.make_entry_state(big, words, ergs=1 << 20,
                                         device="cpu"), big, 32)
    _, want = spill.drain_witness_queues(ref, big)
    st = pstate.make_entry_state(small, words, ergs=1 << 20, device="cpu")
    got = {"memory": [[], []], "log": [[], []]}
    for _ in range(4):
        st, streams = spill.drain_witness_queues(engine(st, small, 8), small)
        for name in got:
            for b in range(2):
                got[name][b].extend(streams[name][b])
    assert not bool(st.lane_error.any())
    assert _serialized(got["memory"], serialize_memory_query) \
        == _serialized(want["memory"], serialize_memory_query)
    assert _serialized(got["log"], serialize_log_query) \
        == _serialized(want["log"], serialize_log_query)
    assert all(got["log"])


def test_storage_kv_4x_distinct_keys_segmented(engine):
    prog = """
        add 1, r0, r10
        add code[@n], r0, r1
        add 0, r0, r2
        loop:
        add r2, r10, r2
        log.swrite r2, r2
        and 7, r2, r4
        add r4, r10, r4
        log.sread r4, r5
        sub! r1, r10, r1
        jump.if_ne @loop
        ret r0
        n: .word 32
    """
    words = [assemble_to_code_words(prog)] * 2
    kw = dict(batch=2, queue_capacity=0, heap_words=16, stack_words=2048,
              code_words=64, max_depth=8, event_slots=8)
    big = VmConfig(storage_slots=40, journal_slots=256,
                   log_queue_capacity=256, **kw)
    n_cycles = 32 * 7 + 8
    ref = engine(pstate.make_entry_state(big, words, ergs=1 << 20,
                                         device="cpu"), big, n_cycles)
    assert not bool(ref.lane_error.any())
    _, want = spill.drain_witness_queues(ref, big)
    small = VmConfig(storage_slots=8, journal_slots=256,
                     log_queue_capacity=32, **kw)
    st = pstate.make_entry_state(small, words, ergs=1 << 20, device="cpu")
    st, host_st, got = spill.run_segments_storage(st, small, engine,
                                                  n_cycles, segment=16)
    assert not bool(st.lane_error.any())
    assert _serialized(got["log"], serialize_log_query) \
        == _serialized(want["log"], serialize_log_query)
    assert _merged_storage(pstate.state_to_numpy(st), host_st.maps) \
        == _merged_storage(pstate.state_to_numpy(ref))
    assert all(host_st.maps)


def test_storage_kv_high_keys_segmented(host):
    # the same protocol over keys with bit 31 set in every limb: evicted
    # keys are re-read, so a host-map key that did not match the detector's
    # would go unrehydrated and the segment would read a zero
    prog = f"""
        add 1, r0, r10
        add code[@n], r0, r1
        add code[@base], r0, r14
        add 0, r0, r2
        loop:
        add r2, r10, r2
        add r2, r14, r3
        log.swrite r3, r2
        and 7, r2, r4
        add r4, r10, r4
        add r4, r14, r4
        log.sread r4, r5
        sub! r1, r10, r1
        jump.if_ne @loop
        ret r0
        n: .word 32
        base: .word {HIGH_KEY}
    """
    engine = _k1_host_engine(host)
    words = [assemble_to_code_words(prog)] * 2
    kw = dict(batch=2, queue_capacity=0, heap_words=16, stack_words=2048,
              code_words=64, max_depth=8, event_slots=8)
    big = VmConfig(storage_slots=40, journal_slots=256,
                   log_queue_capacity=320, **kw)
    n_cycles = 32 * 9 + 8
    ref = engine(pstate.make_entry_state(big, words, ergs=1 << 20,
                                         device="cpu"), big, n_cycles)
    assert bool(ref.done.all()) and not bool(ref.lane_error.any())
    _, want = spill.drain_witness_queues(ref, big)
    small = VmConfig(storage_slots=8, journal_slots=256,
                     log_queue_capacity=32, **kw)
    st = pstate.make_entry_state(small, words, ergs=1 << 20, device="cpu")
    st, host_st, got = spill.run_segments_storage(st, small, engine,
                                                  n_cycles, segment=16)
    assert _serialized(got["log"], serialize_log_query) \
        == _serialized(want["log"], serialize_log_query)
    assert _merged_storage(pstate.state_to_numpy(st), host_st.maps) \
        == _merged_storage(pstate.state_to_numpy(ref))
    assert all(k[0] & TOP and k[7] & TOP for m in host_st.maps for k in m)
    assert all(m for m in host_st.maps)


def test_many_far_calls_through_small_frame_pool(engine):
    n_calls, callee_addr = 12, 0x20042
    r_abi = RetABI(FatPointer(0, 0, 0, 32), ForwardingMode.USE_HEAP).to_u256()
    f_abi = FarCallABI(FatPointer(0, 0, 0, 32), (1 << 30), 0,
                       ForwardingMode.USE_HEAP, False, False).to_u256()
    callee = assemble_to_code_words(f"""
        ld.ptr r1, r5
        add 7, r0, r6
        add r5, r6, r5
        st.h 0, r5
        add code[@rabi], r0, r7
        ret r7
        rabi: .word {r_abi}
    """)
    h = code_hash_for_bytecode(callee)
    caller = assemble_to_code_words(f"""
        add 1, r0, r10
        add code[@n], r0, r13
        add 0, r0, r3
        loop:
        st.h 0, r3
        add code[@abi], r0, r4
        add code[@dest], r0, r2
        far_call r4, r2, @fail
        ld.ptr r1, r3
        sub! r13, r10, r13
        jump.if_ne @loop
        ret r0
        fail:
        panic
        abi: .word {f_abi}
        dest: .word {callee_addr}
        n: .word {n_calls}
    """)
    entries = [(0, P.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, callee_addr, h)]
    n_cycles = n_calls * 12

    def build(frames):
        cfg = VmConfig(batch=2, code_words=16, stack_words=2048,
                       heap_words=16, aux_heap_words=8, max_depth=8,
                       queue_capacity=n_cycles * 8, storage_slots=4,
                       journal_slots=8, event_slots=8,
                       log_queue_capacity=n_cycles, heap_frames=frames,
                       code_pages=2, decommit_queue_capacity=n_cycles)
        st = pstate.make_entry_state(cfg, [caller] * 2, ergs=1 << 24,
                                     device="cpu")
        pstate.populate_storage(st, cfg, [entries] * 2)
        return cfg, pstate.populate_code_bank(st, cfg, [[(h, callee)]] * 2)

    big_cfg, big = build(n_calls + 2)
    engine(big, big_cfg, n_cycles)
    assert bool(big.done.all()) and not bool(big.lane_error.any())
    small_cfg, small = build(4)
    for _ in range(n_cycles // 12):
        engine(small, small_cfg, 12)
        spill.reclaim_heap_frames(small, small_cfg)
        assert int(small.frame_count.max()) <= 3
    assert bool(small.done.all()) and not bool(small.lane_error.any())
    assert torch.equal(small.regs, big.regs)
    assert torch.equal(small.reg_ptr, big.reg_ptr)
    assert _serialized(device_queue_streams(small), serialize_memory_query) \
        == _serialized(device_queue_streams(big), serialize_memory_query)
    assert _serialized(device_log_streams(small), serialize_log_query) \
        == _serialized(device_log_streams(big), serialize_log_query)


def test_decommit_heavy_through_small_code_bank(engine):
    r_abi = RetABI(FatPointer(0, 0, 0, 0), ForwardingMode.USE_HEAP).to_u256()
    f_abi = FarCallABI(FatPointer(0, 0, 0, 0), 1 << 30, 0,
                       ForwardingMode.USE_HEAP, False, False).to_u256()
    callees = []
    for k in range(3):
        words = assemble_to_code_words(f"""
            add {k + 5}, r0, r11
            log.swrite r11, r11
            add code[@rabi], r0, r7
            ret r7
            rabi: .word {r_abi}
        """)
        callees.append((0x20042 + k, code_hash_for_bytecode(words), words))
    calls = "\n".join(f"add code[@abi], r0, r4\n"
                      f"add code[@d{i % 3}], r0, r2\n"
                      f"far_call r4, r2, @fail" for i in range(6))
    caller = assemble_to_code_words(f"""
        {calls}
        ret r0
        fail:
        panic
        abi: .word {f_abi}
        d0: .word {callees[0][0]}
        d1: .word {callees[1][0]}
        d2: .word {callees[2][0]}
    """)
    n_cycles, B = 6 * 8 + 8, 2

    def build(code_pages, staged):
        cfg = VmConfig(batch=B, code_words=16, stack_words=2048,
                       heap_words=16, aux_heap_words=8, max_depth=8,
                       queue_capacity=0, storage_slots=8, journal_slots=16,
                       event_slots=8, log_queue_capacity=n_cycles,
                       heap_frames=8, code_pages=code_pages,
                       decommit_queue_capacity=n_cycles)
        return cfg, _executor_state(cfg, [caller] * B, callees, staged)

    big_cfg, big = build(5, callees)
    engine(big, big_cfg, n_cycles)
    assert bool(big.done.all()) and not bool(big.lane_error.any())
    small_cfg, small = build(3, callees[:2])
    host_cb = spill_programs.cold_code_hosts(small_cfg, callees[2:]).code
    small, host_cb, got = spill.run_segments_decommit(
        small, small_cfg, engine, n_cycles, segment=8, host=host_cb)
    assert bool(small.done.all()) and not bool(small.lane_error.any())
    assert torch.equal(small.regs, big.regs)
    assert _serialized(got["log"], serialize_log_query) \
        == _serialized(device_log_streams(big), serialize_log_query)
    assert _serialized(got["decommit"], serialize_decommittment) \
        == _serialized(device_decommit_streams(big), serialize_decommittment)
    assert any(host_cb.maps)


def _recurse(engine, segment):
    config = VmConfig(batch=2, queue_capacity=0, heap_words=16,
                      stack_words=2048, code_words=64, max_depth=8)
    st = pstate.make_entry_state(
        config, [assemble_to_code_words(RECURSE)] * 2, ergs=1 << 20,
        device="cpu")
    if segment is None:     # one shot, on a device stack deep enough
        deep = dataclasses.replace(config, max_depth=16)
        st = pstate.make_entry_state(
            deep, [assemble_to_code_words(RECURSE)] * 2, ergs=1 << 20,
            device="cpu")
        return engine(st, deep, 80), None
    return spill.run_segments(st, config, engine, n_cycles=80,
                              segment=segment)


def test_deep_recursion_through_shallow_device_stack(engine):
    # architectural depth reaches 14; the device holds 8 frames
    st, spilled = _recurse(engine, 2)
    ref, _ = _recurse(engine, None)
    assert bool(st.done.all()) and not bool(st.lane_error.any())
    assert all(not f for f in spilled.frames)
    assert torch.equal(st.regs, ref.regs)
    assert torch.equal(st.monotonic_cycle_counter,
                       ref.monotonic_cycle_counter)
    root = pstate.reference_view(st).cs_scalars[:, 0, CS["ergs_remaining"]]
    want = pstate.reference_view(ref).cs_scalars[:, 0, CS["ergs_remaining"]]
    assert torch.equal(root, want)


def test_normalize_roundtrip_preserves_frames(engine):
    config = VmConfig(batch=1, queue_capacity=0, heap_words=16,
                      stack_words=2048, code_words=64, max_depth=8)
    st = pstate.make_entry_state(config, [assemble_to_code_words(RECURSE)],
                                 ergs=1 << 20, device="cpu")
    engine(st, config, 9)                      # partway down the recursion
    before = pstate.state_to_numpy(st)
    d0 = int(before["depth"][0])
    assert d0 > 3
    spilled = spill.SpilledFrames.empty(1)
    st, spilled = spill.normalize_callstack(st, config, spilled, lo=2, hi=2)
    assert int(st.depth[0]) == 2 and spilled.spilled_depth(0) == d0 - 2
    st, spilled = spill.normalize_callstack(st, config, spilled, lo=d0,
                                            hi=config.max_depth - 2)
    assert spilled.spilled_depth(0) == 0
    after = pstate.state_to_numpy(st)
    for name in ("cs_scalars", "cs_this_address"):
        assert np.array_equal(after[name][0, :d0 + 1],
                              before[name][0, :d0 + 1])


def test_deep_recursion_engines_agree(host):
    # tests/test_spill.py's fused-engine case: the segmented run through
    # K1's body equals the segmented run through the plain engine, field
    # for field
    plain, p_spill = _recurse(batched_vm.run_cycles, 2)
    kern, k_spill = _recurse(_k1_host_engine(host), 2)
    a, b = pstate.state_to_numpy(plain), pstate.state_to_numpy(kern)
    assert not [k for k in a if not np.array_equal(a[k], b[k])]
    assert p_spill.frames == k_spill.frames == [[], []]
