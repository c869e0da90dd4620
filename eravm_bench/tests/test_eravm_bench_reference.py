"""The plain reference (reference/) held equal to the port's plain engine at
a tiny batch, for each cell's mix, through the harness's own comparison;
and the reference's parts against hand-worked values."""

import json

import numpy as np
import pytest

from eravm_bench import cells
from eravm_bench.reference import expected, isa_tables, oracle

CELLS = [w["name"] for w in json.loads(
    (cells.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_plain_engine(cpu_run, cell):
    res = cpu_run(cell)
    assert res.notes == []
    assert res.correct
    assert res.checks == dict.fromkeys(cells.load_cell(cell).judge, 0)
    assert res.failed == 0 and res.attempted == 4 * 2


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_plain_engine_across_transactions(cell):
    """Every program of the mix, on two lanes each, with transactions of 1
    to 4 iterations, so that lanes cross many transactions and wrap their
    table of lengths inside the run."""
    import copy
    import time

    from eravm_bench import harness

    c = copy.deepcopy(cells.load_cell(cell))
    for spec in c.traffic["draws"].values():
        if "lognormal_int" in spec:
            spec["lognormal_int"]["clip"] = [1, 4]
    n = 2 * len(c.traffic["programs"])
    res = harness.run(c, 2**32 + 9, None, False, time.perf_counter(),
                      device="cpu", batch=n, window_chunks=3, warm_chunks=1,
                      calls_per_sync=2, judged=n)
    assert res.notes == [] and res.correct
    assert res.checks == dict.fromkeys(c.judge, 0)
    assert res.failed == 0


def test_oracle_records_round_trip():
    rec = np.zeros((1, 64), dtype=np.uint8)
    rec[0, 0:4] = [0, 0, 4, 1]            # timestamp 1025, big-endian
    rec[0, 4] = 1                         # type
    rec[0, 5:9] = [0, 0, 0, 10]           # page 10
    rec[0, 9:13] = [0, 0, 1, 2]           # index 258
    rec[0, 13] = 3                        # rw, pointer
    rec[0, 63] = 7                        # value 7
    rec[0, 32] = 0x80                     # value's top byte
    rows = expected.oracle_records(rec)
    assert rows[0, :4].tolist() == [1025, 1, 10, 258]
    assert rows[0, 4] == 7 and rows[0, 11] == 0x80000000
    assert rows[0, 12] == 3
    meta = np.array([[1025, 1, 10, 258], [0, 0, 0, 0]], dtype=np.uint32)
    value = np.zeros((2, 8), dtype=np.uint32)
    value[0, 0], value[0, 7] = 7, 0x80000000
    flags = np.array([3 | 4, 0], dtype=np.uint32)
    assert np.array_equal(expected.records_from_rows(meta, value, flags),
                          rows)


def test_stack_window_map():
    vm = {"stack_words": 256, "stack_abs_words": 64, "stack_sp_base": 960}
    logical = expected.stack_logical(vm)
    assert logical[:64].tolist() == list(range(64))
    assert logical[64] == 960 and logical[-1] == 960 + 191


def test_oracle_sponge_counts_every_record():
    # a lane of the mix, a few cycles: the sponge counts the records it
    # was given
    traffic = json.loads(
        (cells.PKG / "traffic" / "tx-stream.json").read_text())
    words = cells.lane_programs(traffic, 1, 5)[0]
    out = oracle.run(words, ergs=traffic["ergs"], max_cycles=40,
                     stack_words=2048, heap_words=64, aux_words=16,
                     n_frames=8, witness_from=0, witness_cap=400,
                     sponge=True)
    assert out["status"] == oracle.ST_MAX_CYCLES and out["cycles"] == 40
    assert out["sponge_count"] == out["witness_count"] > 0
    dropped = oracle.run(words, ergs=traffic["ergs"], max_cycles=40,
                         stack_words=2048, heap_words=64, aux_words=16,
                         n_frames=8, witness_from=0, witness_cap=400,
                         sponge=True, drop_type=4)
    code_reads = int((out["witness"][:, 4] == 4).sum())
    assert code_reads > 0
    assert dropped["sponge_count"] == out["sponge_count"] - code_reads


def test_reference_tables_follow_the_pinned_isa():
    """Entry by entry, the reference's own decode and price tables against
    the pinned instruction set: the opcode families' sizes, the price of
    every class, and the panic, nop and invalid entries."""
    t = isa_tables.tables()
    assert t["n_variants"] == 1098
    packed, price = t["packed"], t["price"]
    fields = lambda p: (p & 0xF, (p >> 4) & 0xF, (p >> 8) & 0xF,  # noqa
                        (p >> 12) & 0x7)
    per_family = {}
    for i in range(t["n_variants"]):
        fam, sub, src, dst = fields(packed[i])
        per_family[fam] = per_family.get(fam, 0) + 1
        memory = src in (4, 5, 6, 8) or (dst in (4, 5, 6) and fam <= 9)
        want = {6: 5, 10: 25, 12: 179, 13: 5, 14: 9, 15: 2**32 - 1}.get(
            fam, (150, 250, 25, 100, 10)[sub] if fam == 11
            else 6 if memory else 5)
        assert price[i] == want, (i, fam, sub, src, dst)
    # sub-ops x src modes x dst modes x flag combinations
    assert per_family == {0: 24, 1: 48, 2: 96, 3: 48, 4: 96, 5: 6, 6: 10,
                          7: 384, 8: 144, 9: 192, 10: 1, 11: 10, 12: 12,
                          13: 6, 14: 20, 15: 1}
    assert fields(packed[t["panic"]])[:2] == (13, 2)
    assert packed[t["nop"]] & 0xFFFF == 3 << 8 | 3 << 12
    invalid = packed[t["n_variants"] - 1]
    assert invalid >> 23 & 1 and all(p == invalid for p in
                                     packed[t["n_variants"]:])
    assert len(packed) == len(price) == 2048


def test_reference_tables_equal_the_ports():
    """The port's generated tables, entry by entry, equal the reference's
    own: a drift in either shows here (this test alone reads the port's
    generator)."""
    from era_zk_evm_tpu_torch.isa.opcodes import (NOP_VARIANT_INDEX,
                                                  PANIC_VARIANT_INDEX,
                                                  table_arrays)

    t = isa_tables.tables()
    arrs = table_arrays()
    assert [int(x) for x in arrs["packed"]] == t["packed"]
    assert [int(x) for x in arrs["price"]] == t["price"]
    assert (PANIC_VARIANT_INDEX, NOP_VARIANT_INDEX) == (t["panic"], t["nop"])
