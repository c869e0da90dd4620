"""The frozen yardstick's counts against values worked out by hand at small
shapes."""

import pytest
import torch

from eravm_bench import roofline


def test_bound_ms_bytes_and_operations():
    ms, by = roofline.bound_ms(3.35e9, 0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ops_per_ms = 132 * 64 * 1980e6 * 1e-3          # 16,727,040
    ms, by = roofline.bound_ms(0, ops_per_ms)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = roofline.bound_ms(3.35e9, 2 * ops_per_ms)
    assert by == "operations" and ms == pytest.approx(2.0)


def test_changed_bytes_counts_sectors():
    a = torch.zeros(20, dtype=torch.int32)        # 80 bytes: 3 sectors
    b = a.clone()
    assert roofline.changed_bytes(a, b) == 0
    b[0] = 1                                      # sector 0
    b[19] = 1                                     # sector 2 (padded)
    assert roofline.changed_bytes(a, b) == 64


def test_k1_bytes_read_only_written_and_write_only():
    fields = {name: torch.zeros(8, dtype=torch.int32)
              for name in roofline.K1_FIELDS + ("wq_meta", "wq_value",
                                                "wq_flags")}
    after = {k: v.clone() for k, v in fields.items()}
    after["regs"][0] = 5          # read and written: 2 x 32 bytes
    after["wq_meta"][3] = 1       # written only: 32 bytes
    # the four read-only inputs: 32 bytes each, read once
    assert roofline.k1_bytes(fields, after, queue=True, pq=False) \
        == 4 * 32 + 2 * 32 + 32
    # without the queue its rows are not counted
    assert roofline.k1_bytes(fields, after, queue=False, pq=False) \
        == 4 * 32 + 2 * 32


def test_k1_bytes_mode_b_records():
    fields = {name: torch.zeros(8, dtype=torch.int32)
              for name in roofline.K1_FIELDS}
    after = {k: v.clone() for k, v in fields.items()}
    # two lanes, 3 and 5 records: 8 x 52 bytes and the two counts
    records = torch.tensor([3, 5], dtype=torch.int32)
    assert roofline.k1_bytes(fields, after, queue=False, pq=False,
                             records=records) \
        == 4 * 32 + 8 * 52 + 2 * 4


def test_k1_ops():
    assert roofline.k1_ops(10) == 640


def test_k2_bound():
    out = roofline.k2_bound(torch.tensor([0, 1], dtype=torch.int32),
                            torch.tensor([3, 3], dtype=torch.int32))
    # lane 0: records at 0, 1, 2 -> one permutation (after record 1);
    # lane 1: records at 1, 2, 3 -> two (after 1 and 3)
    assert out["permutations"] == 3 and out["records"] == 6
    assert out["bytes"] == 6 * 52 + 2 * 4 + 2 * (2 * 50 * 4 + 2 * 4)
    assert out["bound_by"] == "operations"
