"""The yardstick's FLOP and byte counts on shapes worked by hand."""

import pytest

from rag_bench import work


def test_peaks_by_card_name():
    assert work.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert work.peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    assert work.peaks("NVIDIA H200") == (989e12, 4.8e12)
    assert work.peaks("cpu") is None


def test_scan_counts():
    # 256 queries x 1,000,000 rows x 768: 2 * 256 * 1e6 * 768 FLOP;
    # 1e6 bf16 rows of 768 (1,536 B) and an f32 bias each.
    assert work.scan_flops(256, 1_000_000, 768) == 393_216_000_000.0
    assert work.scan_bytes(1_000_000, 768) == 1_540_000_000.0
    peak = (989e12, 3.35e12)
    # Bytes bound it: 1.54e9 / 3.35e12 = 459.7 us > 397.6 us of FLOP.
    assert work.scan_least_s(256, 1_000_000, 768, peak) == pytest.approx(
        1.54e9 / 3.35e12)
    assert work.scan_least_s(4096, 1000, 768, peak) == pytest.approx(
        2 * 4096 * 1000 * 768 / 989e12)


def test_batch_counts():
    peak = (989e12, 3.35e12)
    # 3,000,000 posting entries at 5 B, lengths 4 B a row.
    b = 1.54e9 + 5 * 3_000_000 + 4 * 1_000_000
    assert work.batch_least_s(256, 1_000_000, 768, 3_000_000, peak) == \
        pytest.approx(b / 3.35e12)
