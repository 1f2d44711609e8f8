"""The port's profiling helpers (classmate_rag_tpu_torch/utils/
profiling.py): ``Throughput.report()`` on fixed numbers, with the JAX
package's keys and rounding (equal to its report where both tables hold
the chip, "cpu"); ``_detect_chip`` on the NVIDIA card names; ``trace``
writing a Chrome trace of a CPU region."""

import json

import pytest
import torch

from classmate_rag_tpu.utils.profiling import Throughput as JThroughput
from classmate_rag_tpu_torch.utils import profiling
from classmate_rag_tpu_torch.utils.profiling import Throughput, _detect_chip


def test_report_on_fixed_numbers():
    r = Throughput(seconds=0.002, bytes_accessed=5.0e9, flops=1.2e12,
                   chip="h100-sxm").report()
    assert r == {
        "chip": "h100-sxm",
        "seconds": 0.002,
        "gb_per_s": 2500.0,
        "hbm_utilization": round(2500.0 / 3350.0, 3),
        "tflop_per_s": 600.0,
        "mfu": round(600.0 / 989.0, 4),
    }
    zero = Throughput(seconds=0.0, bytes_accessed=1.0, chip="h200").report()
    assert zero["gb_per_s"] == 0.0 and zero["tflop_per_s"] == 0.0


@pytest.mark.parametrize("seconds,nbytes,flops", [
    (1.5, 3.0e10, 4.0e12), (0.25, 1.0e9, 0.0), (3.0, 0.0, 7.5e11),
])
def test_report_equals_jax_on_the_cpu_row(seconds, nbytes, flops):
    got = Throughput(seconds, nbytes, flops, chip="cpu").report()
    want = JThroughput(seconds, nbytes, flops, chip="cpu").report()
    assert got == want


@pytest.mark.parametrize("name,key", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 NVL", "h100-nvl"),
    ("NVIDIA H200", "h200"),
    ("NVIDIA A100-SXM4-80GB", "cpu"),
])
def test_detect_chip_by_card_name(name, key):
    assert _detect_chip(name) == key
    peaks = profiling.device_peaks(key)
    assert len(peaks) == 4 and all(p > 0 for p in peaks)


def test_detect_chip_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _detect_chip() == "cpu"
    assert Throughput(1.0, 1e9).report()["chip"] == "cpu"


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum().item()
    files = list((tmp_path / "tr").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
