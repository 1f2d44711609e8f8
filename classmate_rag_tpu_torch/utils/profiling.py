"""Profiling helpers: torch.profiler traces and throughput accounting
(port of the JAX package's ``utils/profiling.py``).

``trace(dir)`` wraps ``torch.profiler.profile`` (CPU and, with a card,
CUDA activities) and writes a Chrome trace of any code region (ingest, a
query batch, decode) into ``dir``. ``Throughput`` turns (bytes, flops,
seconds) into GB/s, TFLOP/s, memory-bandwidth share and MFU against the
card's published peaks, the table ``chip_smoke.py`` takes its bounds
from.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import torch

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core TFLOP/s,
# memory GB/s, f32 TFLOP/s outside the tensor cores, int8 tensor-core
# TOPS.
_DEVICE_PEAKS = {
    "h100-sxm": (989.0, 3350.0, 67.0, 1979.0),    # SXM5, 80 GB HBM3
    "h100-pcie": (756.0, 2000.0, 51.0, 1513.0),
    "h100-nvl": (835.0, 3900.0, 60.0, 1671.0),
    "h200": (989.0, 4800.0, 67.0, 1979.0),
    "cpu": (1.0, 50.0, 1.0, 1.0),
}


def _detect_chip(kind: Optional[str] = None) -> str:
    """The peak table's key for a card name (default: CUDA card 0's
    ``torch.cuda.get_device_name``); "cpu" without a card or for a card
    the table does not hold."""
    if kind is None:
        if not torch.cuda.is_available():
            return "cpu"
        kind = torch.cuda.get_device_name(0)
    name = kind.lower()
    if "h200" in name:
        return "h200"
    if "h100" in name:
        # PCIe and NVL before the bare H100 (the SXM5 part, "NVIDIA H100
        # 80GB HBM3").
        for part in ("pcie", "nvl"):
            if part in name:
                return f"h100-{part}"
        return "h100-sxm"
    return "cpu"


def device_peaks(chip: str):
    """(bf16 TFLOP/s, memory GB/s, f32 TFLOP/s, int8 TOPS) of a table
    key."""
    return _DEVICE_PEAKS[chip]


@dataclass
class Throughput:
    seconds: float
    bytes_accessed: float = 0.0
    flops: float = 0.0
    chip: Optional[str] = None

    def report(self) -> dict:
        chip = self.chip or _detect_chip()
        peak_tflops, peak_gbs = _DEVICE_PEAKS.get(
            chip, _DEVICE_PEAKS["cpu"])[:2]
        gbs = self.bytes_accessed / self.seconds / 1e9 if self.seconds else 0.0
        tflops = self.flops / self.seconds / 1e12 if self.seconds else 0.0
        return {
            "chip": chip,
            "seconds": round(self.seconds, 6),
            "gb_per_s": round(gbs, 1),
            "hbm_utilization": round(gbs / peak_gbs, 3) if peak_gbs else None,
            "tflop_per_s": round(tflops, 2),
            "mfu": round(tflops / peak_tflops, 4) if peak_tflops else None,
        }


@contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the region with ``torch.profiler`` (CPU activities, and CUDA
    ones when a card is present) and write a Chrome trace,
    ``trace-<ns>.json``, into ``log_dir``. Yields the profiler, whose
    ``events()`` the caller may read after the region."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"trace-{time.time_ns()}.json"))


__all__ = ["Throughput", "device_peaks", "trace"]
