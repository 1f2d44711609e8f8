"""Profiling helpers: torch.profiler traces and throughput accounting
(port of the JAX package's ``utils/profiling.py``).

``trace(dir)`` wraps ``torch.profiler.profile`` (CPU and, with a card,
CUDA activities) and writes a Chrome trace of any code region (ingest, a
query batch, decode) into ``dir``. ``Throughput`` turns (bytes, flops,
seconds) into GB/s, TFLOP/s, memory-bandwidth share and MFU against the
card's published peaks, the table ``chip_smoke.py`` takes its bounds
from. ``chrome_events(call)`` returns one call's trace events, and
``h2d_copies(events)`` counts the host-to-device copies among them;
``HostToDeviceOps`` counts the torch ops that make such copies, without
the profiler.
"""

from __future__ import annotations

import json
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


def chrome_events(call: Callable[[], Any]) -> List[dict]:
    """The Chrome-trace events (``traceEvents``) of one ``call()`` under
    torch.profiler: CPU activities, and CUDA ones when a card is present
    (a synchronize then ends the session)."""
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            call()
        (path,) = Path(d).glob("trace-*.json")
        with open(path) as f:
            return json.load(f)["traceEvents"]


def h2d_copies(events: List[dict]) -> Dict[str, Any]:
    """The host-to-device copies among Chrome-trace ``events``: the
    device's ``Memcpy HtoD (<source> -> Device)`` events. Returns
    {"copies", "bytes" (None where an event carries no byte count),
    "kinds": {event name: count}}."""
    kinds: Dict[str, int] = {}
    n_bytes: Optional[int] = 0
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or not name.startswith("Memcpy HtoD"):
            continue
        kinds[name] = kinds.get(name, 0) + 1
        b = e.get("args", {}).get("bytes")
        n_bytes = None if b is None or n_bytes is None else n_bytes + int(b)
    return {"copies": sum(kinds.values()), "bytes": n_bytes, "kinds": kinds}


def held_stream_ms(call: Callable[[], Any], iters: int,
                   device: Any) -> Dict[str, Any]:
    """The device time of one ``call()`` on ``device``, with the host out
    of the card's way.

    One call warms up. On CUDA, before each of ``iters`` calls a spin
    kernel (``torch.cuda._sleep``, four times the host's time to queue a
    call) holds the stream while the host queues the call between two
    CUDA events, so the card runs the call's kernels back to back; a
    synchronize ends the timing. Eager PyTorch runs every call it is
    given, so nothing needs perturbing from call to call (the JAX package
    threads a carry through a ``lax.scan`` so that XLA cannot hoist work
    out of its loop). A call that waited for the host releases the spin
    before it is queued: the loop stops there, ``held`` is False, and
    ``profiler_ms`` gives the device time torch.profiler traces over
    ``iters`` calls. Returns {"ms": mean CUDA-event span a call (with
    the host's wait in it where ``held`` is False), "held", "timing":
    "held stream" | "profiler" | "wall", and "profiler_ms" where not
    held}. On the CPU: wall time a call, timing "wall", held False."""
    dev = torch.device(device)
    call()                                               # warm-up
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return {"ms": (time.perf_counter() - t0) * 1e3 / iters,
                "held": False, "timing": "wall"}
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        queue_s = time.perf_counter() - t0        # the host's time a call
        torch.cuda.synchronize()
        spans, held = [], True
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(4 * queue_s * 2e9))    # cycles, <= 2 GHz
            start.record()
            call()
            end.record()
            spans.append((start, end))
            held = not start.query()        # the card not at the call yet
            if not held:
                break
        torch.cuda.synchronize()
        out = {"ms": sum(a.elapsed_time(b) for a, b in spans) / len(spans),
               "held": held,
               "timing": "held stream" if held else "profiler"}
        if held:
            return out
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        busy_us = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        )
        out["profiler_ms"] = busy_us / 1e3 / iters
        return out


class HostToDeviceOps(TorchDispatchMode):
    """While on (``with HostToDeviceOps() as ops:``), counts the torch ops
    that copy a CPU tensor to another device (``_to_copy`` and ``copy_``):
    ``copies`` and ``bytes`` (the CPU tensors' sizes). It reads the
    dispatcher, not the device: a copy made below it (a tensor built
    from a Python list straight on the device, a library's own
    ``cudaMemcpy``) is not counted, which a trace's ``h2d_copies`` would
    show. Unlike a trace it loses nothing as the process ages."""

    def __init__(self):
        super().__init__()
        self.copies = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._to_copy.default:
            src, dst = args[0], out
        elif func is torch.ops.aten.copy_.default:
            dst, src = args[0], args[1]
        else:
            return out
        if (isinstance(src, torch.Tensor) and src.device.type == "cpu"
                and dst.device.type != "cpu"):
            self.copies += 1
            self.bytes += src.numel() * src.element_size()
        return out


__all__ = ["HostToDeviceOps", "Throughput", "chrome_events", "device_peaks",
           "h2d_copies", "held_stream_ms", "trace"]
