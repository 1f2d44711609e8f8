"""Lightweight process metrics: counters + latency timers.

The reference has no observability beyond wall-clock bench scripts
(SURVEY §5). This module gives the pipeline QPS/latency/ingest counters
surfaced through ``index_stats`` and the ``stats`` CLI verb. Deliberately
dependency-free and cheap: a dict of counters and bounded latency rings.

Host copy of the JAX package's ``utils/metrics.py`` (no JAX).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, Iterator


class Metrics:
    """Thread-safe counters and latency recorders (bounded memory)."""

    def __init__(self, window: int = 512) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._timings: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._started = time.time()

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt_ms = (time.perf_counter() - t0) * 1000.0
            with self._lock:
                self._timings[name].append(dt_ms)
                self._counters[f"{name}_count"] += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = dict(self._counters)
            for name, ring in self._timings.items():
                if not ring:
                    continue
                vals = sorted(ring)
                out[f"{name}_mean_ms"] = round(sum(vals) / len(vals), 2)
                out[f"{name}_p95_ms"] = round(
                    vals[min(len(vals) - 1, int(0.95 * len(vals)))], 2
                )
            out["uptime_s"] = round(time.time() - self._started, 1)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()
            self._started = time.time()


# Process-global instance used across the pipeline.
metrics = Metrics()
