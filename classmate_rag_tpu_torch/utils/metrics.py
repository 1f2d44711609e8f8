"""Lightweight process metrics: counters + latency timers.

The reference has no observability beyond wall-clock bench scripts
(SURVEY §5). This module gives the pipeline QPS/latency/ingest counters
surfaced through ``index_stats`` and the ``stats`` CLI verb. Deliberately
dependency-free and cheap: a dict of counters and bounded latency rings.

Host copy of the JAX package's ``utils/metrics.py`` (no JAX), plus spans:
``span(name, **counts)`` marks a stage of the store call or the fused
step, and ``tracing()`` turns recording on for a block and yields the
list of closed spans (``Span``), read after the block. With tracing off
a span is one attribute test and a shared no-op context: no record, no
allocation of its own, no lock. Span times are ``time.perf_counter_ns``.
``tracing(tallies=d)`` also keeps device-side counters for the block:
``tally(name, shape, device)`` gives the program the block's int64
tensor ``d[name]`` to add into (None while off), read after the block.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Iterator, List, NamedTuple, Optional


class Span(NamedTuple):
    """One closed span of a ``Metrics.tracing()`` block."""
    span_id: int
    parent_id: Optional[int]    # the thread's innermost open span
    batch_id: int               # the span_id of the thread's outermost
    name: str
    t0_ns: int                  # time.perf_counter_ns at open
    t1_ns: int                  # ... at close
    counts: Dict[str, Any]      # counts the work carried (host values)


class _OpenSpan:
    """A span while it is open; ``count(**counts)`` adds to its counts."""

    __slots__ = ("_owner", "_out", "span_id", "parent_id", "batch_id",
                 "name", "t0_ns", "counts")

    def __init__(self, owner: "Metrics", out: List[Span], name: str,
                 counts: Dict[str, Any]) -> None:
        self._owner, self._out, self.name = owner, out, name
        self.counts = counts
        self.span_id = next(owner._span_ids)

    def count(self, **counts: Any) -> None:
        self.counts.update(counts)

    def __enter__(self) -> "_OpenSpan":
        stack = self._owner._open_stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.batch_id = stack[0].span_id if stack else self.span_id
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._owner._open_stack().pop()
        self._out.append(Span(self.span_id, self.parent_id, self.batch_id,
                              self.name, self.t0_ns, t1, self.counts))
        return False


# What ``span`` returns with tracing off: enters as None.
_NO_SPAN = nullcontext()


class Metrics:
    """Thread-safe counters and latency recorders (bounded memory)."""

    def __init__(self, window: int = 512) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._timings: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._started = time.time()
        # Tracing: the list closed spans go to while ``tracing()`` is on
        # (None while off), span ids, each thread's open spans.
        self._spans: Optional[List[Span]] = None
        self._tallies: Optional[Dict[str, Any]] = None
        self._span_ids = itertools.count(1)
        self._open = threading.local()

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Time the block into ``name``'s ring (and, while tracing is on,
        record it as a span too)."""
        with self.span(name):
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                dt_ms = (time.perf_counter_ns() - t0) / 1e6
                with self._lock:
                    self._timings[name].append(dt_ms)
                    self._counters[f"{name}_count"] += 1

    def span(self, name: str, **counts: Any):
        """A context that records one ``Span`` while tracing is on and
        enters as the open span (``.count(**more)`` adds counts); with
        tracing off, a shared no-op context that enters as None. A span
        opened with none open on its thread is a batch's root: the spans
        inside it carry its span_id as their batch_id."""
        out = self._spans
        if out is None:
            return _NO_SPAN
        return _OpenSpan(self, out, name, counts)

    def _open_stack(self) -> List[_OpenSpan]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def tally(self, name: str, shape, device):
        """While a ``tracing(tallies=d)`` block is on, ``d[name]``: a
        zeroed int64 tensor of ``shape`` on ``device`` at its first use,
        which the caller adds its counts into on the device (no read
        back); None otherwise."""
        tallies = self._tallies
        if tallies is None:
            return None
        t = tallies.get(name)
        if t is None:
            import torch

            t = tallies[name] = torch.zeros(shape, dtype=torch.int64,
                                            device=device)
        return t

    @contextmanager
    def tracing(self, tallies: Optional[Dict[str, Any]] = None
                ) -> Iterator[List[Span]]:
        """Record spans for the block; yields the list they close into.
        With ``tallies`` (a dict), device counters (``tally``) go into it
        too. Not reentrant: one recording at a time."""
        if self._spans is not None:
            raise RuntimeError("tracing is already on")
        spans: List[Span] = []
        self._spans = spans
        self._tallies = tallies
        try:
            yield spans
        finally:
            self._spans = None
            self._tallies = None

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
