"""The device trace of a ``--trace 1`` window: torch.profiler with CUDA
activities alone, read into plain (name, start_ns, end_ns) records of the
operations that ran on the card, and the reductions the readers share.

The profiler's timestamps are wall-clock nanoseconds (``time.time_ns``'s
clock); the window's host spans are ``perf_counter_ns``, and
``Trace.host_offset_ns`` turns one into the other.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

Op = Tuple[str, int, int]           # (name, start_ns, end_ns)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    ops: List[Op]                   # every device operation, by start
    host_offset_ns: int             # wall-clock ns minus perf_counter_ns

    @property
    def kernels(self) -> List[Op]:
        return [o for o in self.ops if is_kernel(o[0])]


def union_ns(ops: List[Op]) -> int:
    """Nanoseconds in which at least one of ``ops`` ran."""
    busy = 0
    cur_s = cur_e = None
    for _name, s, e in sorted(ops, key=lambda o: o[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(ops: List[Op]) -> List[Tuple[int, int]]:
    """The idle intervals between the first and the last operation."""
    out = []
    cur_e = None
    for _name, s, e in sorted(ops, key=lambda o: o[1]):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def host_offset_ns() -> int:
    a = time.perf_counter_ns()
    w = time.time_ns()
    b = time.perf_counter_ns()
    return w - (a + b) // 2


def device_ops(prof) -> List[Op]:
    """The CUDA-side events of a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s = int(e.start_ns())
        out.append((e.name(), s, s + int(e.duration_ns())))
    out.sort(key=lambda o: o[1])
    return out
