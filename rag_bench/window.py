"""The measured window, the same for every kind: what a kind's loop
records and the only fields the generic readers (``query_qps``,
``setup_s``, ``batch_latency_p95_ms``, ``store_call_ms``,
``fetch_wait_ms``, ``step_device_ms``, ``kernels_per_batch``,
``device_idle_pct``) and ``run.breakdown`` read.

One ``Served`` a call into the program: a batch of ``queries`` (for a
model kind, the questions answered), timed from the call (``t_call``) to
its return (``t_return``) to its results on the host (``t_fetched``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class Served:
    pool: int                 # index of the batch in the pool
    t_call: int               # perf_counter_ns at the call into the program
    t_return: int             # ... when the call returned
    t_fetched: int            # ... when the results were on the host
    queries: int
    out: Optional[Any]        # the kind's results on the host; None: failed
    error: Optional[str] = None


@dataclass
class Window:
    served: List[Served] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        if not self.served:
            return 0.0
        return (self.served[-1].t_fetched - self.served[0].t_call) / 1e9

    @property
    def attempted(self) -> int:
        return sum(s.queries for s in self.served)

    @property
    def failed(self) -> int:
        return sum(s.queries for s in self.served if s.out is None)
