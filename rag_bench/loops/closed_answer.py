"""Closed loop of the ``answer`` kind: one client sends the pool's batches
of questions in turn through ``DecodeRunner.generate_ids_batch``, each
right after the previous batch's answer ids reached the host. A served
batch's ``out`` is the runner's list of eos-stripped ids a question."""

from __future__ import annotations

import sys
import time
import traceback
from typing import Any, Dict, Sequence

from rag_bench.window import Served, Window


def serve_one(runner, batch, knobs: Dict[str, Any], pool: int) -> Served:
    """One batch; the runner returns once the ids are on the host, so the
    call's return is also its fetch."""
    t0 = time.perf_counter_ns()
    try:
        out = runner.generate_ids_batch(batch.prompts, seed=batch.seed,
                                        **knobs)
        t1 = time.perf_counter_ns()
        return Served(pool, t0, t1, t1, len(batch.prompts), out)
    except Exception as exc:  # a failed batch counts, the loop goes on
        traceback.print_exc(file=sys.stderr)
        t = time.perf_counter_ns()
        return Served(pool, t0, t, t, len(batch.prompts), None,
                      f"{type(exc).__name__}: {exc}")


def drive(runner, batches: Sequence, seconds: float,
          knobs: Dict[str, Any]) -> Window:
    """Serve the pool in turn until ``seconds`` have passed; the batch
    that crosses the end is the last."""
    win = Window()
    end = time.perf_counter_ns() + int(seconds * 1e9)
    i = 0
    while True:
        s = serve_one(runner, batches[i % len(batches)], knobs,
                      i % len(batches))
        win.served.append(s)
        i += 1
        if s.t_fetched >= end:
            return win
