"""Closed loop: one client sends the pool's batches in turn, each right
after the previous one's rows and scores reached the host. A served
batch's ``out`` is (rows, fused, vec_dist, bm25) in numpy."""

from __future__ import annotations

import sys
import time
import traceback
from typing import Any, Dict, Sequence

from rag_bench.window import Served, Window


def serve_one(store, batch, knobs: Dict[str, Any], pool: int) -> Served:
    """One batch through ``IndexStore.hybrid_topk_batch``, ended by the
    host fetch of its four result tensors (what the retriever reads)."""
    t0 = time.perf_counter_ns()
    try:
        res = store.hybrid_topk_batch(batch.q_vecs, batch.terms, batch.where,
                                      **knobs)
        t1 = time.perf_counter_ns()
        out = tuple(t.cpu().numpy() for t in res)
        t2 = time.perf_counter_ns()
        return Served(pool, t0, t1, t2, len(batch.terms), out)
    except Exception as exc:  # a failed batch counts, the loop goes on
        traceback.print_exc(file=sys.stderr)
        t = time.perf_counter_ns()
        return Served(pool, t0, t, t, len(batch.terms), None,
                      f"{type(exc).__name__}: {exc}")


def drive(store, batches: Sequence, seconds: float,
          knobs: Dict[str, Any]) -> Window:
    """Serve the pool in turn until ``seconds`` have passed; the batch
    that crosses the end is the last."""
    win = Window()
    end = time.perf_counter_ns() + int(seconds * 1e9)
    i = 0
    while True:
        s = serve_one(store, batches[i % len(batches)], knobs,
                      i % len(batches))
        win.served.append(s)
        i += 1
        if s.t_fetched >= end:
            return win
