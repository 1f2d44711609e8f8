"""How ``correct`` is decided: a sample, drawn from the seed, of the
queries the window answered, held against the plain reference
(``reference/hybrid.py``) after the program's state is freed.

Three numbers are compared, each with its limit (``limits/<cell>.json``):

- ``slot_miss_share``: the share of answer slots (every repetition of a
  sampled query, ``top_k`` slots each) whose row or fused score is not
  the reference's at that rank. It judges the ranking end to end: the
  dense pool, MMR, BM25's top rows under the filter's statistics, RRF.
- ``vec_dist_gap``: the widest gap between a returned row's vector
  distance and the reference's exact one for that query and row.
- ``bm25_rel_gap``: the widest gap between a returned row's BM25 score
  and the reference's exact Okapi score for that query and row, over
  the larger of that score and 1.

A row outside the query's filter has no reference score: its gaps are
infinite.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from rag_bench.corpus import _SAMPLE, stream_rng
from rag_bench.reference.hybrid import Answer, Query, Reference

NAMES = ("slot_miss_share", "vec_dist_gap", "bm25_rel_gap")


def sample(window, batches, n: int, seed: int) -> List[Tuple[int, int]]:
    """``n`` (pool batch, position) pairs among the queries the window
    answered, drawn from the seed, with the query of the most words
    among them."""
    pools = sorted({s.pool for s in window.served if s.out is not None})
    pairs = [(p, j) for p in pools for j in range(len(batches[p].terms))]
    if not pairs:
        return []
    rng = stream_rng(seed, _SAMPLE)
    pick = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False)
    out = [pairs[i] for i in sorted(pick.tolist())]
    longest = max(pairs, key=lambda pj: len(batches[pj[0]].term_ids[pj[1]]))
    if longest not in out:
        out[-1] = longest
    return out


def served_answers(window, picks) -> Dict[Tuple[int, int], List[Answer]]:
    """Every repetition the window served of each picked query."""
    want: Dict[int, List[int]] = {}
    for p, j in picks:
        want.setdefault(p, []).append(j)
    got: Dict[Tuple[int, int], List[Answer]] = {pj: [] for pj in picks}
    for s in window.served:
        if s.out is None or s.pool not in want:
            continue
        rows, fused, vdist, bm25 = s.out
        for j in want[s.pool]:
            got[(s.pool, j)].append(Answer(rows[j].astype(np.int64),
                                           fused[j], vdist[j], bm25[j]))
    return got


def queries_of(batches, picks) -> List[Query]:
    return [Query(batches[p].q_vecs[j], batches[p].term_ids[j],
                  batches[p].course) for p, j in picks]


def readings(ref: Reference, queries: List[Query], want: List[Answer],
             got: List[List[Answer]]) -> Dict[str, float]:
    """The three numbers for the answers ``got`` (a list of repetitions
    per query) against the reference's ``want``."""
    slots = misses = 0
    vec_gap = bm_gap = 0.0
    for q, w, reps in zip(queries, want, got):
        for a in reps:
            k = len(w.rows)
            slots += k
            same = (a.rows[:k] == w.rows) & (
                np.abs(np.asarray(a.fused[:k], np.float64) - w.fused)
                <= 1e-6)
            same |= (a.rows[:k] < 0) & (w.rows < 0)
            misses += int(k - same.sum())
            dv = ~np.isnan(a.vec_dist)
            if dv.any():
                exact = ref.cos_dist(q, a.rows[dv])
                gap = np.abs(a.vec_dist[dv] - exact)
                gap = np.where(np.isnan(exact), math.inf, gap)
                vec_gap = max(vec_gap, float(np.max(gap)))
            db = ~np.isnan(a.bm25)
            if db.any():
                exact = ref.bm25_of(q, a.rows[db])
                gap = np.abs(a.bm25[db] - exact) / np.maximum(
                    np.abs(exact), 1.0)
                gap = np.where(np.isnan(exact), math.inf, gap)
                bm_gap = max(bm_gap, float(np.max(gap)))
    return {
        "slot_miss_share": misses / slots if slots else math.inf,
        "vec_dist_gap": vec_gap,
        "bm25_rel_gap": bm_gap,
    }


def verdict(values: Dict[str, float], limits: Dict[str, float],
            failed: int) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    checks = {n: {"value": values[n], "limit": float(limits[n])}
              for n in NAMES}
    ok = failed == 0 and all(c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, checks
