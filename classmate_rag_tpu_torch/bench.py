"""Headline benchmark of the port: hybrid-query throughput on the card
against a CPU oracle (the port's counterpart of the repository's root
``bench.py``, with its own copy of that file's corpus, oracle and
stages).

    python -m classmate_rag_tpu_torch.bench                # on CUDA
    python -m classmate_rag_tpu_torch.bench --device cpu   # plain path

Prints ONE JSON line, the root file's keys plus ``card``:
  {"metric": "hybrid_query_qps", "value": <qps>, "unit": "queries/s",
   "vs_baseline": <qps / CPU oracle qps>, ..., "backend": "cuda",
   "card": "<nvidia-smi name, power limit>", "scale2": {...},
   "scale3": {...}, "product": {...}}

Setup: a synthetic corpus (seed 42, zipf word soup over 5,000 words,
unit random 768-d embeddings) indexed by the real IndexStore. The store
and the oracle answer the same hybrid queries (dense top pool + MMR +
BM25 + RRF, k 8/8, rrf_k 60, pool 24). The oracle is numpy: an exact
cosine scan, rank_bm25-style Okapi with corpus statistics precomputed
once, the exact RRF formula and greedy MMR.

Timing: 4 workers call ``hybrid_topk_batch`` concurrently and a host
fetch of ``rows`` ends each batch; the best of ``BENCH_PASSES`` passes,
each at least ``BENCH_MIN_PASS_S`` long. ``device_ceiling_qps`` is the
batch over ``IndexStore.device_seconds_per_batch``: the card's time for
one batch with the host out of its way.

Stages: the primary scale (``BENCH_CHUNKS``, with the metadata-filter
cases), ``scale2`` (``BENCH_SCALE2``), and on CUDA ``scale3``
(``BENCH_SCALE3``, filter cases too) and ``product`` (the end-to-end
product path at ``BENCH_PRODUCT_CHUNKS``, in fresh child processes). A
stage that raises is written into the line as ``{"error": ...}`` and the
process exits 1. Without ``--device cpu`` everything runs on CUDA, and
without a card the run fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device

N_CHUNKS = int(os.getenv("BENCH_CHUNKS", "50000"))
# Second corpus scale recorded in the same JSON line (0 disables).
SCALE2_CHUNKS = int(os.getenv("BENCH_SCALE2", "200000"))
# Third, serving-scale corpus (CUDA only; 0 disables): the scale where
# the store takes the approx route on its own (IndexStore.APPROX_MIN_ROWS).
SCALE3_CHUNKS = int(os.getenv("BENCH_SCALE3", "1000000"))
DIM = 768
N_QUERIES = int(os.getenv("BENCH_QUERIES", "1024"))
BATCH = int(os.getenv("BENCH_BATCH", "256"))
N_ORACLE = int(os.getenv("BENCH_ORACLE", "128"))
# Minimum seconds of wall time a timed pass holds.
MIN_PASS_S = float(os.getenv("BENCH_MIN_PASS_S", "2.0"))
K = 8
POOL = 24
RRF_K = 60
_REPO = Path(__file__).resolve().parents[1]


def build_corpus(rng, n_chunks: int = None):
    """Zipf-ish synthetic docs (a realistic df spectrum for BM25) and
    unit-norm embeddings; the root file's draws, in its order."""
    n_chunks = n_chunks or N_CHUNKS
    vocab = [f"w{i}" for i in range(5000)]
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    weights /= weights.sum()
    # One vectorized draw for all docs, sliced to per-doc lengths.
    lengths = rng.integers(40, 120, size=n_chunks)
    all_idx = rng.choice(len(vocab), size=int(lengths.sum()), p=weights)
    flat = [vocab[i] for i in all_idx.tolist()]
    ends = np.cumsum(lengths).tolist()
    docs = [flat[s:e] for s, e in zip([0] + ends[:-1], ends)]
    del flat
    emb = rng.standard_normal((n_chunks, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return docs, emb


def make_queries(rng, docs, emb):
    qs = []
    n_chunks = len(docs)
    for _ in range(N_QUERIES):
        doc_i = int(rng.integers(0, n_chunks))
        qv = emb[doc_i] + 0.25 * rng.standard_normal(DIM).astype(np.float32)
        qv /= np.linalg.norm(qv)
        terms = list(rng.choice(docs[doc_i], size=min(5, len(docs[doc_i])),
                                replace=False))
        qs.append((qv.astype(np.float32), terms))
    return qs


# ---------------------------------------------------------------------------
# CPU oracle (reference-style)
# ---------------------------------------------------------------------------

class OracleBM25:
    """rank_bm25-style scoring with precomputed corpus statistics."""

    K1, B, EPS = 1.5, 0.75, 0.25

    def __init__(self, corpus_tokens):
        self.doc_freqs = []
        self.doc_len = np.array([len(d) for d in corpus_tokens], np.float32)
        self.avgdl = float(self.doc_len.mean())
        df = {}
        for doc in corpus_tokens:
            freqs = {}
            for t in doc:
                freqs[t] = freqs.get(t, 0) + 1
            self.doc_freqs.append(freqs)
            for t in freqs:
                df[t] = df.get(t, 0) + 1
        n = len(corpus_tokens)
        self.idf = {}
        neg, s = [], 0.0
        for t, f in df.items():
            v = math.log(n - f + 0.5) - math.log(f + 0.5)
            self.idf[t] = v
            s += v
            if v < 0:
                neg.append(t)
        avg = s / len(self.idf)
        for t in neg:
            self.idf[t] = self.EPS * avg

    def get_scores(self, query):
        score = np.zeros(len(self.doc_freqs), np.float32)
        denom_base = self.K1 * (1 - self.B + self.B * self.doc_len / self.avgdl)
        for q in query:
            q_freq = np.array(
                [doc.get(q, 0) for doc in self.doc_freqs], np.float32
            )
            score += (self.idf.get(q) or 0.0) * (
                q_freq * (self.K1 + 1) / (q_freq + denom_base)
            )
        return score


class FastOracleBM25:
    """The same Okapi math as :class:`OracleBM25` (the same idf/ε rule),
    vectorized over CSR postings so the oracle stays runnable at 1M
    chunks. The postings are built with numpy, not a loop over the
    tokens; the state is the root file's, array for array (terms
    numbered in order of first appearance, each term's rows ascending),
    so the scores are too."""

    K1, B, EPS = 1.5, 0.75, 0.25

    def __init__(self, corpus_tokens):
        self.n_docs = len(corpus_tokens)
        self.doc_len = np.array([len(d) for d in corpus_tokens], np.float32)
        self.avgdl = float(self.doc_len.mean())
        flat = [t for doc in corpus_tokens for t in doc]
        vocab = {t: i for i, t in enumerate(dict.fromkeys(flat))}
        n_terms = len(vocab)
        tok = np.fromiter(map(vocab.__getitem__, flat), np.int64,
                          count=len(flat))
        del flat
        doc_of = np.repeat(np.arange(self.n_docs, dtype=np.int64),
                           self.doc_len.astype(np.int64))
        # One entry a (doc, term) pair, in (doc, term) order.
        pairs, tfs = np.unique(doc_of * n_terms + tok, return_counts=True)
        del tok, doc_of
        rows, tids = np.divmod(pairs, max(n_terms, 1))
        self.vocab = vocab
        order = np.argsort(tids, kind="stable")
        self.post_rows = rows[order]
        self.post_tfs = tfs[order].astype(np.float32)
        df = np.bincount(tids, minlength=n_terms).astype(np.float64)
        self.offsets = np.zeros(n_terms + 1, np.int64)
        np.cumsum(df.astype(np.int64), out=self.offsets[1:])
        idf = np.log(self.n_docs - df + 0.5) - np.log(df + 0.5)
        avg = idf.mean() if len(idf) else 0.0
        idf[idf < 0] = self.EPS * avg
        self.idf = idf.astype(np.float32)
        self._denom = self.K1 * (
            1 - self.B + self.B * self.doc_len / self.avgdl
        )

    def get_scores(self, query):
        score = np.zeros(self.n_docs, np.float32)
        for q in query:
            tid = self.vocab.get(q)
            if tid is None:
                continue
            s, e = self.offsets[tid], self.offsets[tid + 1]
            r = self.post_rows[s:e]
            f = self.post_tfs[s:e]
            score[r] += self.idf[tid] * (
                f * (self.K1 + 1) / (f + self._denom[r])
            )
        return score


def oracle_mmr(qv, cand_vecs, k, lam=0.5):
    sims_q = cand_vecs @ qv
    sims_cc = cand_vecs @ cand_vecs.T
    selected = [int(np.argmax(sims_q))]
    remaining = set(range(len(cand_vecs))) - set(selected)
    while remaining and len(selected) < k:
        best, best_s = None, -1e18
        for i in remaining:
            div = sims_cc[i, selected].max()
            s = lam * sims_q[i] - (1 - lam) * div
            if s > best_s:
                best, best_s = i, s
        selected.append(best)
        remaining.discard(best)
    return selected


def oracle_query(qv, terms, emb, bm25, k=K, sims=None):
    if sims is None:
        sims = emb @ qv
    pool_idx = np.argpartition(-sims, POOL)[:POOL]
    pool_idx = pool_idx[np.argsort(-sims[pool_idx], kind="stable")]
    order = oracle_mmr(qv, emb[pool_idx], k)
    vec_ids = [int(pool_idx[i]) for i in order]
    bscores = bm25.get_scores(terms)
    bm_ids = np.argsort(-bscores, kind="stable")[:k].tolist()
    fused = {}
    for rank, i in enumerate(vec_ids):
        fused[i] = fused.get(i, 0.0) + 1.0 / (RRF_K + rank + 1)
    for rank, i in enumerate(bm_ids):
        fused[i] = fused.get(i, 0.0) + 1.0 / (RRF_K + rank + 1)
    # Tie-break: (fused, -vector_distance) desc, items the dense branch
    # did not return at distance 0, then row id asc on exact ties (the
    # store's own last key, ops/fusion.py rrf_merge).
    vec_set = set(vec_ids)
    ranked = sorted(
        fused.items(),
        key=lambda kv: (
            kv[1],
            -(1.0 - sims[kv[0]]) if kv[0] in vec_set else 0.0,
            -kv[0],
        ),
        reverse=True,
    )
    return [i for i, _ in ranked[:k]]


def oracle_query_masked(qv, terms, emb, sub_bm25, rows_sub, k=K):
    """Subset-relative oracle: dense cosine + Okapi (df/avgdl over the
    SUBSET, the reference's rebuild-on-filter semantics) + RRF + MMR, all
    confined to the filtered rows; returns GLOBAL row ids."""
    s = len(rows_sub)
    if s == 0:
        return []
    emb_sub = emb[rows_sub]
    sims_sub = emb_sub @ qv
    pool = min(POOL, s)
    if s > pool:
        pool_idx = np.argpartition(-sims_sub, pool - 1)[:pool]
    else:
        pool_idx = np.arange(s)
    pool_idx = pool_idx[np.argsort(-sims_sub[pool_idx], kind="stable")]
    order = oracle_mmr(qv, emb_sub[pool_idx], k)
    vec_sub = [int(pool_idx[i]) for i in order]
    bscores = sub_bm25.get_scores(terms)
    bm_sub = np.argsort(-bscores, kind="stable")[: min(k, s)].tolist()
    fused = {}
    for rank, i in enumerate(vec_sub):
        g = int(rows_sub[i])
        fused[g] = fused.get(g, 0.0) + 1.0 / (RRF_K + rank + 1)
    for rank, i in enumerate(bm_sub):
        g = int(rows_sub[i])
        fused[g] = fused.get(g, 0.0) + 1.0 / (RRF_K + rank + 1)
    vec_set = {int(rows_sub[i]) for i in vec_sub}
    sim_of = {int(rows_sub[i]): float(sims_sub[i]) for i in vec_sub}
    ranked = sorted(
        fused.items(),
        key=lambda kv: (
            kv[1],
            -(1.0 - sim_of[kv[0]]) if kv[0] in vec_set else 0.0,
            -kv[0],
        ),
        reverse=True,
    )
    return [i for i, _ in ranked[:k]]


# Filter cases for the filtered-recall oracle: the store's `where` dict +
# the arithmetic subset predicate mirroring _bench_meta. None predicate =
# the filter must yield an EMPTY result set. Sentinels (language=auto,
# doc_type=other) must not narrow; an unknown tag is unsatisfiable.
_FILTER_CASES = [
    ("course", {"course": "c3"}, lambda i: i % 7 == 3),
    ("language", {"language": "it"}, lambda i: i % 2 == 1),
    ("course+lang", {"course": "c1", "language": "en"},
     lambda i: (i % 7 == 1) & (i % 2 == 0)),
    ("tag", {"tags": "tag2"}, lambda i: (i % 3 != 0) & (i % 5 == 2)),
    ("sentinels", {"language": "auto", "doc_type": "other"},
     lambda i: np.ones(len(np.atleast_1d(i)), bool)),
    ("unknown-course", {"course": "no-such-course"}, None),
    ("unsatisfiable-tag", {"tags": "tag1,no-such-tag"}, None),
]


def run_filtered_checks(store, docs, emb, queries, n_queries: int,
                        corpus_bm25=None) -> dict:
    """recall@8 of the store's FILTERED hybrid path against the
    subset-relative oracle, per filter case; a row outside the subset
    scores the query 0. ``corpus_bm25``, the whole corpus's oracle,
    serves a case whose subset is the whole corpus (the same oracle a
    build would give: at 1M rows the build is half a minute)."""
    n = len(docs)
    out = {}
    for name, where, pred in _FILTER_CASES:
        q_slice = queries[:n_queries]
        q_vecs = np.stack([q for (q, _t) in q_slice])
        q_terms = [t for (_q, t) in q_slice]
        res = store.hybrid_topk_batch(
            q_vecs, q_terms, where, k_vector=K, k_bm25=K, top_k=K,
            pool=POOL,
        )
        got_rows = res.rows.cpu().numpy()
        if pred is None:
            # Empty/unsatisfiable subset: every slot must be dead.
            out[name] = {
                "recall@8": 1.0 if bool((got_rows < 0).all()) else 0.0,
                "subset_rows": 0,
            }
            continue
        rows_sub = np.nonzero(pred(np.arange(n)))[0]
        if corpus_bm25 is not None and len(rows_sub) == n:
            sub_bm25 = corpus_bm25
        else:
            sub_docs = [docs[i] for i in rows_sub]
            bm25_cls = (FastOracleBM25 if len(sub_docs) > 100_000
                        else OracleBM25)
            sub_bm25 = bm25_cls(sub_docs)
        overlaps = []
        for j, (qv, terms) in enumerate(q_slice):
            want = set(oracle_query_masked(
                qv, terms, emb, sub_bm25, rows_sub
            ))
            got = {int(r) for r in got_rows[j] if r >= 0}
            overlaps.append(len(got & want) / max(len(want), 1))
            if got - set(rows_sub.tolist()):
                # A row OUTSIDE the filter leaked through the mask.
                overlaps[-1] = 0.0
        out[name] = {
            "recall@8": round(float(np.mean(overlaps)), 4),
            "subset_rows": int(len(rows_sub)),
            "n_queries": len(q_slice),
        }
    return out


# ---------------------------------------------------------------------------

def _bench_meta(i: int) -> dict:
    """Deterministic metadata mix for the filtered-recall oracle:
    7 courses, 2 languages, a 5-way tag cycle with a tagless stratum."""
    meta = {
        "course": f"c{i % 7}",
        "language": "it" if i % 2 else "en",
        "doc_type": "txt",
    }
    if i % 3 != 0:
        meta[f"tag_tag{i % 5}"] = True
    return meta


def _launches() -> dict:
    from classmate_rag_tpu_torch.ops import bm25_core, topk

    return {**topk.LAUNCHES, **bm25_core.LAUNCHES}


def run_scale(n_chunks: int, n_oracle: int, *,
              filtered_oracle: bool = False, device: DeviceLike = None,
              detail: Optional[dict] = None) -> dict:
    """Build a fresh index of ``n_chunks`` on ``device`` (None: CUDA) and
    measure its QPS, the CPU oracle's QPS and recall@8 over ``n_oracle``
    queries. ``detail``, when given, is filled with what the line leaves
    out: the store's route and capacity, the seconds of each part, and
    the scan launches and batches of the timed passes."""
    from concurrent.futures import ThreadPoolExecutor

    from classmate_rag_tpu_torch.index.store import IndexStore

    detail = {} if detail is None else detail
    secs = detail.setdefault("seconds", {})
    # There are only N_QUERIES queries to score.
    n_oracle = min(n_oracle, N_QUERIES)
    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    docs, emb = build_corpus(rng, n_chunks)
    queries = make_queries(rng, docs, emb)
    secs["corpus"] = time.perf_counter() - t0

    # ---- build the index ---------------------------------------------
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="bench_idx_")
    store = IndexStore(
        DIM, tmp.name, slab_rows=4096, terms_per_chunk=128,
        # The product knobs, so DENSE_RESCORE/_POOL/DENSE_SELECT sweeps
        # drive the bench like a deployed runtime.
        rescore=os.getenv("DENSE_RESCORE", "auto"),
        rescore_pool=int(os.getenv("DENSE_RESCORE_POOL", "32")),
        select=os.getenv("DENSE_SELECT", "auto"),
        device=device,
    )
    ids = [f"c{i}" for i in range(n_chunks)]
    batch = 8192
    for s in range(0, n_chunks, batch):
        e = min(s + batch, n_chunks)
        store.upsert(
            ids[s:e], emb[s:e], docs[s:e],
            [_bench_meta(i) for i in range(s, e)],
        )
    secs["upsert"] = time.perf_counter() - t0
    detail.update(select=store.select, select_mode=store.select_mode,
                  capacity=store.capacity, device=str(store.device))

    def run_batch(q_slice):
        q_vecs = np.stack([q for (q, _t) in q_slice])
        q_terms = [t for (_q, t) in q_slice]
        out = store.hybrid_topk_batch(
            q_vecs, q_terms, None, k_vector=K, k_bm25=K, top_k=K, pool=POOL,
        )
        return out.rows.cpu().numpy()  # host fetch ends the batch

    # The first batch places the store (uploads, split layout); the
    # second is timed for the repeat count.
    t0 = time.perf_counter()
    run_batch(queries[:BATCH])
    secs["first_batch"] = time.perf_counter() - t0
    detail["device_bytes"] = {
        name: t.numel() * t.element_size()
        for name, t in {**store._sync_device(), **store._sync_split()}.items()
        if isinstance(t, torch.Tensor)
    }
    t0 = time.perf_counter()
    run_batch(queries[:BATCH])
    t_one_batch = time.perf_counter() - t0
    batch_starts = list(range(0, N_QUERIES, BATCH))
    # Each timed pass holds >= MIN_PASS_S of wall time; BENCH_WORKERS
    # concurrent workers overlap their batches, so size the repeat count
    # for the concurrent wall, not the serial per-batch time.
    workers = int(os.getenv("BENCH_WORKERS", "4"))
    pass_wall_est = t_one_batch * len(batch_starts) / max(workers, 1)
    repeats = max(
        1, int(math.ceil(MIN_PASS_S / max(pass_wall_est, 1e-3)))
    )

    def timed_pass():
        """Throughput with concurrent batch dispatch (a small thread pool,
        as the server's handler threads produce): host prep of batch i+1
        overlaps batch i on the card. Every result is fetched to the
        host."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as ex:
            futures = [
                ex.submit(run_batch, queries[s: s + BATCH])
                for _ in range(repeats)
                for s in batch_starts
            ]
            results = [f.result() for f in futures]
        return results[: len(batch_starts)], time.perf_counter() - t0

    # Best of several passes on top of the MIN_PASS_S floor.
    n_passes = int(os.getenv("BENCH_PASSES", "4"))
    before = _launches()
    t0 = time.perf_counter()
    results, best = timed_pass()
    for _ in range(max(n_passes - 1, 0)):
        _, t = timed_pass()
        best = min(best, t)
    secs["timed_passes"] = time.perf_counter() - t0
    after = _launches()
    detail["timed_launches"] = {k: after[k] - before[k] for k in after}
    detail["timed_batches"] = max(n_passes, 1) * repeats * len(batch_starts)
    qps = repeats * N_QUERIES / best

    # Device-limited ceiling: the card's time for one batch with the host
    # out of its way. Wall well under it: the host bounded the wall.
    t0 = time.perf_counter()
    dev_s = store.device_seconds_per_batch(
        np.stack([q for (q, _t) in queries[:BATCH]]),
        [t for (_q, t) in queries[:BATCH]],
        iters=max(4, int(math.ceil(MIN_PASS_S / max(t_one_batch, 1e-3)))),
        k_vector=K, k_bm25=K, top_k=K, pool=POOL,
    )
    secs["device_probe"] = time.perf_counter() - t0
    detail["device_timing"] = store.device_timing
    print(f"bench: {n_chunks} chunks: device ceiling from the "
          f"{store.device_timing} timing", file=sys.stderr, flush=True)
    qps_device_ceiling = BATCH / dev_s

    # ---- CPU oracle --------------------------------------------------
    # Timed per query, as the reference serves them. The sparse
    # FastOracle keeps large oracles tractable; at small scale the
    # dict-per-doc OracleBM25 (rank_bm25's shape) is used.
    t0 = time.perf_counter()
    bm25 = (FastOracleBM25 if n_chunks > 100_000 else OracleBM25)(docs)
    n_timed = min(n_oracle, 16 if n_chunks > 100_000 else n_oracle)
    t1 = time.perf_counter()
    oracle_results = [
        oracle_query(q, t, emb, bm25) for (q, t) in queries[:n_timed]
    ]
    oracle_time = time.perf_counter() - t1
    qps_cpu = n_timed / oracle_time
    if n_timed < n_oracle:
        # Recall needs more oracle answers than the timing loop ran; the
        # dense scan batches across the remaining queries (same results).
        rest = queries[n_timed:n_oracle]
        sims_all = emb @ np.stack([q for (q, _t) in rest]).T  # [N, R]
        oracle_results += [
            oracle_query(q, t, emb, bm25, sims=sims_all[:, j])
            for j, (q, t) in enumerate(rest)
        ]
    secs["oracle"] = time.perf_counter() - t0

    # ---- recall: the store's top-k vs the oracle's --------------------
    overlaps = []
    flat = np.concatenate(results, axis=0)
    for i in range(n_oracle):
        got = {int(r) for r in flat[i] if r >= 0}
        want = set(oracle_results[i])
        overlaps.append(len(got & want) / max(len(want), 1))
    recall = float(np.mean(overlaps))

    out = {
        "value": round(qps, 2),
        "vs_baseline": round(qps / qps_cpu, 2),
        "baseline_qps": round(qps_cpu, 3),
        "device_ceiling_qps": round(qps_device_ceiling, 2),
        "recall_vs_oracle@8": round(recall, 4),
        "n_oracle_queries": n_oracle,
        "corpus_chunks": n_chunks,
        "rescore": store.rescore_enabled,
        "timed_pass_s": round(best, 3),
    }
    if filtered_oracle:
        t0 = time.perf_counter()
        n_fq = int(os.getenv(
            "BENCH_FILTERED_QUERIES",
            "16" if n_chunks > 100_000 else "32",
        ))
        out["filtered"] = run_filtered_checks(
            store, docs, emb, queries, n_fq, corpus_bm25=bm25
        )
        out["recall_filtered@8"] = round(float(np.mean([
            c["recall@8"] for c in out["filtered"].values()
        ])), 4)
        secs["filtered"] = time.perf_counter() - t0
    del store
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# Product stage: the END-TO-END path at serving scale — Runtime.ask with
# the real catalog (disk-backed), persisted store, neighbor expansion and
# generation tail, measured in FRESH processes so cold-start seconds and
# host RSS are the product's, not this index-building process's.
# ---------------------------------------------------------------------------

PRODUCT_CHUNKS = int(os.getenv("BENCH_PRODUCT_CHUNKS", "1000000"))
PRODUCT_ASKS = int(os.getenv("BENCH_PRODUCT_ASKS", "32"))
_CHUNKS_PER_DOC = 10


def _build_product_corpus(root: Path, n_chunks: int,
                          device: DeviceLike = None) -> float:
    """Materialize a persisted product index: catalog JSONL in the
    canonical on-disk format + a saved IndexStore with its lexical
    snapshot. Ids are real stable_chunk_ids over synthetic doc/chunk
    coordinates, so neighbor expansion reconstructs them arithmetically
    and fetches real catalog entries."""
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.utils.ids import stable_chunk_id

    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    docs, emb = build_corpus(rng, n_chunks)
    bm25 = root / "bm25"
    dense = root / "dense"
    bm25.mkdir(parents=True, exist_ok=True)
    ids, metas = [], []
    with (bm25 / "bm25_index.jsonl").open("w", encoding="utf-8") as f:
        for i, toks in enumerate(docs):
            d, c = divmod(i, _CHUNKS_PER_DOC)
            sp = f"/bench/doc_{d}.txt"
            cid = stable_chunk_id(
                source_path=Path(sp), page=1, chunk_index=c,
                course="bench", unit=None,
            )
            meta = {
                "course": "bench", "language": "en", "doc_type": "txt",
                "source_path": sp, "page": 1, "chunk_id": c,
            }
            f.write(json.dumps(
                {"id": cid, "text": " ".join(toks), "tokens": toks,
                 "metadata": meta},
                ensure_ascii=False,
            ) + "\n")
            ids.append(cid)
            metas.append(meta)
    catalog = Catalog.load_or_create(bm25)
    # The shape get_runtime() builds in the child (config defaults), or
    # the lexical snapshot is refused on its term width and the child
    # rebuilds from the catalog.
    store = IndexStore(
        DIM, dense, slab_rows=4096,
        terms_per_chunk=min(int(os.getenv("BM25_TERMS_PER_CHUNK", "256")),
                            512),
        device=device,
    )
    batch = 8192
    for s in range(0, n_chunks, batch):
        e = min(s + batch, n_chunks)
        store.upsert(ids[s:e], emb[s:e], docs[s:e], metas[s:e])
    store.save(catalog_fingerprint=catalog.fingerprint())
    del store, catalog, docs, emb, ids, metas
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _child_env(root: Path) -> dict:
    env = dict(os.environ)
    env.update(
        INDEX_DIR=str(root),
        BM25_DIR=str(root / "bm25"),
        DENSE_DIR=str(root / "dense"),
        EMB_CACHE_DIR=str(root / "emb_cache"),
        EMBEDDING_BACKEND=env.get("EMBEDDING_BACKEND", "hash"),
        PYTHONPATH=str(_REPO) + os.pathsep + env.get("PYTHONPATH", ""),
    )
    return env


def _run_child(root: Path, argv, device, timeout_s: int):
    """``python -m classmate_rag_tpu_torch.bench <argv> --device DEVICE``
    in ``root``; raises unless it exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "classmate_rag_tpu_torch.bench", *argv,
         "--device", str(device)],
        capture_output=True, text=True, env=_child_env(root),
        timeout=timeout_s, cwd=str(root),
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"bench child {argv} failed (rc={proc.returncode}):\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
        )
    return proc


def _warm_product(root: Path, device, timeout_s: int = 1800) -> float:
    """Deployment prep: build the kernels, then run the runtime's
    ``warmup`` (the CLI verb) in a child against the built index.
    Returns the seconds."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        from classmate_rag_tpu_torch.ops import _build

        _build.build_all()
    _run_child(root, ["product-warmup"], device, timeout_s)
    return time.perf_counter() - t0


def _run_product_child(root: Path, n_asks: int, device,
                       timeout_s: int = 3600) -> dict:
    proc = _run_child(root, ["product-child", str(n_asks)], device,
                      timeout_s)
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("PRODUCT_CHILD_JSON:"):
            return json.loads(line[len("PRODUCT_CHILD_JSON:"):])
    raise RuntimeError(
        f"product child printed no report:\n{proc.stdout[-2000:]}\n"
        f"{proc.stderr[-2000:]}"
    )


def _rss_mb() -> dict:
    out = {}
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith(("VmRSS", "VmHWM")):
                k, v = line.split(":", 1)
                out[k] = round(int(v.split()[0]) / 1024, 1)  # kB -> MB
    except OSError:
        pass
    return out


def product_child_main(n_asks: int, device: DeviceLike = None) -> None:
    """Runs inside the fresh child process: cold-start the Runtime from
    disk on ``device``, answer questions end-to-end, probe one /add +
    persist."""
    from classmate_rag_tpu_torch.metadata import DocumentMetadata
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    t0 = time.perf_counter()
    rt = get_runtime(reload=True, device=device)
    load_s = time.perf_counter() - t0
    report = {
        "runtime_load_s": round(load_s, 3),
        # catalog_s = offset scan or sidecar restore; store_s = slab
        # read (the placement on the card happens at the first query or
        # in the runtime's warm-up thread).
        "load_split_s": rt.load_timings,
        "n_rows": rt.store.n_rows,
        "rss_after_load_mb": _rss_mb(),
    }
    # Readiness: the runtime's warm-up places the slabs and the split
    # layout; the server joins it before announcing readiness, so it is
    # reported as ready_s, with first_ask_s the first answer a caller of
    # a READY process sees.
    if n_asks > 0:
        t0 = time.perf_counter()
        if rt.warmup_thread is not None:
            rt.warmup_thread.join()
        else:
            rt.warmup()
        report["ready_s"] = round(time.perf_counter() - t0, 3)

    if n_asks > 0:
        rng = np.random.default_rng(7)
        weights = 1.0 / np.arange(1, 5001)
        weights /= weights.sum()

        def make_question():
            words = [f"w{i}" for i in
                     rng.choice(5000, size=4, p=weights)]
            return "what about " + " ".join(words)

        filters = DocumentMetadata()
        t0 = time.perf_counter()
        first = ask_question(question=make_question(), filters=filters,
                             top_k=8, runtime=rt)
        report["first_ask_s"] = round(time.perf_counter() - t0, 3)
        report["answer_nonempty"] = bool(first.answer)
        report["retrieved_k"] = len(first.retrieved)
        for _ in range(2):  # absorb first-use costs
            ask_question(question=make_question(), filters=filters,
                         top_k=8, runtime=rt)
        lat = []
        for _ in range(n_asks):
            q = make_question()
            t0 = time.perf_counter()
            ask_question(question=q, filters=filters, top_k=8, runtime=rt)
            lat.append(time.perf_counter() - t0)
        lat_ms = np.asarray(lat) * 1e3
        report["ask_p50_ms"] = round(float(np.percentile(lat_ms, 50)), 1)
        report["ask_p95_ms"] = round(float(np.percentile(lat_ms, 95)), 1)
        report["ask_mean_ms"] = round(float(lat_ms.mean()), 1)
        report["n_asks"] = n_asks

        # /add probe: ingest ONE new document end-to-end and persist.
        # With the O(delta) catalog journal + store deltas this writes
        # KBs, not the multi-GB base.
        from classmate_rag_tpu_torch.pipeline.ingest import ingest_file

        sizes_before = {
            p: p.stat().st_size
            for d in (rt.cfg.bm25_dir, rt.cfg.dense_dir)
            for p in Path(d).iterdir()
        }
        doc = Path(tempfile.mkdtemp()) / "new_doc.txt"
        doc.write_text(
            "A freshly added benchmark document about w1 w2 w3. "
            "It provides additional context for the product add probe.",
            encoding="utf-8",
        )
        t0 = time.perf_counter()
        ingest_file(
            path=doc, doc_meta=DocumentMetadata(course="bench"),
            runtime=rt,
        )
        add_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.persist()
        persist_s = time.perf_counter() - t0
        delta_bytes = 0
        base_rewritten = False
        for d in (rt.cfg.bm25_dir, rt.cfg.dense_dir):
            for p in Path(d).iterdir():
                old = sizes_before.get(p)
                if old is None:
                    delta_bytes += p.stat().st_size
                elif p.stat().st_size != old:
                    if p.name in ("embeddings.npy", "bm25_index.jsonl",
                                  "lexical.npz"):
                        base_rewritten = True
                    delta_bytes += abs(p.stat().st_size - old)
        report["add_s"] = round(add_s, 3)
        report["persist_s"] = round(persist_s, 3)
        report["persist_delta_bytes"] = int(delta_bytes)
        report["persist_rewrote_base"] = base_rewritten

        # Asks AFTER the /add stay at steady-state latency: the O(delta)
        # device sync + split overlay; the full-path counters prove the
        # incremental route.
        lat = []
        for _ in range(4):
            q = make_question()
            t0 = time.perf_counter()
            ask_question(question=q, filters=filters, top_k=8, runtime=rt)
            lat.append(time.perf_counter() - t0)
        report["ask_after_add_first_ms"] = round(lat[0] * 1e3, 1)
        report["ask_after_add_p50_ms"] = round(
            float(np.percentile(np.asarray(lat[1:]) * 1e3, 50)), 1
        )
        report["device_full_uploads"] = rt.store.device_full_uploads
        report["split_full_builds"] = rt.store.split_full_builds
        report["split_snapshot_restores"] = rt.store.split_snapshot_restores
        report["df_full_builds"] = rt.store.df_full_builds
        report["rss_final_mb"] = _rss_mb()

    print("PRODUCT_CHILD_JSON:" + json.dumps(report), flush=True)


def run_product_stage(n_chunks: int, device: DeviceLike = None) -> dict:
    """Build a persisted product index, then measure cold start + asks
    in fresh child processes on ``device`` (A: catalog sidecar removed ->
    full binary scan; B: warm sidecar -> the steady-state cold start)."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="bench_product_") as tmp:
        root = Path(tmp)
        build_s = _build_product_corpus(root, n_chunks, device)
        warmup_s = _warm_product(root, device)
        sidecar = root / "bm25" / "catalog.offsets.npz"
        sidecar.unlink(missing_ok=True)
        cold = _run_product_child(root, 0, device)
        warm = _run_product_child(root, PRODUCT_ASKS, device)
    return {
        "corpus_chunks": n_chunks,
        "build_s": round(build_s, 1),
        "warmup_s": round(warmup_s, 1),
        "cold_scan_start_s": cold["runtime_load_s"],
        "cold_scan_split_s": cold.get("load_split_s"),
        "warm_start_s": warm["runtime_load_s"],
        "warm_split_s": warm.get("load_split_s"),
        "rss_after_load_mb": warm["rss_after_load_mb"],
        **{k: v for k, v in warm.items()
           if k not in ("runtime_load_s", "rss_after_load_mb")},
    }


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", nargs="?",
                    choices=("product-child", "product-warmup"),
                    help="a product-stage child (run by the bench itself)")
    ap.add_argument("n_asks", nargs="?", type=int, default=0,
                    help="questions a product child asks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.command == "product-child":
        product_child_main(args.n_asks, device)
        return 0
    if args.command == "product-warmup":
        from classmate_rag_tpu_torch.cli.main import main as cli_main

        return cli_main(["warmup"], device=device)

    backend = device.type
    primary = run_scale(N_CHUNKS, n_oracle=N_ORACLE, filtered_oracle=True,
                        device=device)
    out = {
        "metric": "hybrid_query_qps",
        "unit": "queries/s",
        **primary,
        "backend": backend,
        "card": smi_line() if backend == "cuda" else None,
    }
    failed = []

    def stage(key, fn):
        # A later stage that fails keeps the completed ones in the line,
        # and the run exits non-zero.
        gc.collect()
        try:
            out[key] = fn()
        except Exception as exc:
            traceback.print_exc(file=sys.stderr)
            out[key] = {"error": f"{type(exc).__name__}: {exc}"}
            failed.append(key)

    if SCALE2_CHUNKS and SCALE2_CHUNKS != N_CHUNKS:
        # Fewer oracle queries at the larger scale.
        stage("scale2", lambda: run_scale(
            SCALE2_CHUNKS, n_oracle=max(N_ORACLE // 2, 8), device=device,
        ))
    if SCALE3_CHUNKS and backend == "cuda":
        # Serving scale (1M): the approx route, a >= 64-query oracle.
        stage("scale3", lambda: run_scale(
            SCALE3_CHUNKS, n_oracle=max(N_ORACLE, 64), filtered_oracle=True,
            device=device,
        ))
    if PRODUCT_CHUNKS and backend == "cuda":
        # The end-to-end product path at serving scale, in fresh child
        # processes (cold start, host RSS, ask p50/p95, /add persist
        # delta): the engine stages above bypass the catalog layer.
        stage("product", lambda: run_product_stage(PRODUCT_CHUNKS, device))
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
