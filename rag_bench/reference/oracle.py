"""Frozen copy of the port bench's CPU oracle, kept as the benchmark's
plain reference: ``OracleBM25``, ``FastOracleBM25``, ``oracle_mmr``,
``oracle_query`` and ``oracle_query_masked`` of
``classmate_rag_tpu_torch/bench.py`` (lines 111-294 at the commit that
added this file), copied unchanged apart from this docstring and the
constants below. It imports numpy alone, and nothing of the program.

``hybrid.py`` serves the same semantics at the cells' sizes; the
benchmark's tests hold it equal to this file at a small size.
"""

from __future__ import annotations

import math

import numpy as np

K = 8
POOL = 24
RRF_K = 60


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
