"""The plain reference at the cells' sizes: the semantics of
``oracle.py`` (rank_bm25's Okapi with its negative-idf rule over the
filtered subset, an exact cosine pool, greedy MMR, RRF with the store's
tie rule), worked out again from the inputs the benchmark hands the
program: the passages' word ids, the float16 vectors, the courses, the
query vectors and words.

What differs from ``oracle.py`` is only how the same numbers are got at
a million passages: the Okapi state comes from one sort of the word ids
(``OkapiIndex``, ``FastOracleBM25``'s arrays), exact top-k ties resolve
by row ascending without sorting the corpus, and the dense scores are
one float32 matrix product a block of rows in plain torch, on the run's
device with TF32 off.

``precision="control"`` is the same reference computed one step lower,
the control of the correctness check: the vectors and queries in int8
(a scale a row, symmetric) and BM25's weights and saturations rounded to
bfloat16, summed in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rag_bench.reference.oracle import oracle_mmr

K1, B, EPS = 1.5, 0.75, 0.25


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def top_rows(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` best ``scores``, by (score desc, index asc):
    ``np.argsort(-scores, kind="stable")[:k]`` without the full sort."""
    n = len(scores)
    k = min(k, n)
    if k == 0:
        return np.zeros(0, np.int64)
    thr = np.partition(scores, n - k)[n - k]
    cand = np.flatnonzero(scores >= thr)
    return cand[np.lexsort((cand, -scores[cand]))][:k]


class OkapiIndex:
    """``FastOracleBM25`` over the passages ``rows`` (all when None),
    built from integer word ids; ``get_scores`` is that class's, on word
    ids (a repeated query word counts again)."""

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray,
                 rows: Optional[np.ndarray] = None):
        if rows is None:
            lengths = np.diff(offsets)
            tok = tokens
        else:
            starts = offsets[rows]
            lengths = offsets[rows + 1] - starts
            first = np.cumsum(lengths) - lengths
            tok = tokens[np.repeat(starts - first, lengths)
                         + np.arange(int(lengths.sum()))]
        n = len(lengths)
        self.n_docs = n
        self.doc_len = lengths.astype(np.float32)
        self.avgdl = float(self.doc_len.mean())
        key = tok.astype(np.int64) * n + np.repeat(
            np.arange(n, dtype=np.int64), lengths)
        key.sort()
        new = np.ones(len(key), bool)
        new[1:] = key[1:] != key[:-1]
        starts = np.flatnonzero(new)
        tids, self.post_rows = np.divmod(key[starts], n)
        self.post_tfs = np.diff(np.append(starts, len(key))).astype(np.float32)
        del key
        n_terms = int(tids[-1]) + 1 if len(tids) else 0
        df = np.bincount(tids, minlength=n_terms).astype(np.float64)
        self.df = df
        self.offsets = np.zeros(n_terms + 1, np.int64)
        np.cumsum(df.astype(np.int64), out=self.offsets[1:])
        present = df > 0
        idf = np.zeros(n_terms)
        idf[present] = (np.log(n - df[present] + 0.5)
                        - np.log(df[present] + 0.5))
        avg = idf[present].mean() if present.any() else 0.0
        idf[present & (idf < 0)] = EPS * avg
        self.idf = idf.astype(np.float32)
        self._denom = K1 * (1 - B + B * self.doc_len / self.avgdl)

    def postings(self, t: int):
        if t >= len(self.idf):
            return self.post_rows[:0], self.post_tfs[:0]
        s, e = self.offsets[t], self.offsets[t + 1]
        return self.post_rows[s:e], self.post_tfs[s:e]

    def get_scores(self, query: Sequence[int], bf16: bool = False):
        score = np.zeros(self.n_docs, np.float32)
        if bf16:
            # The control: weight (idf x multiplicity) and saturation in
            # bfloat16, their products summed in float32.
            words, counts = np.unique(np.asarray(query, np.int64),
                                      return_counts=True)
            for q, c in zip(words.tolist(), counts.tolist()):
                r, f = self.postings(q)
                sat = f * (K1 + 1) / (f + self._denom[r])
                score[r] += (bf16_round(np.float32(c) * self.idf[q:q + 1])
                             * bf16_round(sat))
            return score
        for q in query:
            r, f = self.postings(int(q))
            score[r] += self.idf[int(q)] * (f * (K1 + 1)
                                            / (f + self._denom[r]))
        return score

    def row_scores(self, query: Sequence[int], rows: np.ndarray):
        """Exact Okapi scores of the (local) ``rows`` alone."""
        rows = np.asarray(rows, np.int64)
        score = np.zeros(len(rows), np.float32)
        for q in query:
            r, f = self.postings(int(q))
            if not len(r):
                continue
            pos = np.minimum(np.searchsorted(r, rows), len(r) - 1)
            hit = r[pos] == rows
            tf = np.where(hit, f[pos], 0.0).astype(np.float32)
            sat = tf * (K1 + 1) / (tf + self._denom[np.maximum(rows, 0)])
            score += np.where(hit, self.idf[int(q)] * sat, 0.0).astype(
                np.float32)
        return score


class DenseScorer:
    """Cosine scores of queries against the float16 passage vectors, in
    float32 (TF32 off) on ``device``; int8 a row for the control."""

    BLOCK = 1 << 17

    def __init__(self, emb16: np.ndarray, device, int8: bool = False):
        self.device = torch.device(device)
        self.int8 = int8
        e = torch.from_numpy(emb16).to(self.device)
        if int8:
            self.scale = e.float().abs().amax(1) / 127.0
            self.e = torch.round(e.float() / self.scale[:, None]).to(
                torch.int8)
        else:
            self.e = e

    def _quant_q(self, q: torch.Tensor) -> torch.Tensor:
        s = q.abs().amax(1, keepdim=True) / 127.0
        return torch.round(q / s) * s

    def vectors(self, rows: np.ndarray) -> np.ndarray:
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        v = self.e[idx].float()
        if self.int8:
            v = v * self.scale[idx][:, None]
        return v.cpu().numpy()

    def _block(self, rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        v = self.e[rows].float()
        if self.int8:
            return (v @ q.T) * self.scale[rows][:, None]
        return v @ q.T

    def pools(self, q_vecs: np.ndarray, scope: Optional[np.ndarray],
              pool: int):
        """Per query, the ``pool`` best rows of ``scope`` (all rows when
        None) by (score desc, row asc), and their scores."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return self._pools(q_vecs, scope, pool)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.set_float32_matmul_precision(prev[1])

    def _pools(self, q_vecs, scope, pool):
        q = torch.from_numpy(np.asarray(q_vecs, np.float32)).to(self.device)
        if self.int8:
            q = self._quant_q(q)
        n = self.e.shape[0] if scope is None else len(scope)
        scope_t = (torch.arange(n, device=self.device) if scope is None
                   else torch.from_numpy(np.asarray(scope, np.int64)).to(
                       self.device))
        m = min(pool + 16, n)
        best_v = best_i = None
        for s in range(0, n, self.BLOCK):
            rows = scope_t[s:s + self.BLOCK]
            sims = self._block(rows, q).T                     # [S, b]
            v, i = torch.topk(sims, min(m, sims.shape[1]), dim=1)
            i = rows[i]
            if best_v is not None:
                v, j = torch.topk(torch.cat([best_v, v], 1), m, dim=1)
                i = torch.cat([best_i, i], 1).gather(1, j)
            best_v, best_i = v, i
        vals, rows = best_v.cpu().numpy(), best_i.cpu().numpy()
        out_r = np.empty((len(q_vecs), min(pool, n)), np.int64)
        out_v = np.empty(out_r.shape, np.float32)
        k = out_r.shape[1]
        for j in range(len(q_vecs)):
            v, r = vals[j], rows[j]
            if m < n and v[m - 1] == v[k - 1]:
                # A run of equal scores reaches past the margin: the whole
                # column decides.
                full = torch.cat([
                    self._block(scope_t[s:s + self.BLOCK], q[j:j + 1])[:, 0]
                    for s in range(0, n, self.BLOCK)]).cpu().numpy()
                top = top_rows(full, k)
                out_r[j] = scope_t.cpu().numpy()[top]
                out_v[j] = full[top]
                continue
            order = np.lexsort((r, -v))[:k]
            out_r[j], out_v[j] = r[order], v[order]
        return out_r, out_v


@dataclass
class Query:
    vec: np.ndarray          # float32 [d]
    words: np.ndarray        # word ids (with repeats)
    course: Optional[int]    # the filter's course; None: no filter


@dataclass
class Answer:
    rows: np.ndarray         # [top_k] global rows, -1 padded
    fused: np.ndarray
    vec_dist: np.ndarray     # NaN where the dense branch did not return
    bm25: np.ndarray         # NaN where BM25 did not return


class Reference:
    """The hybrid query of ``oracle.oracle_query`` (unfiltered) and
    ``oracle.oracle_query_masked`` (a course filter: statistics, pool and
    ranks over the course's rows) over a whole corpus."""

    def __init__(self, tokens, offsets, emb16, course, retrieval: Dict,
                 device, precision: str = "exact"):
        if precision not in ("exact", "control"):
            raise ValueError(precision)
        self.control = precision == "control"
        self.tokens, self.offsets, self.course = tokens, offsets, course
        self.emb16 = emb16
        self.p = retrieval
        self.dense = DenseScorer(emb16, device, int8=self.control)
        self._okapi: Dict[Optional[int], OkapiIndex] = {}
        self._scope: Dict[Optional[int], Optional[np.ndarray]] = {}

    def scope(self, course: Optional[int]) -> Optional[np.ndarray]:
        if course not in self._scope:
            self._scope[course] = (None if course is None else
                                   np.flatnonzero(self.course == course))
        return self._scope[course]

    def okapi(self, course: Optional[int]) -> OkapiIndex:
        if course not in self._okapi:
            self._okapi[course] = OkapiIndex(self.tokens, self.offsets,
                                             self.scope(course))
        return self._okapi[course]

    def cos_dist(self, q: Query, rows: np.ndarray) -> np.ndarray:
        """1 - cosine of each row, exact in float32, NaN for a row outside
        the query's filter (judging)."""
        rows = np.asarray(rows, np.int64)
        v = self.emb16[np.maximum(rows, 0)].astype(np.float32)
        dist = (1.0 - v @ q.vec).astype(np.float32)
        if q.course is None:
            return dist
        return np.where(self.course[np.maximum(rows, 0)] == q.course, dist,
                        np.float32(np.nan))

    def bm25_of(self, q: Query, rows: np.ndarray) -> np.ndarray:
        """Exact Okapi score of each global row under the query's
        subset statistics, NaN for a row outside the filter (judging)."""
        rows = np.asarray(rows, np.int64)
        scope = self.scope(q.course)
        if scope is None:
            return self.okapi(None).row_scores(q.words, rows)
        pos = np.minimum(np.searchsorted(scope, rows), len(scope) - 1)
        inside = scope[pos] == rows
        got = self.okapi(q.course).row_scores(q.words, pos)
        return np.where(inside, got, np.nan)

    def answer(self, queries: List[Query]) -> List[Answer]:
        p = self.p
        out: List[Optional[Answer]] = [None] * len(queries)
        by_scope: Dict[Optional[int], List[int]] = {}
        for i, q in enumerate(queries):
            by_scope.setdefault(q.course, []).append(i)
        for course, idx in by_scope.items():
            scope = self.scope(course)
            qv = np.stack([queries[i].vec for i in idx])
            pool_rows, pool_vals = self.dense.pools(
                qv, scope, p["pool"] if p["use_mmr"] else p["k_vector"])
            for j, i in enumerate(idx):
                out[i] = self._one(queries[i], scope, pool_rows[j],
                                   pool_vals[j])
        return out

    def _one(self, q: Query, scope, pool_rows, pool_vals) -> Answer:
        p = self.p
        k = p["top_k"]
        if p["use_mmr"]:
            cand = self.dense.vectors(pool_rows)
            qv = q.vec
            if self.control:
                s = np.abs(qv).max() / 127.0
                qv = (np.round(qv / s) * s).astype(np.float32)
            order = oracle_mmr(qv, cand, p["k_vector"], p["mmr_lambda"])
        else:
            order = list(range(min(p["k_vector"], len(pool_rows))))
        vec_ids = [int(pool_rows[i]) for i in order]
        sims = {int(pool_rows[i]): float(pool_vals[i]) for i in order}
        bm_ids, bm_val = [], {}
        if len(q.words):
            ok = self.okapi(q.course)
            scores = ok.get_scores(q.words, bf16=self.control)
            local = top_rows(scores, p["k_bm25"])
            bm_ids = [int(r) if scope is None else int(scope[r])
                      for r in local]
            bm_val = dict(zip(bm_ids, scores[local].tolist()))
        rrf = p["rrf_k"]
        fused: Dict[int, float] = {}
        for rank, i in enumerate(vec_ids):
            fused[i] = fused.get(i, 0.0) + 1.0 / (rrf + rank + 1)
        for rank, i in enumerate(bm_ids):
            fused[i] = fused.get(i, 0.0) + 1.0 / (rrf + rank + 1)
        ranked = sorted(
            fused.items(),
            key=lambda kv: (kv[1],
                            -(1.0 - sims[kv[0]]) if kv[0] in sims else 0.0,
                            -kv[0]),
            reverse=True,
        )[:k]
        rows = np.full(k, -1, np.int64)
        fz = np.full(k, -np.inf)
        vd = np.full(k, np.nan)
        bm = np.full(k, np.nan)
        for j, (r, f) in enumerate(ranked):
            rows[j], fz[j] = r, f
            if r in sims:
                vd[j] = 1.0 - sims[r]
            if r in bm_val:
                bm[j] = bm_val[r]
        return Answer(rows, fz, vd, bm)
