"""Hybrid retrieval: dense exact-scan + BM25, RRF-fused, MMR-diversified
(port of the JAX package's ``retrieval/hybrid.py``).

1. dense branch: encode query → masked exact top-``pool`` scan → f16
   rescore → greedy MMR reorder (λ=0.5) → first ``k_vector``;
2. lexical branch: tokenize query (query-language stopwords) → subset-
   statistics BM25 top-``k_bm25``;
3. weighted RRF (rrf_k=60) over the two ranked lists, sorted by
   (fused, −distance, row), truncated to ``top_k``.

By default every question goes through the store's fused batch step;
strings materialize only at the end. ``retrieve(use_fused=False)`` runs
the JAX package's per-question spec path instead (dense top-k without
the f16 pool rescore, MMR, BM25 top-k, RRF as separate calls); like the
JAX package's, it can rank differently from the fused path (ROADMAP §3).
``hybrid=False`` gives the dense-only path. When the embedder can
encode on the device (``encode_queries_device``, the E5 encoder), the
query vectors go from the encoder's output into the fused step without a
host fetch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from classmate_rag_tpu_torch.index.catalog import Catalog
from classmate_rag_tpu_torch.index.lexical import tokenize
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.ops.fusion import rrf_merge
from classmate_rag_tpu_torch.ops.mmr import mmr_order
from classmate_rag_tpu_torch.utils.lang import detect_lang_tag
from classmate_rag_tpu_torch.utils.metrics import metrics


@dataclass
class HybridRetriever:
    store: IndexStore
    catalog: Catalog
    embedder: Any

    k_vector: int = 8
    k_bm25: int = 8
    rrf_k: int = 60
    weight_vector: float = 1.0
    weight_bm25: float = 1.0
    use_mmr: bool = True
    mmr_lambda: float = 0.5
    mmr_max_pool: int = 24
    # Device-resident encode → retrieve handoff; False forces the
    # (cached) host encode path.
    use_device_encode: bool = True
    # The corpus-sharded serving engine (parallel.ShardedHybridIndex):
    # when set, the fused path asks through it instead of the store.
    sharded: Any = None

    def _dense_branch(
        self, query: str, where: Optional[Mapping[str, Any]], k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (rows [k], cosine distances [k]) in final (MMR) order."""
        q_vec = self.embedder.encode_queries([query])[0].astype(np.float32)
        pool = max(k, self.mmr_max_pool) if self.use_mmr else k
        scores, rows = self.store.dense_topk(q_vec[None, :], where, pool)
        scores, rows = scores[0], rows[0]
        if not self.use_mmr:
            return rows[:k], 1.0 - scores[:k]
        valid = rows >= 0
        cand_embs = self.store.embeddings_for_rows(np.maximum(rows, 0))
        dev = cand_embs.device
        order = mmr_order(
            torch.from_numpy(q_vec)[None].to(dev), cand_embs[None],
            torch.from_numpy(valid)[None].to(dev), k, self.mmr_lambda,
        )[0].cpu().numpy()
        picked = order[order >= 0]
        out_rows = np.full(k, -1, dtype=np.int64)
        out_dist = np.zeros(k, dtype=np.float32)
        n = min(len(picked), k)
        out_rows[:n] = rows[picked[:n]]
        out_dist[:n] = 1.0 - scores[picked[:n]]
        return out_rows, out_dist

    def _bm25_branch(
        self, query: str, where: Optional[Mapping[str, Any]], k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        terms = tokenize(query, detect_lang_tag(query))
        if not terms:
            return (np.full(k, -1, dtype=np.int64),
                    np.zeros(k, dtype=np.float32))
        scores, rows = self.store.bm25_topk(terms, where, k)
        return rows.astype(np.int64), scores

    def retrieve(
        self,
        *,
        question: str,
        filters: Optional[Mapping[str, Any]] = None,
        top_k: int = 8,
        hybrid: bool = True,
        use_fused: bool = True,
    ) -> List[Dict[str, Any]]:
        """Single-question retrieval: through the fused batch step (B=1)
        by default; ``use_fused=False`` takes the per-question spec path,
        which can rank differently (see the module docstring)."""
        with metrics.timer("retrieve"):
            if use_fused:
                return self._retrieve_batch(
                    questions=[question], filters=filters, top_k=top_k,
                    hybrid=hybrid,
                )[0]
            return self._retrieve(
                question=question, filters=filters, top_k=top_k,
                hybrid=hybrid,
            )

    def retrieve_batch(
        self,
        *,
        questions: List[str],
        filters: Optional[Mapping[str, Any]] = None,
        top_k: int = 8,
        hybrid: bool = True,
    ) -> List[List[Dict[str, Any]]]:
        """Batched hybrid retrieval: one fused step for all questions
        (they share one filter dict). Per-question result lists are
        identical to ``retrieve``'s."""
        with metrics.timer("retrieve_batch"):
            return self._retrieve_batch(
                questions=questions, filters=filters, top_k=top_k,
                hybrid=hybrid,
            )

    def _retrieve_batch(
        self,
        *,
        questions: List[str],
        filters: Optional[Mapping[str, Any]] = None,
        top_k: int = 8,
        hybrid: bool = True,
    ) -> List[List[Dict[str, Any]]]:
        where = dict(filters) if filters else None
        live = [
            (i, q) for i, q in enumerate(questions)
            if q.strip() and len(self.store) > 0
        ]
        out: List[List[Dict[str, Any]]] = [[] for _ in questions]
        if not live:
            return out

        encode_device = (
            getattr(self.embedder, "encode_queries_device", None)
            if self.use_device_encode else None
        )
        if encode_device is not None:
            q_vecs = encode_device([q for _i, q in live])
        else:
            q_vecs = self.embedder.encode_queries(
                [q for _i, q in live]
            ).astype(np.float32)
        q_terms = [
            tokenize(q, detect_lang_tag(q)) if hybrid else []
            for _i, q in live
        ]
        # Pad the batch to a power of two, as the reference does (its
        # compiled step sees few distinct shapes; here it keeps the
        # batch shapes, and so the results, identical to it).
        n_live = len(live)
        b_pad = 1 << (n_live - 1).bit_length() if n_live > 1 else 1
        if b_pad > n_live:
            if isinstance(q_vecs, torch.Tensor):   # stays on its device
                q_vecs = torch.cat([q_vecs, q_vecs.new_zeros(
                    (b_pad - n_live, q_vecs.shape[1]))])
            else:
                q_vecs = np.concatenate([
                    q_vecs,
                    np.zeros((b_pad - n_live, q_vecs.shape[1]), np.float32),
                ])
            q_terms = q_terms + [[] for _ in range(b_pad - n_live)]
        # Dense-only widens k_vector to top_k; empty term lists disable
        # the bm25 branch via has_terms.
        kv = self.k_vector if hybrid else max(top_k, self.k_vector)
        knobs = dict(
            k_vector=kv,
            k_bm25=self.k_bm25,
            top_k=top_k,
            pool=max(kv, self.mmr_max_pool) if self.use_mmr else kv,
            use_mmr=self.use_mmr,
            mmr_lambda=self.mmr_lambda,
            rrf_k=self.rrf_k,
            weight_vector=self.weight_vector if hybrid else 1.0,
            weight_bm25=self.weight_bm25,
        )
        if self.sharded is not None:
            # The engine first drains the store's mutation journal
            # (O(delta) re-place), so admin mutations are visible.
            self.sharded.ensure_fresh()
            result = self.sharded.query_batch(q_vecs, q_terms, where,
                                              **knobs)
        else:
            result = self.store.hybrid_topk_batch(q_vecs, q_terms, where,
                                                  **knobs)
        rows, fused, vdist, bscore = (t.cpu().numpy() for t in result)

        for pos, (i, _q) in enumerate(live):
            items: List[Dict[str, Any]] = []
            for j in range(rows.shape[1]):
                r = int(rows[pos, j])
                if r < 0 or r >= self.store.n_rows:
                    continue
                cid = self.store.ids[r]
                entry = self.catalog.get(cid)
                vd = float(vdist[pos, j])
                bs = float(bscore[pos, j])
                items.append({
                    "id": cid,
                    "document": entry.text if entry else "",
                    "metadata": dict(entry.metadata) if entry else {},
                    "scores": {
                        "vector_distance": None if np.isnan(vd) else vd,
                        "bm25_score": None if np.isnan(bs) else bs,
                        "fused": float(fused[pos, j]),
                    },
                })
            out[i] = items
        return out

    def _retrieve(
        self,
        *,
        question: str,
        filters: Optional[Mapping[str, Any]] = None,
        top_k: int = 8,
        hybrid: bool = True,
    ) -> List[Dict[str, Any]]:
        """The per-question spec path: each branch and the fusion as
        separate calls."""
        where = dict(filters) if filters else None
        if not question.strip() or len(self.store) == 0:
            return []

        if hybrid:
            vec_rows, vec_dist = self._dense_branch(
                question, where, self.k_vector)
            bm_rows, bm_scores = self._bm25_branch(
                question, where, self.k_bm25)
        else:
            kv = max(top_k, self.k_vector)
            vec_rows, vec_dist = self._dense_branch(question, where, kv)
            bm_rows = np.full(1, -1, dtype=np.int64)
            bm_scores = np.zeros(1, dtype=np.float32)

        def row(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype))[None]

        rows, fused, vdist, bscore = (t[0].numpy() for t in rrf_merge(
            row(vec_rows, np.int64), row(bm_rows, np.int64),
            row(vec_dist, np.float32), row(bm_scores, np.float32),
            self.weight_vector if hybrid else 1.0,
            self.weight_bm25,
            self.rrf_k,
            top_k,
        ))

        out: List[Dict[str, Any]] = []
        for j in range(len(rows)):
            r = int(rows[j])
            if r < 0:
                continue
            cid = self.store.ids[r] if r < self.store.n_rows else None
            if cid is None:
                continue
            entry = self.catalog.get(cid)
            vd = float(vdist[j])
            bs = float(bscore[j])
            out.append({
                "id": cid,
                "document": entry.text if entry else "",
                "metadata": dict(entry.metadata) if entry else {},
                "scores": {
                    "vector_distance": None if np.isnan(vd) else vd,
                    "bm25_score": None if np.isnan(bs) else bs,
                    "fused": float(fused[j]),
                },
            })
        return out
