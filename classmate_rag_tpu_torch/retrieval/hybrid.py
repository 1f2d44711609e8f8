"""Hybrid retrieval: dense exact-scan + BM25, RRF-fused, MMR-diversified
(port of the fused path of the JAX package's ``retrieval/hybrid.py``).

1. dense branch: encode query → masked exact top-``pool`` scan → f16
   rescore → greedy MMR reorder (λ=0.5) → first ``k_vector``;
2. lexical branch: tokenize query (query-language stopwords) → subset-
   statistics BM25 top-``k_bm25``;
3. weighted RRF (rrf_k=60) over the two ranked lists, sorted by
   (fused, −distance, row), truncated to ``top_k``.

Every question goes through the store's fused batch step; strings
materialize only at the end. ``hybrid=False`` gives the dense-only path.
When the embedder can encode on the device (``encode_queries_device``,
the E5 encoder), the query vectors go from the encoder's output into the
fused step without a host fetch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from classmate_rag_tpu_torch.index.catalog import Catalog
from classmate_rag_tpu_torch.index.lexical import tokenize_py
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.utils.lang import detect_lang_tag


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

    def retrieve(
        self,
        *,
        question: str,
        filters: Optional[Mapping[str, Any]] = None,
        top_k: int = 8,
        hybrid: bool = True,
    ) -> List[Dict[str, Any]]:
        """Single-question retrieval through the fused batch step (B=1)."""
        return self._retrieve_batch(
            questions=[question], filters=filters, top_k=top_k,
            hybrid=hybrid,
        )[0]

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
        return self._retrieve_batch(
            questions=questions, filters=filters, top_k=top_k, hybrid=hybrid,
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
            tokenize_py(q, detect_lang_tag(q)) if hybrid else []
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
        result = self.store.hybrid_topk_batch(
            q_vecs, q_terms, where,
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
