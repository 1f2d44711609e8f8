"""Embedding-prototype subject classifier.

Parity with the reference (rag/routing/classifier.py:44-157): prototypes
are L2-normalized means of query-encoded seed phrases computed once;
queries/passages score by cosine; ``classify_text`` needs a top1−top2
margin ≥ min_margin (default 0.05) else returns the default route;
``classify_chunks`` pools passage scores over an evenly-spaced sample of at
most ``sample_size`` chunks.

Port of the JAX package's ``routing/classifier.py``. Scoring stays host
numpy in f32, as there: the port's embedders (E5 on the card, hashing)
return numpy rows, so prototypes and scores are the same arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from classmate_rag_tpu_torch.routing.prototypes import SUBJECT_PROTOTYPES
from classmate_rag_tpu_torch.routing.types import DEFAULT_ROUTE, ROUTES, Route


def _l2(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


@dataclass
class ClassificationResult:
    subject: Route
    scores: Dict[Route, float]
    margin: float


def _top_with_margin(scores: Dict[Route, float]):
    ranked = sorted(
        ((r, s) for r, s in scores.items() if s > 0.0),
        key=lambda kv: kv[1], reverse=True,
    )
    if not ranked:
        return None, 0.0, 0.0
    top_r, top_s = ranked[0]
    second = ranked[1][1] if len(ranked) > 1 else 0.0
    return top_r, top_s, top_s - second


class SubjectClassifier:
    def __init__(self, embedder, prototypes=None) -> None:
        self.embedder = embedder
        self._protos: Dict[Route, np.ndarray] = {}
        proto_map = prototypes or SUBJECT_PROTOTYPES
        for route in ROUTES:
            seeds = proto_map.get(route, [])
            if not seeds:
                continue
            vecs = self.embedder.encode_queries(list(seeds))
            self._protos[route] = _l2(vecs.mean(axis=0).astype(np.float32))

    def _score(self, vec: np.ndarray) -> Dict[Route, float]:
        v = _l2(vec.astype(np.float32))
        return {
            r: float(v @ self._protos[r]) if r in self._protos else 0.0
            for r in ROUTES
        }

    def score_query(self, question: str) -> Dict[Route, float]:
        if not question or not question.strip():
            return {r: 0.0 for r in ROUTES}
        return self._score(self.embedder.encode_queries([question])[0])

    def score_queries(
        self, questions: Sequence[str]
    ) -> List[Dict[Route, float]]:
        """Batch variant of :meth:`score_query`: ONE encoder dispatch for
        all questions (the serving tail routes whole micro-batches; a
        per-question encode is a full E5 forward + host fetch each —
        B serialized link round trips where one suffices). Same scores
        as B score_query calls."""
        live = [
            (i, q) for i, q in enumerate(questions) if q and q.strip()
        ]
        out: List[Dict[Route, float]] = [
            {r: 0.0 for r in ROUTES} for _ in questions
        ]
        if live:
            vecs = self.embedder.encode_queries([q for _, q in live])
            for (i, _q), v in zip(live, vecs):
                out[i] = self._score(v)
        return out

    def score_passage(self, text: str) -> Dict[Route, float]:
        if not text or not text.strip():
            return {r: 0.0 for r in ROUTES}
        return self._score(self.embedder.encode_passages([text])[0])

    def classify_text(self, text: str, *, min_margin: float = 0.05) -> ClassificationResult:
        scores = self.score_passage(text)
        top, _s, margin = _top_with_margin(scores)
        if top is None or margin < min_margin:
            return ClassificationResult(DEFAULT_ROUTE, scores, margin)
        return ClassificationResult(top, scores, margin)

    def classify_chunks(
        self,
        chunk_texts: Iterable[str],
        *,
        sample_size: int = 8,
        min_margin: float = 0.05,
    ) -> ClassificationResult:
        texts: List[str] = [t for t in chunk_texts if t and t.strip()]
        if not texts:
            return ClassificationResult(DEFAULT_ROUTE, {r: 0.0 for r in ROUTES}, 0.0)
        if len(texts) > sample_size:
            step = max(1, len(texts) // sample_size)
            texts = texts[::step][:sample_size]
        # Batch-encode the sample once (the reference encodes one at a time).
        vecs = self.embedder.encode_passages(texts)
        agg = {r: 0.0 for r in ROUTES}
        for v in vecs:
            for r, s in self._score(v).items():
                agg[r] += s
        scores = {r: s / len(texts) for r, s in agg.items()}
        top, _s, margin = _top_with_margin(scores)
        if top is None or margin < min_margin:
            return ClassificationResult(DEFAULT_ROUTE, scores, margin)
        return ClassificationResult(top, scores, margin)
