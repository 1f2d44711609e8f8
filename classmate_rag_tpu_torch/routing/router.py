"""Hybrid route resolver (parity with rag/routing/router.py:31-151).

Cascade: forced subject → query-confident (top1−top2 margin ≥ query_margin)
→ metadata-confident (top subject fraction of retrieved chunks ≥
metadata_threshold) → default. The translation route additionally requires
an explicit translate-intent keyword (the translation model is
translation-only); otherwise it demotes to default.

Port of the JAX package's ``routing/router.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from classmate_rag_tpu_torch.routing.classifier import SubjectClassifier
from classmate_rag_tpu_torch.routing.prototypes import TRANSLATION_INTENT_KEYWORDS
from classmate_rag_tpu_torch.routing.types import DEFAULT_ROUTE, ROUTES, Route, RouteDecision


def _meta_fractions(metas: Sequence[Dict[str, object]]) -> Dict[Route, float]:
    counts = {r: 0 for r in ROUTES}
    tagged = 0
    for meta in metas:
        if not isinstance(meta, dict):
            continue
        s = meta.get("subject")
        if isinstance(s, str) and s in counts:
            counts[s] += 1
            tagged += 1
    if tagged == 0:
        return {r: 0.0 for r in ROUTES}
    return {r: counts[r] / tagged for r in ROUTES}


def has_translation_intent(question: str) -> bool:
    q = (question or "").lower()
    return any(kw in q for kw in TRANSLATION_INTENT_KEYWORDS)


@dataclass
class HybridRouter:
    classifier: SubjectClassifier
    query_margin: float = 0.10
    metadata_threshold: float = 0.60
    translation_requires_intent: bool = True

    def _guard_translation(
        self, proposed: Route, question: str, base_reason: str
    ) -> tuple[Route, str]:
        if proposed != "translation":
            return proposed, base_reason
        if not self.translation_requires_intent:
            return proposed, "translation_intent"
        if has_translation_intent(question):
            return proposed, "translation_intent"
        return DEFAULT_ROUTE, "translation_demoted_no_intent"

    def decide(
        self,
        question: str,
        retrieved_metas: Optional[Sequence[Dict[str, object]]] = None,
        *,
        forced_subject: Optional[Route] = None,
    ) -> RouteDecision:
        metas = retrieved_metas or []
        if forced_subject in ROUTES:
            return RouteDecision(
                route=forced_subject, reason="forced",
                query_scores={r: 0.0 for r in ROUTES},
                meta_scores=_meta_fractions(metas), margin=0.0,
            )
        return self._decide_scored(
            question, self.classifier.score_query(question), metas
        )

    def decide_batch(
        self,
        questions: Sequence[str],
        retrieved_metas_list: Sequence[Sequence[Dict[str, object]]],
        *,
        forced_subject: Optional[Route] = None,
    ) -> list:
        """decide() for a whole batch with ONE classifier encode
        (classifier.score_queries) instead of B serialized encoder
        dispatches — same decisions as B decide() calls."""
        if forced_subject in ROUTES:
            return [
                RouteDecision(
                    route=forced_subject, reason="forced",
                    query_scores={r: 0.0 for r in ROUTES},
                    meta_scores=_meta_fractions(metas or []), margin=0.0,
                )
                for metas in retrieved_metas_list
            ]
        scores = self.classifier.score_queries(list(questions))
        return [
            self._decide_scored(q, qs, metas or [])
            for q, qs, metas in zip(questions, scores, retrieved_metas_list)
        ]

    def _decide_scored(
        self,
        question: str,
        q_scores: Dict[Route, float],
        metas: Sequence[Dict[str, object]],
    ) -> RouteDecision:
        m_scores = _meta_fractions(metas)
        ranked = sorted(
            ((r, s) for r, s in q_scores.items() if s > 0.0),
            key=lambda kv: kv[1], reverse=True,
        )
        top_route = ranked[0][0] if ranked else None
        top_s = ranked[0][1] if ranked else 0.0
        second_s = ranked[1][1] if len(ranked) > 1 else 0.0
        margin = top_s - second_s

        if top_route is not None and margin >= self.query_margin:
            chosen, reason = self._guard_translation(
                top_route, question, "query_confident"
            )
            return RouteDecision(chosen, reason, q_scores, m_scores, margin)

        m_ranked = sorted(
            ((r, s) for r, s in m_scores.items() if s > 0.0),
            key=lambda kv: kv[1], reverse=True,
        )
        if m_ranked and m_ranked[0][1] >= self.metadata_threshold:
            chosen, reason = self._guard_translation(
                m_ranked[0][0], question, "metadata_override"
            )
            return RouteDecision(chosen, reason, q_scores, m_scores, margin)

        return RouteDecision(
            DEFAULT_ROUTE, "ambiguous_default", q_scores, m_scores, margin
        )
