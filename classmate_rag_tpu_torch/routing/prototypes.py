"""Subject-prototype seed phrases and translation-intent triggers.

Same mechanism as the reference (rag/routing/prototypes.py:18-73): each
route's seeds are embedded as queries, averaged, and L2-normalized into a
prototype vector; the "default" route deliberately has none and wins by
elimination.

The seed phrases are BEHAVIORAL CONSTANTS, kept byte-equal to the
reference's (like the BM25 stopword sets): with real E5 weights a
paraphrase produces a different prototype vector and therefore different
routing decisions — the classifier differential fuzz enforces equality.

Host copy of the JAX package's ``routing/prototypes.py`` (no JAX); the
port's tests hold both byte-equal.
"""

from __future__ import annotations

from typing import Dict, List

from classmate_rag_tpu_torch.routing.types import Route

SUBJECT_PROTOTYPES: Dict[Route, List[str]] = {
    "math": [
        "solve this equation step by step",
        "calculus derivative integral limit",
        "linear algebra matrix vector eigenvalue",
        "prove this theorem using induction",
        "probability statistics distribution variance",
        "algebra polynomial factor quadratic",
        "geometry trigonometry sine cosine",
        "differential equation solution",
    ],
    "code": [
        "debug this Python function",
        "implement an algorithm in C++",
        "write unit tests for this code",
        "refactor this class for readability",
        "explain this stack trace",
        "data structure linked list binary tree",
        "time complexity big O analysis",
        "regex parse string javascript typescript",
    ],
    "translation": [
        "translate this from English to Italian",
        "traduci questo testo in inglese",
        "what does this Italian phrase mean in English",
        "come si dice in italiano",
        "translation of this paragraph",
        "translate the following sentence",
        "italian grammar conjugation tense",
    ],
    # No prototype: chosen by elimination when nothing else is confident.
    "default": [],
}

TRANSLATION_INTENT_KEYWORDS: tuple[str, ...] = (
    "translate",
    "translation",
    "traduci",
    "traduce",
    "traduzione",
    "traduco",
    "translator",
    "in english",
    "in italian",
    "in italiano",
    "in inglese",
    "how do you say",
    "how to say",
    "come si dice",
    "what does",
)
