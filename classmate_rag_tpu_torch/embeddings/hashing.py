"""Deterministic hashing embedder (offline fallback backend).

Copy of the JAX package's ``embeddings/hashing.py``: the same features,
weights and vectors byte for byte, so both packages embed a query alike.

Feature-hashes word unigrams and bigrams into a d-dimensional signed space,
weights by log(1+tf), and L2-normalizes. Cosine similarity then behaves as a
smoothed lexical-overlap measure, which keeps retrieval meaningful where no
E5 weights are present.

Deterministic across runs and machines: hashing uses blake2b, not Python's
randomized ``hash``.
"""

from __future__ import annotations

import re
from hashlib import blake2b
from typing import Sequence

import numpy as np

_WORD_RE = re.compile(r"[\w]+", re.UNICODE)


def _feature_index(feature: str, dim: int) -> tuple[int, float]:
    digest = blake2b(feature.encode("utf-8"), digest_size=8).digest()
    raw = int.from_bytes(digest, "little")
    idx = raw % dim
    sign = 1.0 if (raw >> 63) & 1 else -1.0
    return idx, sign


# Bumped whenever the feature map changes: the embedding cache
# namespaces by model_name, and vectors from different feature maps must
# never share cache entries. v2: bigram keys use "\x00" (a byte no \w
# token can contain) — the old "_" separator misclassified
# underscore-bearing unigrams ("snake_case") as bigrams (half-weighted)
# and collided them with the genuine bigram of the adjacent words.
_FEATURES_VERSION = 2
_BIGRAM_SEP = "\x00"


class HashingEmbedder:
    """Same public surface as the E5 encoder: encode_queries/encode_passages."""

    def __init__(self, dim: int = 768, model_name: str = "hashing-768") -> None:
        self.dim = dim
        self.model_name = f"{model_name}.f{_FEATURES_VERSION}"

    def _embed_one(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dim, dtype=np.float32)
        words = [w.lower() for w in _WORD_RE.findall(text or "")]
        if not words:
            return vec
        counts: dict[str, int] = {}
        for w in words:
            counts[w] = counts.get(w, 0) + 1
        for a, b in zip(words, words[1:]):
            bg = a + _BIGRAM_SEP + b
            counts[bg] = counts.get(bg, 0) + 1
        for feat, tf in counts.items():
            idx, sign = _feature_index(feat, self.dim)
            weight = float(np.log1p(tf))
            if _BIGRAM_SEP in feat:
                weight *= 0.5  # bigrams are supporting evidence
            vec[idx] += sign * weight
        norm = float(np.linalg.norm(vec))
        if norm > 0:
            vec /= norm
        return vec

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self._embed_one(t) for t in texts]).astype(np.float32)

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode(texts)

    def encode_passages(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode(texts)
