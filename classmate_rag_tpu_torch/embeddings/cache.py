"""Disk embedding cache (copy of the JAX package's ``embeddings/cache.py``),
format-compatible with it and with the reference.

Cache layout:
``<root>/<safe-model-name>/<mode∈{query,passage}>/<sha1(strip(text))>.npy``
float32 vectors. Partial hits are merged in order; corrupted files count as
misses. With the same scheme, caches written by either package (or the
reference stack) are reusable by the other.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def _sha1_of_text(text: str) -> str:
    return hashlib.sha1((text or "").strip().encode("utf-8", "ignore")).hexdigest()


def _safe_model_name(name: str) -> str:
    return "".join(c if c.isalnum() or c in ("-", "_", ".") else "_" for c in name)


class CachingEmbedder:
    """Wraps any embedder with an on-disk .npy cache (same public surface)."""

    def __init__(self, base, cache_dir: Optional[str] = None) -> None:
        self.base = base
        root = cache_dir or os.getenv("EMB_CACHE_DIR") or "./indexes/emb_cache"
        self.root = Path(root).expanduser().resolve()
        model_name = getattr(base, "model_name", "unknown-model")
        # The cache key must reflect the WEIGHTS identity, not just the
        # model name: a random-init fallback encoder writing under the real
        # model's name would poison the cache for later real-weight runs
        # (and for caches shared with the reference stack).
        if getattr(base, "has_pretrained_weights", True) is False:
            model_name = f"{model_name}-randominit"
        self.model_dir = self.root / _safe_model_name(model_name)
        self.model_name = model_name
        self.dim = getattr(base, "dim", None)

    def _path_for(self, mode: str, text: str) -> Path:
        return self.model_dir / mode / f"{_sha1_of_text(text)}.npy"

    def _encode_with_cache(self, mode: str, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return self._call_base(mode, texts)
        mode_dir = self.model_dir / mode
        mode_dir.mkdir(parents=True, exist_ok=True)

        vectors: List[Optional[np.ndarray]] = []
        miss_idx: List[int] = []
        for i, t in enumerate(texts):
            fp = self._path_for(mode, t)
            vec = None
            if fp.exists():
                try:
                    vec = np.load(fp).astype(np.float32, copy=False)
                except Exception:
                    vec = None  # corrupted -> miss
            vectors.append(vec)
            if vec is None:
                miss_idx.append(i)

        if miss_idx:
            fresh = self._call_base(mode, [texts[i] for i in miss_idx])
            for j, i in enumerate(miss_idx):
                vec = np.asarray(fresh[j], dtype=np.float32)
                vectors[i] = vec
                tmp = self._path_for(mode, texts[i])
                try:
                    np.save(tmp, vec)
                except OSError:
                    pass  # cache write failure is non-fatal
        return np.stack([v for v in vectors]).astype(np.float32)

    def _call_base(self, mode: str, texts: Sequence[str]) -> np.ndarray:
        if mode == "query":
            return self.base.encode_queries(list(texts))
        return self.base.encode_passages(list(texts))

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode_with_cache("query", texts)

    def encode_passages(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode_with_cache("passage", texts)

    def _encode_queries_device(self, texts: Sequence[str]):
        """Device-resident query encoding.

        Disk-cache READS are honored: when every query is already cached
        the stacked host vectors return directly — the caller uploads
        them with the batch either way. On any miss the whole batch
        encodes on the device WITHOUT cache writes: writing would fetch
        the vectors to the host, the very copy this path exists to
        remove. Installed as ``encode_queries_device`` only when the
        wrapped encoder has a device path (the hashing fallback has
        none), so callers' getattr probe stays truthful.
        """
        texts = list(texts)
        if texts:
            cached = []
            for t in texts:
                fp = self._path_for("query", t)
                try:
                    cached.append(
                        np.load(fp).astype(np.float32, copy=False)
                        if fp.exists() else None
                    )
                except Exception:
                    cached.append(None)  # corrupted -> miss
            if all(v is not None for v in cached):
                return np.stack(cached)
        return self.base.encode_queries_device(texts)

    def __getattr__(self, name: str):
        if name == "encode_queries_device" and hasattr(
            self.base, "encode_queries_device"
        ):
            return self._encode_queries_device
        raise AttributeError(name)
