"""Embedding backends: the E5 encoder, the hashing fallback, the disk
cache (port of ``classmate_rag_tpu.embeddings``).

``get_embedder`` picks the backend from ``EmbeddingConfig`` (env
``EMBEDDING_BACKEND``):

- "auto": E5 with real weights when a local snapshot exists, else hashing;
- "e5": the transformer regardless (random init without weights);
- "hash": the deterministic hashing embedder.

The E5 encoder runs on CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from classmate_rag_tpu_torch.config import (
    EmbeddingConfig,
    load_embedding_config,
)
from classmate_rag_tpu_torch.device import DeviceLike
from classmate_rag_tpu_torch.embeddings.cache import CachingEmbedder
from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder
from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder


def _has_weights(d: Path) -> bool:
    return (d / "model.safetensors").exists() or (d / "pytorch_model.bin").exists()


def _find_local_snapshot(model_name: str, model_dir: Optional[str]) -> Optional[str]:
    """Locate a local HF snapshot WITH weight files (no network access
    ever). A tokenizer-only directory does not count: selecting the
    transformer backend on it would silently run random-init weights."""
    candidates = []
    if model_dir:
        candidates.append(Path(model_dir))
    hf_home = os.getenv("HF_HOME") or os.path.expanduser("~/.cache/huggingface")
    repo_dir = "models--" + model_name.replace("/", "--")
    candidates.append(Path(hf_home) / "hub" / repo_dir / "snapshots")
    candidates.append(Path("./models") / model_name.split("/")[-1])
    for cand in candidates:
        if not cand.exists():
            continue
        if _has_weights(cand):
            return str(cand)
        for sub in sorted(cand.glob("*")):
            if _has_weights(sub):
                return str(sub)
    return None


def get_embedder(
    cfg: Optional[EmbeddingConfig] = None,
    model_name: Optional[str] = None,
    checkpoint: Optional[str] = None,
    device: DeviceLike = None,
):
    """Build the configured embedding backend (uncached)."""
    cfg = cfg or load_embedding_config()
    name = model_name or cfg.embedding_model_name
    backend = cfg.embedding_backend.lower()

    if (checkpoint or cfg.encoder_checkpoint) and backend != "hash":
        raise NotImplementedError(
            "loading a training checkpoint into the encoder is not ported "
            "yet (ROADMAP, queue item 'Training')")

    if backend == "hash":
        return HashingEmbedder(model_name=f"hash-{name.split('/')[-1]}")

    snapshot = _find_local_snapshot(name, cfg.embedding_model_dir)
    if backend == "auto" and snapshot is None:
        return HashingEmbedder(model_name=f"hash-{name.split('/')[-1]}")

    model_dir = snapshot
    if model_dir is None and backend == "e5":
        # Forced-e5 runs random-init when weights are absent, but a
        # tokenizer-only model_dir must still supply the real tokenizer.
        if cfg.embedding_model_dir and Path(cfg.embedding_model_dir).exists():
            model_dir = cfg.embedding_model_dir
    return E5Encoder(
        model_name=name, model_dir=model_dir,
        data_parallel=cfg.encode_data_parallel, device=device,
    )


def get_caching_embedder(
    cfg: Optional[EmbeddingConfig] = None,
    model_name: Optional[str] = None,
    checkpoint: Optional[str] = None,
    device: DeviceLike = None,
):
    cfg = cfg or load_embedding_config()
    return CachingEmbedder(
        get_embedder(cfg, model_name, checkpoint, device),
        cache_dir=cfg.emb_cache_dir,
    )


__all__ = [
    "CachingEmbedder",
    "E5Encoder",
    "HashingEmbedder",
    "get_caching_embedder",
    "get_embedder",
]
