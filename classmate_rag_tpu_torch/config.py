"""Retrieval and embedding knobs of the port, with the JAX package's
environment names and defaults (the subset of
``classmate_rag_tpu/config.py`` that the hybrid query and the embedder
read)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass(frozen=True)
class RetrievalConfig:
    k_vector: int = 8
    k_bm25: int = 8
    rrf_k: int = 60
    weight_vector: float = 1.0
    weight_bm25: float = 1.0
    use_hybrid: bool = True
    use_mmr: bool = True
    mmr_lambda: float = 0.5
    mmr_max_pool: int = 24
    dense_slab_rows: int = 4096
    bm25_terms_per_chunk: int = 256
    dense_rescore: str = "auto"
    dense_rescore_pool: int = 32
    dense_select: str = "auto"


# field -> environment variable (the JAX package's names).
ENV_NAMES = {
    "k_vector": "K_VECTOR",
    "k_bm25": "K_BM25",
    "rrf_k": "RRF_K",
    "weight_vector": "WEIGHT_VECTOR",
    "weight_bm25": "WEIGHT_BM25",
    "use_hybrid": "USE_HYBRID",
    "use_mmr": "USE_MMR",
    "mmr_lambda": "MMR_LAMBDA",
    "mmr_max_pool": "MMR_MAX_POOL",
    "dense_slab_rows": "DENSE_SLAB_ROWS",
    "bm25_terms_per_chunk": "BM25_TERMS_PER_CHUNK",
    "dense_rescore": "DENSE_RESCORE",
    "dense_rescore_pool": "DENSE_RESCORE_POOL",
    "dense_select": "DENSE_SELECT",
}


def _parse(raw: str, default):
    """The JAX package's rules: an unparsable number keeps the default;
    a boolean is true for 1/true/yes/y/on and false for anything else."""
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "y", "on")
    try:
        return type(default)(raw)
    except ValueError:
        return default


@dataclass(frozen=True)
class EmbeddingConfig:
    embedding_model_name: str = "intfloat/multilingual-e5-base"
    # "auto": E5 with real weights when a local snapshot exists, else the
    # hashing embedder; "e5": the transformer (random init without
    # weights); "hash": the hashing embedder.
    embedding_backend: str = "auto"
    embedding_model_dir: Optional[str] = None
    # Loading a training checkpoint is not ported yet (get_embedder
    # raises when it is set).
    encoder_checkpoint: Optional[str] = None
    emb_cache_dir: str = "./indexes/emb_cache"
    # 0 = every local card, 1 = off, n = at most n (the encoder raises
    # where that means more than one card).
    encode_data_parallel: int = 0


EMBEDDING_ENV_NAMES = {
    "embedding_model_name": "EMBEDDING_MODEL_NAME",
    "embedding_backend": "EMBEDDING_BACKEND",
    "embedding_model_dir": "EMBEDDING_MODEL_DIR",
    "encoder_checkpoint": "ENCODER_CHECKPOINT",
    "emb_cache_dir": "EMB_CACHE_DIR",
    "encode_data_parallel": "ENCODE_DATA_PARALLEL",
}


def load_embedding_config(
    env: Optional[Mapping[str, str]] = None,
) -> EmbeddingConfig:
    """Read the embedding knobs from ``env`` (default ``os.environ``);
    unset or empty variables keep their defaults."""
    env = os.environ if env is None else env
    base = EmbeddingConfig()
    values = {}
    for name, var in EMBEDDING_ENV_NAMES.items():
        raw = env.get(var)
        default = getattr(base, name)
        if not raw:
            values[name] = default
        elif isinstance(default, int):
            values[name] = _parse(raw, default)
        else:
            values[name] = raw
    return EmbeddingConfig(**values)


def load_retrieval_config(
    env: Optional[Mapping[str, str]] = None,
) -> RetrievalConfig:
    """Read the knobs from ``env`` (default ``os.environ``); unset or
    empty variables keep their defaults."""
    env = os.environ if env is None else env
    base = RetrievalConfig()
    values = {}
    for name, var in ENV_NAMES.items():
        raw = env.get(var)
        default = getattr(base, name)
        values[name] = default if not raw else _parse(raw, default)
    return RetrievalConfig(**values)
