"""Retrieval knobs of the port, with the JAX package's environment names
and defaults (the subset of ``classmate_rag_tpu/config.py`` that the
hybrid query reads)."""

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
