"""Typed configuration of the port: the JAX package's ``Config`` and
``load_config`` (same field names, environment names and defaults, read
from the environment over an optional ``.env`` file in the working
directory), plus the retrieval and embedding readers of the earlier
slices, which take a plain mapping.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Mapping, Optional


def _parse_dotenv(path: Path) -> dict[str, str]:
    """Minimal .env parser: KEY=VALUE lines, '#' comments, optional quotes."""
    out: dict[str, str] = {}
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return out
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if len(val) >= 2 and val[0] == val[-1] and val[0] in ("'", '"'):
            val = val[1:-1]
        if key:
            out[key] = val
    return out


class _Env:
    """Env lookup that overlays os.environ on top of a parsed .env file."""

    def __init__(self, dotenv_path: Optional[Path] = None) -> None:
        self._dotenv = _parse_dotenv(dotenv_path or Path(".env"))

    def get(self, name: str) -> Optional[str]:
        val = os.environ.get(name)
        if val is None or val == "":
            val = self._dotenv.get(name)
        if val is None or val == "":
            return None
        return val

    def str(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self.get(name) or default

    def int(self, name: str, default: int) -> int:
        v = self.get(name)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            return default

    def float(self, name: str, default: float) -> float:
        v = self.get(name)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            return default

    def bool(self, name: str, default: bool) -> bool:
        v = self.get(name)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "y", "on")


@dataclass(frozen=True)
class Config:
    # --- Embeddings ---------------------------------------------------
    embedding_model_name: str = "intfloat/multilingual-e5-base"
    # Backend: "auto" uses real E5 weights when a local snapshot is found,
    # otherwise falls back to the deterministic hashing encoder so the whole
    # stack runs offline. "e5" forces the transformer (random init if no
    # weights), "hash" forces the hashing encoder.
    embedding_backend: str = "auto"
    # Optional local directory with HF-format E5 weights (safetensors/bin).
    embedding_model_dir: Optional[str] = None
    # Fine-tuned encoder checkpoint (tools/train_encoder.py output root or
    # a step_N dir): when set, the product embedder serves THESE weights —
    # the training subsystem's output feeding ingest/ask/rebuild.
    encoder_checkpoint: Optional[str] = None
    embedding_batch_size: int = 128
    emb_cache_dir: str = "./indexes/emb_cache"
    # Batch data parallelism for bulk encode (ingest/rebuild/dump):
    # 0 = auto (shard padded batches over all local devices), 1 = off,
    # >1 = clamp to that many devices. Clamped to a power of two ≤ 8.
    encode_data_parallel: int = 0

    # --- Index locations ----------------------------------------------
    index_dir: str = "./indexes"
    dense_dir: str = "./indexes/dense"
    bm25_dir: str = "./indexes/bm25"
    collection_name: str = "classmate_rag"

    # --- Chunking / retrieval ------------------------------------------
    chunk_size: int = 1000
    chunk_overlap: int = 150
    k_vector: int = 8
    k_bm25: int = 8
    rrf_k: int = 60
    weight_vector: float = 1.0
    weight_bm25: float = 1.0
    use_hybrid: bool = True
    use_mmr: bool = True
    # Hand encoder output to retrieval on device (skips the host fetch
    # between the two dispatches). Costs query-cache WRITES on miss;
    # disable for cache-heavy repeat-query workloads.
    device_query_encode: bool = True
    mmr_lambda: float = 0.5
    mmr_max_pool: int = 24

    # --- Retrieval ergonomics (first-class here; env-only in the ref) ---
    enable_neighbor_expansion: bool = True
    neighbor_radius: int = 1
    doc_diversity_cap: int = 3
    dedup_chunks: bool = False
    dedup_threshold: float = 0.92

    # --- Ingest ----------------------------------------------------------
    ingest_threads: int = 0  # 0 => max(2, cpu_count // 2)
    enable_ocr: bool = False
    enable_language_detection: bool = True
    default_language: str = "auto"  # en | it | auto

    # --- Generation -------------------------------------------------------
    # Backend: "auto" prefers llama_cpp when importable and a GGUF exists,
    # then the TPU decode runner when weights exist, else the deterministic
    # extractive generator (always available).
    llm_backend: str = "auto"
    llm_model_path: str = "./models/Llama-3.1-8B-Instruct.Q4_K_M.gguf"
    llm_n_ctx: int = 4096
    # Auto-download coordinates + llama.cpp GPU offload (reference
    # config.py fields llm_repo_id/llm_filename/route_n_gpu_layers;
    # previously stray env reads in the runner).
    llm_repo_id: str = ""
    llm_filename: str = ""
    llama_gpu_layers: int = 0
    llm_seed: int = 42
    llm_max_tokens: int = 768
    llm_temperature: float = 0.2
    llm_top_p: float = 0.95
    context_budget_chars: int = 3500
    strict_citations: bool = False
    append_sources_block: bool = False
    translate_on_miss: bool = False

    # --- Routing -----------------------------------------------------------
    enable_routing: bool = False
    route_math_model_path: str = "./models/DeepSeek-R1-Distill-Qwen-7B-Q4_K_M.gguf"
    route_code_model_path: str = "./models/Qwen2.5-Coder-7B-Instruct-Q4_K_M.gguf"
    route_translation_model_path: str = "./models/salamandraTA-7B-instruct.Q4_K_M.gguf"
    route_default_model_path: str = "./models/Qwen3-8B-Q4_K_M.gguf"
    route_n_ctx: int = 4096
    route_query_margin: float = 0.10
    route_metadata_threshold: float = 0.60
    route_translation_requires_intent: bool = True
    route_max_tokens: int = 768
    route_temperature: float = 0.2
    route_top_p: float = 0.95

    # --- Device / parallel ---------------------------------------------------
    # Number of corpus shards; 0 => one shard per local device.
    n_shards: int = 0
    # Dense slab growth quantum (rows); device buffers are padded to this.
    dense_slab_rows: int = 4096
    # Max distinct terms kept per chunk in the packed BM25 arrays.
    bm25_terms_per_chunk: int = 256
    # Compute dtype for the scoring matmul.
    score_dtype: str = "bfloat16"
    # f16 rescore of the dense top pool: "auto"/"on" enable it (measured
    # free at every scale and buys exact-oracle recall; see
    # IndexStore.rescore_enabled), "off" forces the bf16-only scan.
    # Costs one extra [N, d] f16 slab.
    dense_rescore: str = "auto"
    dense_rescore_pool: int = 32
    # Pool-selection op: "auto" uses the TPU-native approx_max_k
    # (PartialReduce) above IndexStore.APPROX_MIN_ROWS when the rescore
    # is active (10x faster selection, pool then ordered exactly);
    # "exact"/"approx" force.
    dense_select: str = "auto"
    # Precompile + place the ask executables in a background thread at
    # runtime load (overlaps the slab upload / XLA compile with whatever
    # the caller does before its first query). "auto" enables it at
    # serving scale (>= 200k rows), where a cold first ask otherwise
    # pays minutes of remote XLA compile; "on"/"off" force.
    runtime_precompile: str = "auto"

    # --- Logging ---------------------------------------------------------------
    log_level: str = "INFO"


_SINGLETON: Optional[Config] = None


def load_config(reload: bool = False) -> Config:
    """Load config once from env + .env; ``reload=True`` re-reads."""
    global _SINGLETON
    if _SINGLETON is not None and not reload:
        return _SINGLETON
    env = _Env()
    g = env  # short alias

    cfg = Config(
        embedding_model_name=g.str("EMBEDDING_MODEL_NAME", "intfloat/multilingual-e5-base"),
        embedding_backend=g.str("EMBEDDING_BACKEND", "auto"),
        embedding_model_dir=g.str("EMBEDDING_MODEL_DIR"),
        encoder_checkpoint=g.str("ENCODER_CHECKPOINT"),
        embedding_batch_size=g.int("EMBEDDING_BATCH_SIZE", 128),
        emb_cache_dir=g.str("EMB_CACHE_DIR", "./indexes/emb_cache"),
        encode_data_parallel=g.int("ENCODE_DATA_PARALLEL", 0),
        index_dir=g.str("INDEX_DIR", "./indexes"),
        dense_dir=g.str("DENSE_DIR", "./indexes/dense"),
        bm25_dir=g.str("BM25_DIR", "./indexes/bm25"),
        collection_name=g.str("COLLECTION_NAME", "classmate_rag"),
        chunk_size=g.int("CHUNK_SIZE", 1000),
        chunk_overlap=g.int("CHUNK_OVERLAP", 150),
        k_vector=g.int("K_VECTOR", 8),
        k_bm25=g.int("K_BM25", 8),
        rrf_k=g.int("RRF_K", 60),
        weight_vector=g.float("WEIGHT_VECTOR", 1.0),
        weight_bm25=g.float("WEIGHT_BM25", 1.0),
        use_hybrid=g.bool("USE_HYBRID", True),
        use_mmr=g.bool("USE_MMR", True),
        device_query_encode=g.bool("DEVICE_QUERY_ENCODE", True),
        mmr_lambda=g.float("MMR_LAMBDA", 0.5),
        mmr_max_pool=g.int("MMR_MAX_POOL", 24),
        enable_neighbor_expansion=g.bool("ENABLE_NEIGHBOR_EXPANSION", True),
        neighbor_radius=g.int("NEIGHBOR_RADIUS", 1),
        doc_diversity_cap=g.int("DOC_DIVERSITY_CAP", 3),
        dedup_chunks=g.bool("DEDUP_CHUNKS", False),
        dedup_threshold=g.float("DEDUP_THRESHOLD", 0.92),
        ingest_threads=g.int("INGEST_THREADS", 0),
        enable_ocr=g.bool("ENABLE_OCR", False),
        enable_language_detection=g.bool("ENABLE_LANGUAGE_DETECTION", True),
        default_language=g.str("DEFAULT_LANGUAGE", "auto"),
        llm_backend=g.str("LLM_BACKEND", "auto"),
        llm_model_path=g.str("LLM_MODEL_PATH", "./models/Llama-3.1-8B-Instruct.Q4_K_M.gguf"),
        llm_n_ctx=g.int("LLM_N_CTX", 4096),
        llm_repo_id=g.str("LLM_REPO_ID", ""),
        llm_filename=g.str("LLM_FILENAME", ""),
        llama_gpu_layers=g.int("LLAMA_GPU_LAYERS", 0),
        llm_seed=g.int("LLM_SEED", 42),
        llm_max_tokens=g.int("LLM_MAX_TOKENS", 768),
        llm_temperature=g.float("LLM_TEMPERATURE", 0.2),
        llm_top_p=g.float("LLM_TOP_P", 0.95),
        context_budget_chars=g.int("CONTEXT_BUDGET_CHARS", 3500),
        strict_citations=g.bool("STRICT_CITATIONS", False),
        append_sources_block=g.bool("APPEND_SOURCES_BLOCK", False),
        translate_on_miss=g.bool("TRANSLATE_ON_MISS", False),
        enable_routing=g.bool("ENABLE_ROUTING", False),
        route_math_model_path=g.str("ROUTE_MATH_MODEL_PATH", "./models/DeepSeek-R1-Distill-Qwen-7B-Q4_K_M.gguf"),
        route_code_model_path=g.str("ROUTE_CODE_MODEL_PATH", "./models/Qwen2.5-Coder-7B-Instruct-Q4_K_M.gguf"),
        route_translation_model_path=g.str("ROUTE_TRANSLATION_MODEL_PATH", "./models/salamandraTA-7B-instruct.Q4_K_M.gguf"),
        route_default_model_path=g.str("ROUTE_DEFAULT_MODEL_PATH", "./models/Qwen3-8B-Q4_K_M.gguf"),
        route_n_ctx=g.int("ROUTE_N_CTX", 4096),
        route_query_margin=g.float("ROUTE_QUERY_MARGIN", 0.10),
        route_metadata_threshold=g.float("ROUTE_METADATA_THRESHOLD", 0.60),
        route_translation_requires_intent=g.bool("ROUTE_TRANSLATION_REQUIRES_INTENT", True),
        route_max_tokens=g.int("ROUTE_MAX_TOKENS", 768),
        route_temperature=g.float("ROUTE_TEMPERATURE", 0.2),
        route_top_p=g.float("ROUTE_TOP_P", 0.95),
        n_shards=g.int("N_SHARDS", 0),
        dense_slab_rows=g.int("DENSE_SLAB_ROWS", 4096),
        bm25_terms_per_chunk=g.int("BM25_TERMS_PER_CHUNK", 256),
        score_dtype=g.str("SCORE_DTYPE", "bfloat16"),
        dense_rescore=g.str("DENSE_RESCORE", "auto"),
        dense_rescore_pool=g.int("DENSE_RESCORE_POOL", 32),
        dense_select=g.str("DENSE_SELECT", "auto"),
        runtime_precompile=g.str("RUNTIME_PRECOMPILE", "auto"),
        log_level=g.str("LOG_LEVEL", "INFO"),
    )
    _SINGLETON = cfg
    return cfg


def config_as_dict(cfg: Optional[Config] = None) -> dict:
    """``cfg``'s fields (default: ``load_config()``) as a plain dict."""
    c = cfg or load_config()
    return {f.name: getattr(c, f.name) for f in fields(c)}


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
    # A training checkpoint of the port (training.checkpoint) served in
    # place of the model's weights.
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


def embedding_config_of(cfg: Config) -> EmbeddingConfig:
    """The embedding knobs of a full ``Config`` (same field names)."""
    return EmbeddingConfig(**{
        f.name: getattr(cfg, f.name) for f in fields(EmbeddingConfig)
    })


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
