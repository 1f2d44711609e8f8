"""Index health snapshot (port of the JAX package's
``pipeline/stats.py``, parity with rag/pipeline/rag.py:721-760)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from classmate_rag_tpu_torch.pipeline.runtime import Runtime, get_runtime


def _disk_usage(path: Path) -> int:
    if not path.exists():
        return 0
    if path.is_file():
        return path.stat().st_size
    total = 0
    for p in path.rglob("*"):
        try:
            if p.is_file():
                total += p.stat().st_size
        except OSError:
            continue
    return total


def index_stats(runtime: Optional[Runtime] = None) -> Dict[str, object]:
    rt = runtime or get_runtime()
    cfg = rt.cfg
    try:
        vectors = len(rt.store)
    except Exception:
        vectors = -1
    try:
        bm25 = len(rt.catalog)
    except Exception:
        bm25 = -1
    from classmate_rag_tpu_torch.utils.metrics import metrics

    out = {
        "vectors": vectors,
        "bm25": bm25,
        "tombstones": rt.store.n_rows - max(vectors, 0),
        "vocab_terms": len(rt.store.vocab),
        "dense_bytes": _disk_usage(Path(cfg.dense_dir)),
        "bm25_bytes": _disk_usage(Path(cfg.bm25_dir)),
        "emb_cache_bytes": _disk_usage(Path(cfg.emb_cache_dir)),
        # O(corpus)-path counters: operators (and the serve bench's
        # mutation-under-load stage) assert small deltas never take the
        # full-rebuild routes. The filtered-df cache's hits and misses
        # (each miss a histogram over the corpus) are the port's own.
        "maintenance": {
            "device_full_uploads": rt.store.device_full_uploads,
            "split_full_builds": rt.store.split_full_builds,
            "split_snapshot_restores": rt.store.split_snapshot_restores,
            "df_full_builds": rt.store.df_full_builds,
            "df_filter_cache_hits": rt.store.df_filter_cache_hits,
            "df_filter_cache_misses": rt.store.df_filter_cache_misses,
        },
        "metrics": metrics.snapshot(),
    }
    if rt.sharded is not None:
        # Shard occupancy of the corpus-sharded serving engine.
        out["sharded"] = rt.sharded.stats()
    return out
