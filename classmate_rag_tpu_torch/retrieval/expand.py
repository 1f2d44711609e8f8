"""Neighbor expansion + per-document diversity caps.

Behavior parity with the reference (rag/retrieval/expand.py:98-153):
- each hit pulls in chunks of the same file with chunk_id ± radius,
  reconstructed arithmetically via the stable-ID formula (same page,
  course, unit) — possible only because chunk IDs are deterministic;
- neighbors score ``seed − 0.001``, inherit catalog metadata, dedupe by id;
- finally a per-``source_path`` cap (default 3) enforces diversity, and is
  applied even when expansion is off (rag/pipeline/rag.py:429-455).

Unlike the reference, which re-reads the BM25 JSONL from disk on every
query (rag/retrieval/expand.py:111,37), this uses the already-loaded
catalog.

Host copy of the JAX package's ``retrieval/expand.py`` (no JAX).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from classmate_rag_tpu_torch.index.catalog import Catalog
from classmate_rag_tpu_torch.utils.ids import stable_chunk_id


def _neighbor_ids(meta: Dict[str, Any], radius: int) -> List[str]:
    sp = meta.get("source_path")
    page = meta.get("page")
    cid = meta.get("chunk_id")
    if sp is None or page is None or cid is None:
        return []
    try:
        page_i = int(page)
        cid_i = int(cid)
    except (TypeError, ValueError):
        return []
    course = meta.get("course") or None
    unit = meta.get("unit") or None
    out = []
    for delta in range(-radius, radius + 1):
        if delta == 0:
            continue
        out.append(stable_chunk_id(
            source_path=Path(str(sp)), page=page_i, chunk_index=cid_i + delta,
            course=course, unit=unit,
        ))
    return out


def expand_with_neighbors(
    results: Sequence[Dict[str, Any]],
    catalog: Catalog,
    *,
    radius: int = 1,
    max_per_doc: Optional[int] = None,
    neighbor_penalty: float = 0.001,
) -> List[Dict[str, Any]]:
    """Expand hits with adjacent chunks, then apply the per-doc cap."""
    seen: set[str] = set()
    expanded: List[Dict[str, Any]] = []

    for r in results:
        rid = str(r.get("id") or "")
        if not rid or rid in seen:
            continue
        seen.add(rid)
        scores = r.get("scores") or {}
        seed_score = float(
            r.get("score") if r.get("score") is not None
            else (scores.get("fused") or 0.0)
        )
        item = dict(r)
        item.setdefault("score", seed_score)
        expanded.append(item)

        if radius <= 0:
            continue
        meta = dict(r.get("metadata") or {})
        for nid in _neighbor_ids(meta, radius):
            if nid in seen:
                continue
            entry = catalog.get(nid)
            if entry is None or not entry.text.strip():
                continue
            seen.add(nid)
            expanded.append({
                "id": nid,
                "document": entry.text,
                "score": seed_score - neighbor_penalty,
                "metadata": dict(entry.metadata),
                "scores": {"fused": seed_score - neighbor_penalty},
            })

    if max_per_doc and max_per_doc > 0:
        counts: Dict[str, int] = {}
        kept: List[Dict[str, Any]] = []
        for item in expanded:
            sp = str((item.get("metadata") or {}).get("source_path") or "")
            if counts.get(sp, 0) < max_per_doc:
                kept.append(item)
                counts[sp] = counts.get(sp, 0) + 1
        expanded = kept
    return expanded
