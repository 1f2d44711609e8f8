"""Retrieval debugging: preview (no generation) + detailed stats (port
of the JAX package's ``admin/inspect.py``).

``retrieve_preview`` parity with the reference (rag/admin/inspect.py:47-106)
with one deliberate deviation, documented there as a quirk (SURVEY §2.4.7):
the reference's preview skips the embedding cache and neighbor expansion so
``preview`` and ``ask`` could return different contexts for the same query.
Here preview runs the same runtime retriever and applies the same expansion
policy, so preview is a faithful dry-run of ask.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from classmate_rag_tpu_torch.generation import format_context_blocks
from classmate_rag_tpu_torch.metadata import DocumentMetadata
from classmate_rag_tpu_torch.pipeline.runtime import Runtime, get_runtime
from classmate_rag_tpu_torch.pipeline.ask import _apply_expansion_and_diversity


def retrieve_preview(
    *,
    question: str,
    filters: DocumentMetadata,
    top_k: int = 8,
    hybrid: bool = True,
    snippet_chars: int = 240,
    runtime: Optional[Runtime] = None,
) -> Dict[str, object]:
    rt = runtime or get_runtime()
    where = filters.to_dict()
    results = rt.retriever.retrieve(
        question=question, filters=where, top_k=int(top_k), hybrid=bool(hybrid)
    )
    results = _apply_expansion_and_diversity(list(results), rt)
    _ctx, provenance = format_context_blocks(results, max_total_chars=None)

    items: List[Dict[str, object]] = []
    for n, r in enumerate(results, start=1):
        scores = r.get("scores") or {}
        items.append({
            "n": n,
            "id": r.get("id"),
            "prov": provenance[n - 1] if n - 1 < len(provenance) else "",
            "snippet": str(r.get("document") or "")[:snippet_chars],
            "scores": {
                "fused": scores.get("fused"),
                "vector_distance": scores.get("vector_distance"),
                "bm25_score": scores.get("bm25_score"),
            },
            "metadata": r.get("metadata") or {},
        })
    return {
        "question": question,
        "top_k": int(top_k),
        "hybrid": bool(hybrid),
        "filters": where,
        "items": items,
    }
