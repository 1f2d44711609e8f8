"""Corpus curation: list / show / resolve / delete / reingest (port of
the JAX package's ``admin/manage.py``).

Semantics parity with the reference (rag/admin/manage.py:123-267) with the
catalog as the source of truth. One behavioral fix: deletion really removes
vectors (the reference called a nonexistent Chroma ``delete`` and reported
success regardless, SURVEY §2.4.1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

from classmate_rag_tpu_torch.pipeline.runtime import Runtime, get_runtime


def _matches_simple(meta: Mapping[str, Any], where: Optional[Mapping[str, Any]]) -> bool:
    """Equality + tag_* flag checks, reference semantics
    (rag/admin/manage.py:75-95, enforced by the differential fuzz):
    tags match against persisted ``tag_<slug>`` flags (comma strings and
    lists both accepted, lowercased); every other key compares as
    whitespace-stripped strings — an unknown filter key matches nothing;
    None values are skipped. ``$and`` composition is kept for the BM25
    filter shape. Importable standalone (slim tier)."""
    if not where:
        return True
    if "$and" in where:
        return all(_matches_simple(meta, w) for w in where["$and"])
    for k, v in where.items():
        if v is None:
            continue
        if k == "tags":
            from classmate_rag_tpu_torch.metadata.validation import (
                slug_tag, tags_from_meta,
            )

            if isinstance(v, Mapping) and "$contains" in v:
                v = v["$contains"]
            if isinstance(v, (list, tuple)):
                raw = [str(x) for x in v if str(x).strip()]
            else:
                raw = [p for p in str(v).split(",") if p.strip()]
            # ⊕ filter tags are SLUGGED before the flag lookup. The
            # reference's _matches_simple checks tag_<verbatim-lowered>
            # while its own ingestion persists tag_<slug> — so
            # `--tags week-1` matches nothing there (ingest wrote
            # tag_week_1). Slugging mirrors what its retrieval-side
            # filter does (vector_chroma.py:72) and what our ask path
            # does (store.compile_filter). tags_from_meta also accepts
            # legacy pre-flag catalogs (tags lists).
            have = set(tags_from_meta(meta))
            for t in raw:
                slug = slug_tag(t)
                if slug and slug not in have:
                    return False
            continue
        if str(meta.get(k, "")).strip() != str(v).strip():
            return False
    return True


def _summary(entry) -> Dict[str, Any]:
    from classmate_rag_tpu_torch.metadata.validation import tags_from_meta

    meta = entry.metadata
    return {
        "id": entry.id,
        "source_path": meta.get("source_path"),
        "page": meta.get("page"),
        "chunk_id": meta.get("chunk_id"),
        "course": meta.get("course"),
        "unit": meta.get("unit"),
        "language": meta.get("language"),
        "doc_type": meta.get("doc_type"),
        "tags": tags_from_meta(meta) or None,
        "subject": meta.get("subject"),
    }


def list_entries(
    where: Optional[Mapping[str, Any]] = None,
    *,
    limit: int = 50,
    offset: int = 0,
    runtime: Optional[Runtime] = None,
) -> List[Dict[str, Any]]:
    rt = runtime or get_runtime()
    out = []
    skipped = 0
    for entry in rt.catalog.entries():
        if not _matches_simple(entry.metadata, where):
            continue
        if skipped < offset:
            skipped += 1
            continue
        out.append(_summary(entry))
        if len(out) >= limit:
            break
    return out


def show_entries_by_id(
    ids: Sequence[str],
    *,
    snippet_chars: int = 400,
    runtime: Optional[Runtime] = None,
) -> List[Dict[str, Any]]:
    rt = runtime or get_runtime()
    out = []
    for cid in ids:
        entry = rt.catalog.get(cid)
        if entry is None:
            out.append({"id": cid, "found": False})
            continue
        rec = _summary(entry)
        rec["found"] = True
        rec["snippet"] = entry.text[:snippet_chars]
        out.append(rec)
    return out


def resolve_ids(
    *,
    ids: Optional[Sequence[str]] = None,
    path: Optional[str] = None,
    where: Optional[Mapping[str, Any]] = None,
    runtime: Optional[Runtime] = None,
) -> List[str]:
    """Resolve chunk ids: explicit ``ids`` take FULL precedence (path and
    filters are ignored when ids are given — the reference's documented
    contract, rag/admin/manage.py:154-166: "If ids provided → use
    directly"); otherwise path AND filters conjoin."""
    rt = runtime or get_runtime()
    if ids:
        return [cid for cid in ids if cid in rt.catalog]
    resolved_path = str(Path(path).resolve()) if path else None
    if resolved_path is not None:
        # Path-scoped resolution: the catalog's raw-line scan is ~10x a
        # full body parse at serving scale (1M-chunk path deletes used
        # to take 45 s); residual filters check only the path's own
        # entries.
        fast = getattr(rt.catalog, "ids_for_path", None)
        if fast is not None:
            if not where:
                # No residual filters: the raw scan's ids ARE the answer
                # — skip thousands of per-id seek+parse get() calls for
                # a large document's chunks.
                return list(fast(resolved_path))
            out = []
            for cid in fast(resolved_path):
                entry = rt.catalog.get(cid)
                if entry is not None and _matches_simple(
                    entry.metadata, where
                ):
                    out.append(cid)
            return out
    out = []
    for entry in rt.catalog.entries():
        meta = entry.metadata
        if resolved_path is not None and str(meta.get("source_path")) != resolved_path:
            continue
        if not _matches_simple(meta, where):
            continue
        out.append(entry.id)
    return out


def delete_by_ids(
    ids: Sequence[str],
    *,
    runtime: Optional[Runtime] = None,
) -> Dict[str, int]:
    rt = runtime or get_runtime()
    vec_deleted = rt.store.delete(ids)
    cat_deleted = rt.catalog.delete(ids)
    rt.persist()
    return {"vector_deleted": vec_deleted, "catalog_deleted": cat_deleted}


def list_source_paths(runtime: Optional[Runtime] = None) -> List[str]:
    rt = runtime or get_runtime()
    seen = []
    seen_set = set()
    for entry in rt.catalog.entries():
        sp = entry.metadata.get("source_path")
        if sp and sp not in seen_set:
            seen_set.add(sp)
            seen.append(str(sp))
    return seen


def _consolidate_metadata(entries) -> Dict[str, Any]:
    """First non-empty value per field; tags are the union of tag_*
    flags (insertion order), matching rag/admin/manage.py:201-258."""
    from classmate_rag_tpu_torch.metadata.validation import tags_from_meta

    fields = ("course", "unit", "language", "doc_type", "author", "semester",
              "subject")
    merged: Dict[str, Any] = {}
    tags: List[str] = []
    tag_set = set()
    for entry in entries:
        meta = entry.metadata
        for f in fields:
            if f not in merged and meta.get(f):
                merged[f] = meta[f]
        for t in tags_from_meta(meta):
            if t not in tag_set:
                tag_set.add(t)
                tags.append(t)
    if tags:
        merged["tags"] = tags
    return merged


def reingest_paths(
    paths: Sequence[str],
    *,
    runtime: Optional[Runtime] = None,
) -> List[Dict[str, Any]]:
    """Re-process whole files, inheriting metadata from existing entries."""
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ingest import ingest_file

    rt = runtime or get_runtime()
    results = []
    for raw in paths:
        p = Path(raw).resolve()
        existing = [
            e for e in rt.catalog.entries()
            if str(e.metadata.get("source_path")) == str(p)
        ]
        merged = _consolidate_metadata(existing)
        meta = normalize_cli_metadata(
            course=merged.get("course"),
            unit=merged.get("unit"),
            language=merged.get("language"),
            doc_type=merged.get("doc_type"),
            author=merged.get("author"),
            semester=merged.get("semester"),
            tags=merged.get("tags"),
            subject=merged.get("subject"),
        )
        try:
            res = ingest_file(path=p, doc_meta=meta, runtime=rt)
            # Stable chunk ids make the re-ingest an idempotent upsert of
            # ids 0..k-1 — but when the edited document SHRANK (or chunk
            # boundaries shifted), the old tail ids keep their stale text
            # and would silently mix into answers. Delete every previous
            # id this run did not re-write. (The reference cannot do
            # this — its vector delete was a silent no-op, SURVEY
            # §2.4.1; here deletion is real.)
            fresh = set(res.chunk_ids)
            stale = [e.id for e in existing if e.id not in fresh]
            removed = 0
            if stale:
                removed = rt.store.delete(stale)
                rt.catalog.delete(stale)
                rt.persist()
            results.append({
                "path": str(p), "ok": True,
                "chunks": res.total_chunks, "doc_type": res.doc_type,
                "stale_removed": removed,
            })
        except (FileNotFoundError, ValueError, OSError) as exc:
            results.append({"path": str(p), "ok": False, "error": str(exc)})
    return results
