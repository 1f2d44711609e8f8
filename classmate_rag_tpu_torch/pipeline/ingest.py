"""Ingest pipeline: load → chunk → dedup → classify → embed → index
(port of the JAX package's ``pipeline/ingest.py``; host code unchanged,
the index is the port's store).

Call-flow parity with the reference (rag/pipeline/rag.py:275-422):
- doc type from metadata or extension; loader returns (page, text) pairs;
- page-parallel chunking on a thread pool (workers = INGEST_THREADS config
  or max(2, cpu_count/2)) with sequentially reassigned global chunk ids;
- optional near-duplicate suppression (Jaccard 5-gram shingles) — done in
  ONE pass here (the reference re-chunked the whole document a second time
  to rebuild ordering, rag/pipeline/rag.py:314-324);
- subject resolution: explicit metadata > folder-name hint > chunk-sample
  classification (only when routing is enabled);
- per-chunk language detection when metadata says "auto";
- stable blake2b chunk ids over (path, page, chunk_index, course, unit);
- cached passage encoding; single upsert into the unified store + catalog.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from classmate_rag_tpu_torch.chunking import chunk_text
from classmate_rag_tpu_torch.index.catalog import CatalogEntry
from classmate_rag_tpu_torch.index.lexical import tokenize
from classmate_rag_tpu_torch.loaders import infer_doc_type_from_path, load_document_by_type
from classmate_rag_tpu_torch.metadata import DocumentMetadata
from classmate_rag_tpu_torch.metadata.schema import _SUBJECT_ALIASES
from classmate_rag_tpu_torch.pipeline.runtime import Runtime, get_runtime
from classmate_rag_tpu_torch.utils import dedup_text_blocks, detect_lang_tag, stable_chunk_id


@dataclass
class IngestResult:
    path: str
    doc_type: str
    total_pages: int
    total_chunks: int
    upserted: int
    created_at: str
    # The exact ids this run wrote (admin.reingest_paths uses them to
    # delete a shrunk document's stale tail chunks; excluded from the
    # user-facing JSON — potentially thousands of ids for a big PDF).
    chunk_ids: List[str] = field(default_factory=list)


def _chunk_pages_parallel(
    pages: List[Tuple[int, str]],
    *,
    chunk_size: int,
    chunk_overlap: int,
    max_workers: int,
) -> List[Tuple[int, int, str]]:
    """Chunk pages concurrently, then reassign global chunk ids in page
    order (parity with rag/pipeline/rag.py:229-272)."""
    if not pages:
        return []

    def work(page_text):
        page, text = page_text
        return page, chunk_text(
            text, chunk_size=chunk_size, chunk_overlap=chunk_overlap,
            page=page, starting_chunk_id=0,
        )

    if max_workers <= 1 or len(pages) == 1:
        per_page = [work(pt) for pt in pages]
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            per_page = list(pool.map(work, pages))

    out: List[Tuple[int, int, str]] = []
    cid = 0
    for page, chunks in per_page:
        for c in chunks:
            out.append((page, cid, c.text))
            cid += 1
    return out


def _folder_subject_hint(path: Path) -> Optional[str]:
    """Infer the routing subject from any ancestor directory name."""
    for part in reversed(path.parent.parts):
        hint = _SUBJECT_ALIASES.get(part.strip().lower())
        if hint:
            return hint
    return None


def _sanitize_metadata(raw: Dict[str, object]) -> Dict[str, object]:
    """Drop Nones/empties; keep ints as ints; expand tags to tag_* flags.

    Tag flags (not a list) are what the reference persists in both stores
    (rag/pipeline/rag.py:180-216 — its Chroma client takes only scalar
    values), and its admin filters match on them, so a catalog written
    here must carry the same shape to stay reference-interoperable.
    """
    from classmate_rag_tpu_torch.metadata.validation import expand_tag_flags

    out: Dict[str, object] = {}
    for key, val in raw.items():
        if val is None:
            continue
        if key == "tags":
            out.update(expand_tag_flags(val))
            continue
        if isinstance(val, str) and not val.strip():
            continue
        if isinstance(val, (list, tuple)):
            vals = [str(v) for v in val if str(v).strip()]
            if vals:
                out[key] = vals
            continue
        out[key] = val
    return out


def ingest_file(
    *,
    path: str | Path,
    doc_meta: DocumentMetadata,
    runtime: Optional[Runtime] = None,
) -> IngestResult:
    from classmate_rag_tpu_torch.utils.metrics import metrics

    with metrics.timer("ingest"):
        result = _ingest_file(path=path, doc_meta=doc_meta, runtime=runtime)
    metrics.incr("chunks_ingested", result.total_chunks)
    return result


def _ingest_file(
    *,
    path: str | Path,
    doc_meta: DocumentMetadata,
    runtime: Optional[Runtime] = None,
) -> IngestResult:
    rt = runtime or get_runtime()
    cfg = rt.cfg
    p = Path(path).resolve()
    if not p.exists():
        raise FileNotFoundError(f"File not found: {p}")

    doc_type = (
        doc_meta.doc_type.value
        if doc_meta.doc_type and doc_meta.doc_type.value != "other"
        else infer_doc_type_from_path(p)
    )
    pages = load_document_by_type(p, doc_type, enable_ocr=cfg.enable_ocr)
    total_pages = len(pages)

    workers = cfg.ingest_threads or max(2, (os.cpu_count() or 4) // 2)
    chunks = _chunk_pages_parallel(
        pages, chunk_size=cfg.chunk_size, chunk_overlap=cfg.chunk_overlap,
        max_workers=workers,
    )

    if cfg.dedup_chunks and chunks:
        kept_list = dedup_text_blocks(
            [t for (_pg, _cid, t) in chunks],
            jaccard_threshold=cfg.dedup_threshold,
        )
        # One-pass rebuild preserving page order with fresh global ids.
        budget: Dict[str, int] = {}
        for t in kept_list:
            budget[t] = budget.get(t, 0) + 1
        rebuilt: List[Tuple[int, int, str]] = []
        cid = 0
        for page, _old, text in chunks:
            if budget.get(text, 0) > 0:
                budget[text] -= 1
                rebuilt.append((page, cid, text))
                cid += 1
        chunks = rebuilt

    created_at = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")

    # Subject resolution: explicit > folder hint > auto-classification.
    subject: Optional[str] = doc_meta.subject
    if not subject:
        subject = _folder_subject_hint(p)
        if not subject and cfg.enable_routing:
            subject = rt.classifier.classify_chunks(
                [t for (_pg, _cid, t) in chunks]
            ).subject

    base_lang = doc_meta.language.value if doc_meta.language else "auto"

    ids: List[str] = []
    texts: List[str] = []
    metas: List[Dict[str, object]] = []
    tokens_list: List[List[str]] = []
    for page, chunk_id, text in chunks:
        if not text.strip():
            continue
        lang = base_lang
        if lang == "auto" and cfg.enable_language_detection:
            lang = detect_lang_tag(text)
        meta = _sanitize_metadata({
            "course": doc_meta.course,
            "unit": doc_meta.unit,
            "language": lang,
            "doc_type": doc_type,
            "author": doc_meta.author,
            "semester": doc_meta.semester,
            "tags": doc_meta.tags,
            "source_path": str(p),
            "page": int(page),
            "chunk_id": int(chunk_id),
            "created_at": created_at,
            "subject": subject,
        })
        cid = stable_chunk_id(
            source_path=p, page=int(page), chunk_index=int(chunk_id),
            course=doc_meta.course, unit=doc_meta.unit,
        )
        ids.append(cid)
        texts.append(text)
        metas.append(meta)
        tokens_list.append(tokenize(text, meta.get("language")))

    if not ids:
        return IngestResult(
            path=str(p), doc_type=doc_type, total_pages=total_pages,
            total_chunks=0, upserted=0, created_at=created_at,
        )

    embeddings = rt.embedder.encode_passages(texts)
    rt.store.upsert(ids, embeddings, tokens_list, metas)
    for i, cid in enumerate(ids):
        rt.catalog.upsert(CatalogEntry(
            id=cid, text=texts[i], tokens=tokens_list[i], metadata=metas[i],
        ))
    rt.persist()

    return IngestResult(
        path=str(p), doc_type=doc_type, total_pages=total_pages,
        total_chunks=len(ids), upserted=len(ids), created_at=created_at,
        chunk_ids=list(ids),
    )
