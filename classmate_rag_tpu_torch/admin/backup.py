"""Backup / restore / vacuum / re-embed (port of the JAX package's
``admin/backup.py``).

Dump format parity with the reference (rag/admin/backup.py:74-124): one
JSON object per chunk — ``{id, text, metadata, text_sha1, embedding_model,
embedding_sha1}`` — where ``embedding_sha1`` is the sha1 of the re-encoded
float32 vector bytes, so dumps are integrity-checkable and interchangeable
between the stacks (bit-equal between the packages with the hashing
embedder; an E5 vector on the card agrees with the JAX package's only to
a float tolerance, and so does not share its sha1). Differences from the
reference, as in the JAX package:

- ``vacuum`` actually compacts: tombstoned rows are reclaimed from the
  device store and the catalog is rewritten atomically;
- ``rebuild_embeddings`` re-encodes straight from the in-memory catalog in
  device-sized batches, into a store on the runtime's device, and wraps
  the new store in a new corpus-sharded engine where the runtime had one.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from classmate_rag_tpu_torch.index.catalog import CatalogEntry
from classmate_rag_tpu_torch.index.lexical import tokenize
from classmate_rag_tpu_torch.pipeline.runtime import Runtime, get_runtime


def _sha1_bytes(b: bytes) -> str:
    return hashlib.sha1(b).hexdigest()


def _sha1_text(s: str) -> str:
    return _sha1_bytes((s or "").encode("utf-8", "ignore"))


def _batched(items: List, n: int) -> Iterator[List]:
    n = n if n > 0 else 256
    for i in range(0, len(items), n):
        yield items[i : i + n]


def dump_index(
    out_path: str | Path,
    *,
    include_embedding_checksum: bool = True,
    batch_size: int = 256,
    runtime: Optional[Runtime] = None,
) -> int:
    rt = runtime or get_runtime()
    model_name = getattr(rt.embedder, "model_name", "unknown-model")
    entries = [
        (e.id, e.text, e.metadata)
        for e in rt.catalog.entries()
        if e.id and e.text
    ]
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    if not entries:
        out.write_text("", encoding="utf-8")
        return 0

    total = 0
    with out.open("w", encoding="utf-8") as w:
        for batch in _batched(entries, batch_size):
            vecs = None
            if include_embedding_checksum:
                vecs = rt.embedder.encode_passages([t for (_i, t, _m) in batch])
            for j, (cid, text, meta) in enumerate(batch):
                rec = {
                    "id": cid,
                    "text": text,
                    "metadata": meta,
                    "text_sha1": _sha1_text(text),
                    "embedding_model": model_name,
                    "embedding_sha1": (
                        _sha1_bytes(np.asarray(vecs[j], dtype=np.float32).tobytes())
                        if vecs is not None else None
                    ),
                }
                w.write(json.dumps(rec, ensure_ascii=False) + "\n")
                total += 1
    return total


def restore_dump(
    dump_path: str | Path,
    *,
    batch_size: int = 256,
    runtime: Optional[Runtime] = None,
) -> int:
    rt = runtime or get_runtime()
    p = Path(dump_path).expanduser().resolve()
    if not p.exists():
        raise FileNotFoundError(f"Dump not found: {p}")

    items: List[Tuple[str, str, Dict[str, object]]] = []
    for line in p.read_text(encoding="utf-8", errors="ignore").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        cid = str(rec.get("id") or "")
        text = str(rec.get("text") or "")
        if cid and text:
            items.append((cid, text, dict(rec.get("metadata") or {})))

    restored = 0
    for batch in _batched(items, batch_size):
        ids = [c for (c, _t, _m) in batch]
        texts = [t for (_c, t, _m) in batch]
        metas = [m for (_c, _t, m) in batch]
        tokens = [tokenize(t, m.get("language")) for t, m in zip(texts, metas)]
        embeddings = rt.embedder.encode_passages(texts)
        rt.store.upsert(ids, embeddings, tokens, metas)
        for i, cid in enumerate(ids):
            rt.catalog.upsert(CatalogEntry(cid, texts[i], tokens[i], metas[i]))
        restored += len(batch)
    rt.persist()
    return restored


def vacuum_indexes(runtime: Optional[Runtime] = None) -> Dict[str, str]:
    rt = runtime or get_runtime()
    reclaimed = rt.store.compact()
    rt.persist()
    return {
        "catalog": "rewritten",
        "dense": f"compacted ({reclaimed} tombstoned rows reclaimed)",
    }


def _looks_like_checkpoint(path_str: str) -> bool:
    """True when the 'model name' is actually a fine-tune checkpoint dir
    (``training.train_encoder`` output: step_N subdirs /
    encoder_config.json)."""
    p = Path(path_str).expanduser()
    if not p.is_dir():
        return False
    if (p / "encoder_config.json").exists():
        return True
    if p.name.startswith("step_") and (p.parent / "encoder_config.json").exists():
        return True
    return any(
        c.is_dir() and c.name.startswith("step_") for c in p.iterdir()
    )


def rebuild_embeddings(
    new_model_name: str,
    *,
    batch_size: int = 256,
    runtime: Optional[Runtime] = None,
) -> Dict[str, object]:
    """Re-encode every chunk with a new embedding model.

    Rebuilds the dense store at the new model's dimensionality, on the
    runtime's device; the lexical side is untouched (parity: BM25 kept
    as-is, rag/admin/backup.py:205-236). ``new_model_name`` may also be a
    fine-tune checkpoint directory of the port — the migration path for
    its own training output (its embedder's name carries
    ``@ckpt-step_N-<digest>``, so the embedding cache never serves the
    old model's vectors).
    """
    from classmate_rag_tpu_torch.config import embedding_config_of
    from classmate_rag_tpu_torch.embeddings import get_caching_embedder
    from classmate_rag_tpu_torch.index.store import IndexStore

    rt = runtime or get_runtime()
    # A background warm-up (get_runtime starts one at serving scale)
    # places the old store from the directory the new one is saved into:
    # let it finish before the rebuild touches either.
    if rt.warmup_thread is not None:
        rt.warmup_thread.join()
    entries = [e for e in rt.catalog.entries() if e.id and e.text]
    if not entries:
        return {"updated": 0, "model": new_model_name}

    dev = rt.store.device
    ecfg = embedding_config_of(rt.cfg)
    if _looks_like_checkpoint(new_model_name):
        embedder = get_caching_embedder(ecfg, checkpoint=new_model_name,
                                        device=dev)
    else:
        embedder = get_caching_embedder(ecfg, model_name=new_model_name,
                                        device=dev)
    new_dim = embedder.dim or rt.store.dim
    new_store = IndexStore(
        dim=new_dim, directory=rt.store.directory,
        slab_rows=rt.store.slab_rows, terms_per_chunk=rt.store.term_width,
        rescore=rt.store.rescore, rescore_pool=rt.store.rescore_pool,
        select=rt.store.select, device=dev,
    )
    updated = 0
    for batch in _batched(entries, batch_size):
        ids = [e.id for e in batch]
        texts = [e.text for e in batch]
        embeddings = embedder.encode_passages(texts)
        new_store.upsert(
            ids, embeddings, [e.tokens for e in batch],
            [e.metadata for e in batch],
        )
        updated += len(batch)
    rt.catalog.save()
    # Provenance stamp: every vector in the rebuilt store came from THIS
    # embedder — record it so the runtime's feature-space guard can
    # compare on the next cold start.
    new_store.embedding_model = getattr(embedder, "model_name", None)
    new_store.save(catalog_fingerprint=rt.catalog.fingerprint())
    # Swap the runtime onto the new store and embedder, the sharded
    # engine included: it wraps one store instance and would otherwise
    # keep serving the pre-rebuild embeddings.
    rt.store = new_store
    rt.embedder = embedder
    rt.retriever.store = new_store
    rt.retriever.embedder = embedder
    if rt.sharded is not None:
        from classmate_rag_tpu_torch.pipeline.runtime import (
            build_sharded_index,
        )

        rt.sharded = build_sharded_index(rt.cfg, new_store)
        rt.retriever.sharded = rt.sharded
    return {"updated": updated, "model": new_model_name}
