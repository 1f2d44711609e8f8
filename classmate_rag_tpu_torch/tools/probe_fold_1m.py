"""Measure the catalog's journal fold at serving scale, and decompose a
persist.

1. One small upsert, then the pieces of a save: the pending flush, the
   sidecar write, the fingerprint.
2. The compaction thresholds forced to 0 (``_COMPACT_MIN_BYTES``,
   ``_COMPACT_RATIO``), so the next ``save()`` starts the background
   fold: the save's own time (it must stay O(delta)), a read during the
   fold, the fold's duration, then the journal's size, the fold alias
   and the entries of the catalog loaded anew.

The two module constants are restored before ``run`` returns. The
probe runs on the host alone, so it takes no ``--device``.

    INDEX_DIR=/tmp/prod1m BM25_DIR=/tmp/prod1m/bm25 \\
    python -m classmate_rag_tpu_torch.tools.probe_fold_1m
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def run(bm25_dir) -> dict:
    """The probe on the catalog in ``bm25_dir`` (it writes two entries,
    ``probe-fold-0`` and ``probe-fold-1``, and folds the journal)."""
    import classmate_rag_tpu_torch.index.catalog as cat_mod
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry

    report = {}
    t0 = time.perf_counter()
    cat = Catalog.load_or_create(bm25_dir)
    report["catalog_load_s"] = round(time.perf_counter() - t0, 4)
    report["entries_before"] = len(cat)
    print(f"catalog load {report['catalog_load_s']}s n={len(cat)}",
          flush=True)

    # A persist, decomposed: one tiny upsert, then the save's pieces.
    cat.upsert(CatalogEntry("probe-fold-0", "probe text", ["probe"], {}))
    t0 = time.perf_counter()
    with cat._lock:
        cat._flush_pending_locked()
    report["flush_pending_s"] = round(time.perf_counter() - t0, 4)
    t0 = time.perf_counter()
    cat._save_sidecar()
    report["save_sidecar_s"] = round(time.perf_counter() - t0, 4)
    t0 = time.perf_counter()
    cat.fingerprint()
    report["fingerprint_s"] = round(time.perf_counter() - t0, 4)

    # The background fold, forced.
    saved = (cat_mod._COMPACT_MIN_BYTES, cat_mod._COMPACT_RATIO)
    cat_mod._COMPACT_MIN_BYTES, cat_mod._COMPACT_RATIO = 0, 0.0
    try:
        cat.upsert(CatalogEntry("probe-fold-1", "probe text 2", ["probe"],
                                {}))
        t0 = time.perf_counter()
        cat.save()
        report["save_tripping_ratio_s"] = round(time.perf_counter() - t0, 4)
        t0 = time.perf_counter()
        # Reads keep working against the old files during the fold.
        if cat.get("probe-fold-1") is None:
            raise RuntimeError("probe-fold-1 unreadable during the fold")
        report["get_during_fold_s"] = round(time.perf_counter() - t0, 5)
        cat.join_fold(timeout=1800)
        report["fold_duration_s"] = round(time.perf_counter() - t0, 4)
    finally:
        cat_mod._COMPACT_MIN_BYTES, cat_mod._COMPACT_RATIO = saved
    jp = Path(cat.journal_path)
    report["journal_after"] = jp.stat().st_size if jp.exists() else 0
    report["fold_alias"] = cat.fold_alias is not None
    fresh = Catalog.load_or_create(bm25_dir)
    report["post_fold_entries"] = len(fresh)
    if fresh.get("probe-fold-1") is None:
        raise RuntimeError("probe-fold-1 lost across the fold")
    return report


def main(argv=None) -> int:
    from classmate_rag_tpu_torch.config import load_config

    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    print(json.dumps(run(load_config().bm25_dir)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
