"""Decompose a fresh process's time to its first answer, at serving
scale.

Runs against a persisted product index (``INDEX_DIR``/``BM25_DIR``/
``DENSE_DIR``, e.g. built by ``build_product_index``) and times every
stage a fresh deployment pays before its first answer, then decomposes
an /add the way the bench's product child runs one. Each stage ends
with a synchronize of the card (JAX's ``block_until_ready``). In place
of JAX's compilation cache, ``kernel_load`` comes first: the kernels
loaded from ``ops/build/``, or built there with nvcc if missing.

    INDEX_DIR=/tmp/prod1m BM25_DIR=/tmp/prod1m/bm25 \\
    DENSE_DIR=/tmp/prod1m/dense EMBEDDING_BACKEND=hash \\
    RUNTIME_PRECOMPILE=off \\
    python -m classmate_rag_tpu_torch.tools.probe_cold_start [--device cpu]

Its point is a fresh process: run it as one (``main``). Prints each
stage as it ends, then the report as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from classmate_rag_tpu_torch.device import resolve_device, synchronize


def counters(store) -> dict:
    return {"device_full_uploads": store.device_full_uploads,
            "split_full_builds": store.split_full_builds,
            "split_snapshot_restores": store.split_snapshot_restores,
            "df_full_builds": store.df_full_builds}


def kernel_load() -> dict:
    """Every kernel library loaded (``ops/_build.load``), built first
    where ``ops/build/`` lacks it; which ones were built."""
    from classmate_rag_tpu_torch.ops import _build

    missing = [n for n in _build.sources() if not _build._lib_path(n).exists()]
    _build.build_all()
    for name in _build.sources():
        _build.load(name)
    return {"built": missing, "loaded": _build.sources()}


def probe(device) -> dict:
    """The stages, in order; the report."""
    from classmate_rag_tpu_torch.loaders import load_document_by_type
    from classmate_rag_tpu_torch.metadata import DocumentMetadata
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.pipeline.ingest import ingest_file
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    dev = resolve_device(device)
    report: dict = {"device": str(dev)}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        report[name] = round(time.perf_counter() - t0, 4)
        print(f"{name}: {report[name]}s", flush=True)
        return out

    if dev.type == "cuda":
        report["kernels"] = stage("kernel_load", kernel_load)
    else:
        report["kernel_load"] = None        # no kernel runs on the CPU
    rt = stage("runtime_load", lambda: get_runtime(reload=True, device=dev))
    report["load_split"] = rt.load_timings
    report["n_rows"] = rt.store.n_rows
    report["warmup_thread"] = rt.warmup_thread is not None
    store = rt.store

    # Device placement, piece by piece (what the first query bundles).
    def link_probe():
        a = np.zeros((1 << 29,), np.uint16)     # 1 GiB, pageable
        torch.from_numpy(a).to(dev, copy=True)

    def sync_device():
        with store._sync_lock:
            store._sync_device_locked()

    stage("upload_link_probe_1gb", link_probe)
    stage("sync_device_upload", sync_device)
    stage("sync_split_upload", store._sync_split)
    stage("df_upload", lambda: store._df_device(store.vocab_pad))
    stage("bias", lambda: store._mask_bias(None))

    filters = DocumentMetadata()

    def ask(q):
        return lambda: ask_question(question=q, filters=filters, top_k=8,
                                    runtime=rt)

    stage("first_ask", ask("what about w3 w17 w200 w1100"))
    stage("second_ask", ask("what about w5 w90 w33 w408"))

    # ---- the /add, decomposed ----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        doc = Path(tmp) / "probe_doc.txt"
        doc.write_text("A freshly added probe document about w1 w2 w3. "
                       "It provides additional context for the add probe.",
                       encoding="utf-8")
        stage("add_load_chunk",
              lambda: load_document_by_type(doc, "txt", enable_ocr=False))
        stage("add_classifier_first",
              lambda: rt.classifier.classify_chunks(["probe text about w1"]))
        stage("add_encode_passages",
              lambda: rt.embedder.encode_passages(["probe text about w1 w2"]))
        stage("add_ingest_file", lambda: ingest_file(
            path=doc, doc_meta=DocumentMetadata(course="bench"),
            runtime=rt))
        stage("persist_after_add", rt.persist)
    stage("ask_after_add_first", ask("what about w9 w12 w77 w302"))
    stage("ask_after_add_second", ask("what about w8 w13 w76 w301"))
    report["counters"] = counters(store)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
