"""Decompose the first query after a 1-row mutation, at serving scale.

Builds the bench corpus into an ``IndexStore(768, ..., slab_rows=4096,
terms_per_chunk=WIDTH)``, answers a warm ask, then runs three trials of
a 1-row upsert, each timing its parts on their own, every part ended by
a synchronize of the card:

  1. the incremental ``_sync_device`` (row scatters: emb, lexical, meta)
  2. the incremental ``_sync_split`` (head column scatter, overlay writes)
  3. the corpus df's upload (host-maintained: a KB vector)
  4. the no-filter mask bias, recomputed
  5. the first ask (``hybrid_topk_batch``, B 1) after the upsert

then the raw [C, N] head-column write (``store.device_col_set``) at the
real head shape, twice. The O(corpus) counters are read before and
after the trials.

    python -m classmate_rag_tpu_torch.tools.probe_mutation_sync \\
        [--rows 1000000] [--width 192] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from classmate_rag_tpu_torch.device import resolve_device, synchronize
from classmate_rag_tpu_torch.tools.probe_cold_start import counters


def run(rows: int, width: int = 192, device=None, corpus=None) -> dict:
    """The probe at ``rows`` chunks (``corpus``: the bench corpus
    ``(docs, emb)`` of that size, built here when None); the report."""
    from classmate_rag_tpu_torch.bench import DIM, build_corpus
    from classmate_rag_tpu_torch.index.store import IndexStore, device_col_set

    dev = resolve_device(device)
    t0 = time.perf_counter()
    docs, emb = corpus or build_corpus(np.random.default_rng(42), rows)
    report = {"rows": rows, "width": width, "device": str(dev),
              "corpus_s": round(time.perf_counter() - t0, 3)}
    tmp = tempfile.TemporaryDirectory(prefix="probe_idx_")
    store = IndexStore(DIM, tmp.name, slab_rows=4096, terms_per_chunk=width,
                       device=dev)
    ids = [f"c{i}" for i in range(rows)]
    t0 = time.perf_counter()
    for s in range(0, rows, 8192):
        e = min(s + 8192, rows)
        store.upsert(ids[s:e], emb[s:e], docs[s:e], [{} for _ in range(s, e)])
    report["index_s"] = round(time.perf_counter() - t0, 3)

    qv = emb[:1] + 0.01
    qv = (qv / np.linalg.norm(qv)).astype(np.float32)
    qterms = [docs[0][:5]]

    def ask():
        return store.hybrid_topk_batch(qv, qterms, None, top_k=8).rows.cpu()

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        return round((time.perf_counter() - t0) * 1e3, 4)

    report["first_ask_ms"] = timed(ask)       # uploads + split layout
    report["steady_ask_ms"] = timed(ask)
    report["counters_before"] = counters(store)

    def mutate(i):
        store.upsert([ids[i]], emb[i: i + 1] * -1.0,
                     [docs[i][:30] + ["zznew", "zzterm"]], [{}])

    def sync_device():
        with store._sync_lock:
            store._sync_device_locked()

    def bias():
        store._nofilter_bias = None
        store._mask_bias(None)

    for trial in range(3):
        mutate(trial + 5)
        row = {
            "trial": trial,
            "sync_device_ms": timed(sync_device),
            "sync_split_ms": timed(store._sync_split),
            "df_recompute_ms": timed(
                lambda: store._df_device(store.vocab_pad)),
            "bias_recompute_ms": timed(bias),
            "ask_after_ms": timed(ask),
        }
        print(json.dumps(row), flush=True)
        report[f"trial{trial}"] = row
    report["counters_after"] = counters(store)

    # The raw [C, N] column write at the real head shape.
    head = store._split["tf_head"]
    report["tf_head_shape"] = list(head.shape)
    vals = np.zeros((head.shape[0], 1), np.uint8)
    report["col_set_ms"] = timed(lambda: device_col_set(head, [7], vals))
    report["col_set_again_ms"] = timed(lambda: device_col_set(head, [9], vals))
    del store
    tmp.cleanup()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.rows, args.width, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
