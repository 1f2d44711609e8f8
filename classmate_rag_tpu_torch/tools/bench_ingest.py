"""Ingest throughput harness: chunks/second over files x repeats.

Ingests the given files ``--repeat`` times through the port's full
pipeline (``ingest_file``: load, chunk, classify, encode with the
embedder the configuration selects, upsert, persist) and reports
chunks/s.

    python -m classmate_rag_tpu_torch.tools.bench_ingest \\
        file1.pdf file2.md --repeat 3 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from classmate_rag_tpu_torch.device import resolve_device


def run(files, repeat: int = 1, course: str = "bench", device=None,
        runtime=None):
    """Ingest ``files`` ``repeat`` times into ``runtime`` (default:
    ``get_runtime`` on ``device``); (report, the IngestResults)."""
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline import get_runtime, ingest_file

    rt = runtime or get_runtime(device=resolve_device(device))
    meta = normalize_cli_metadata(course=course)
    results = []
    t0 = time.perf_counter()
    for _ in range(repeat):
        for f in files:
            results.append(ingest_file(path=f, doc_meta=meta, runtime=rt))
    elapsed = time.perf_counter() - t0
    total = sum(r.total_chunks for r in results)
    return {
        "files": len(files),
        "repeat": repeat,
        "total_chunks": total,
        "seconds": round(elapsed, 4),
        "chunks_per_sec": round(total / elapsed, 3) if elapsed else None,
        "embedder": getattr(rt.embedder, "model_name", None),
        "device": str(rt.store.device),
    }, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="+", help="documents to ingest")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--course", type=str, default="bench")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    out, _ = run(args.files, args.repeat, args.course, args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
