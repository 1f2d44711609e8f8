"""Query latency harness: per-ask wall time, mean and p95.

    python -m classmate_rag_tpu_torch.tools.bench_ask \\
        "question one" "question two" --n 20 [--retrieval-only] \\
        [--device cpu]

``--retrieval-only`` times the preview (retrieval alone) instead of the
whole ask; the ``--warmup`` asks before the timed ones are not timed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from classmate_rag_tpu_torch.device import resolve_device


def run(questions, n: int = 20, retrieval_only: bool = False,
        warmup: int = 1, device=None, runtime=None) -> dict:
    """``n`` asks (or previews) cycling through ``questions`` on
    ``runtime`` (default: ``get_runtime`` on ``device``); the report."""
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline import (
        ask_question, get_runtime, retrieve_preview,
    )

    rt = runtime or get_runtime(device=resolve_device(device))
    meta = normalize_cli_metadata()
    fn = retrieve_preview if retrieval_only else ask_question

    def one(i):
        fn(question=questions[i % len(questions)], filters=meta, top_k=8,
           runtime=rt)

    for i in range(warmup):
        one(i)
    times_ms = []
    for i in range(n):
        t0 = time.perf_counter()
        one(i)
        times_ms.append((time.perf_counter() - t0) * 1e3)
    s = sorted(times_ms)
    return {
        "n": n,
        "retrieval_only": bool(retrieval_only),
        "per_ask_ms": [round(t, 4) for t in times_ms],
        "mean_ms": round(statistics.mean(times_ms), 4),
        "p95_ms": round(s[min(len(s) - 1, int(0.95 * len(s)))], 4),
        "device": str(rt.store.device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("questions", nargs="+", help="questions to ask")
    ap.add_argument("--n", type=int, default=20, help="total asks")
    ap.add_argument("--retrieval-only", action="store_true",
                    help="time the preview (retrieval) instead of the ask")
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed asks first")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.questions, args.n, args.retrieval_only,
                         args.warmup, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
