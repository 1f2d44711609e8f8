"""The dense scan's routes side by side.

At ``BENCH_CHUNKS`` rows (d 768, ``BENCH_BATCH`` queries, k 24) times:

  raw_matmul_bf16   the bf16 [Q, d] x [d, N] product alone (library)
  raw_matmul_int8   the int8 product alone (``ops/quant.int8_scores``:
                    ``torch._int_mm`` on the card)
  library_topk      the bf16 product + ``torch.topk`` (the library route)
  int8_rescore      ``ops/quant.topk_int8_rescore`` (int8 stage 1, bf16
                    rescore of a 4k pool)
  topk_scan         ``ops/topk.masked_topk``: the scan and merge kernels

each with the bytes it must read (the corpus matrix once, at its dtype),
their bound at the card's memory rate and the rate reached; then the
int8 route's recall against the scan's exact top-k. Each time is
``utils.profiling.held_stream_ms``'s.

    BENCH_CHUNKS=200000 python -m \\
        classmate_rag_tpu_torch.tools.bench_scan [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from classmate_rag_tpu_torch.device import resolve_device

N = int(os.getenv("BENCH_CHUNKS", "200000"))
D = 768
Q = int(os.getenv("BENCH_BATCH", "256"))
K = 24
ITERS = 8


def run(emb: np.ndarray, queries: np.ndarray, device=None,
        iters: int = ITERS, k: int = K) -> dict:
    """The routes over ``emb`` [N, d] and ``queries`` [Q, d] (f32 or
    f16 host arrays) on ``device``; the report."""
    from classmate_rag_tpu_torch.ops.quant import (
        int8_scores, quantize_queries, quantize_rows, topk_int8_rescore,
    )
    from classmate_rag_tpu_torch.ops.topk import masked_topk
    from classmate_rag_tpu_torch.utils.profiling import (
        _detect_chip, device_peaks, held_stream_ms,
    )

    dev = resolve_device(device)
    n, d = emb.shape
    e8, sc = quantize_rows(np.asarray(emb, np.float32))
    bf16 = torch.from_numpy(np.asarray(emb, np.float32)).to(
        dev).to(torch.bfloat16)
    i8 = torch.from_numpy(e8).to(dev)
    scales = torch.from_numpy(sc).to(dev)
    bias = torch.zeros(n, dtype=torch.float32, device=dev)
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    q_i8, _ = quantize_queries(q)
    routes = {
        "raw_matmul_bf16": (lambda: q.to(torch.bfloat16) @ bf16.T, 2),
        "raw_matmul_int8": (lambda: int8_scores(q_i8, i8), 1),
        "library_topk": (lambda: torch.topk(
            (q.to(torch.bfloat16) @ bf16.T).float() + bias, k), 2),
        "int8_rescore": (lambda: topk_int8_rescore(
            i8, scales, bf16, q, bias, k, rescore_pool=4 * k), 1),
        "topk_scan": (lambda: masked_topk(bf16, q, bias, k), 2),
    }
    chip = _detect_chip() if dev.type == "cuda" else "cpu"
    gbs = device_peaks(chip)[1]
    out = {"n": n, "d": d, "q": len(queries), "k": k, "device": str(dev),
           "chip": chip, "bf16_matrix_bytes": n * d * 2,
           "int8_matrix_bytes": n * d, "routes": {}}
    for name, (fn, width) in routes.items():
        t = held_stream_ms(fn, iters, dev)
        ms = t.get("profiler_ms", t["ms"])
        nbytes = n * d * width
        out["routes"][name] = {
            "ms": ms, "held": t["held"], "bytes": nbytes,
            "bound_ms": nbytes / (gbs * 1e9) * 1e3,
            "gb_per_s": nbytes / (ms / 1e3) / 1e9}
    r = out["routes"]
    out["int8_vs_bf16_raw_speedup"] = (r["raw_matmul_bf16"]["ms"]
                                       / r["raw_matmul_int8"]["ms"])
    out["int8_rescore_vs_library_topk"] = (r["library_topk"]["ms"]
                                           / r["int8_rescore"]["ms"])
    out["topk_scan_vs_library_topk"] = (r["library_topk"]["ms"]
                                        / r["topk_scan"]["ms"])
    exact = masked_topk(bf16, q, bias, k)[1].cpu().numpy()
    approx = topk_int8_rescore(i8, scales, bf16, q, bias, k,
                               rescore_pool=4 * k)[1].cpu().numpy()
    out["int8_recall_vs_scan"] = float(np.mean([
        len(set(exact[j]) & set(approx[j])) / k for j in range(len(q))]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    queries = emb[:Q] + 0.01
    print(json.dumps(run(emb, queries, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
