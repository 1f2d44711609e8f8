"""Separate kernel build, kernel load and the first call of the fused
step, against a persisted index.

The port's counterpart of the JAX tool's trace / compile (cache) /
first execute: the runtime's load, every upload (device tensors, split
layout, df, bias), a cold nvcc build of every kernel into a temporary
build directory (``kernel_build_s``: what a checkout without
``ops/build/`` pays) and the load of the cached libraries
(``kernel_load_s``), one small CUDA launch's first and second call (the
JAX tool's trivial program), then ``hybrid_query_step_split_packed``'s
first and second call on the uploaded inputs. Each time ends with a
synchronize (or the host fetch of the rows).

    INDEX_DIR=/tmp/prod1m BM25_DIR=/tmp/prod1m/bm25 \\
    DENSE_DIR=/tmp/prod1m/dense EMBEDDING_BACKEND=hash \\
    RUNTIME_PRECOMPILE=off \\
    python -m classmate_rag_tpu_torch.tools.probe_first_dispatch
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from classmate_rag_tpu_torch.device import resolve_device, synchronize


def kernel_build_and_load() -> dict:
    """Seconds of a cold build of every kernel (into a temporary build
    directory, so ``ops/build/`` is left as it is) and of loading the
    libraries of ``ops/build/`` (built there first where missing)."""
    from classmate_rag_tpu_torch.ops import _build

    saved = _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        _build.BUILD_DIR = Path(tmp)
        try:
            t0 = time.perf_counter()
            _build.build_all()
            build_s = time.perf_counter() - t0
        finally:
            _build.BUILD_DIR = saved
    _build.build_all()
    t0 = time.perf_counter()
    for name in _build.sources():
        _build.load(name)
    return {"kernel_build_s": round(build_s, 4),
            "kernel_load_s": round(time.perf_counter() - t0, 4),
            "kernels": _build.sources()}


def probe(device=None, runtime=None) -> dict:
    """The stages against ``runtime`` (default: ``get_runtime(reload=
    True)`` on ``device``); the report."""
    import torch

    from classmate_rag_tpu_torch.ops.hybrid_step import (
        hybrid_query_step_split_packed,
    )
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    report: dict = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        report[name] = round(time.perf_counter() - t0, 4)
        print(f"{name}: {report[name]}s", flush=True)
        return out

    dev = resolve_device(device if runtime is None else runtime.store.device)
    report["device"] = str(dev)
    rt = runtime or timed("load_s", lambda: get_runtime(reload=True,
                                                        device=dev))
    store = rt.store
    report["n_rows"] = store.n_rows

    def uploads():
        with store._sync_lock:
            store._sync_device_locked()
        store._sync_split()
        store._df_device(store.vocab_pad)
        store._mask_bias(None)

    timed("all_uploads_s", uploads)
    if dev.type == "cuda":
        report.update(kernel_build_and_load())
    else:
        report["kernel_build_s"] = report["kernel_load_s"] = None

    # One small launch: its first call, then its second.
    qv = torch.zeros((1, store.dim), dtype=torch.float32, device=dev)
    emb = store._sync_device()["emb"]

    def trivial():
        return (emb[:4096].float() @ qv.T).sum()

    timed("trivial_first_call_s", trivial)
    timed("trivial_second_call_s", trivial)

    # The real fused step on the uploaded inputs.
    args, kw = store.hybrid_step_inputs(
        np.zeros((1, store.dim), np.float32),
        [["w3", "w17", "w200", "w1100"]], None)
    timed("step_first_call_s",
          lambda: hybrid_query_step_split_packed(*args, **kw).rows.cpu())
    timed("step_second_call_s",
          lambda: hybrid_query_step_split_packed(*args, **kw).rows.cpu())
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
