"""One run of one cell of the benchmark of the PyTorch/CUDA port:

    python3 -m rag_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The harness here is the same for every cell; what the cell runs is
its kind's (``kinds/<kind>.py``, named by the configuration): the kind
makes the inputs from the seed and builds and warms the program's state
over every batch of the pool (set-up ends there), then drives the
traffic's loop for ``--seconds``. With ``--trace 0`` the run reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones from a
torch.profiler trace of the window and the window's own host spans.
After the window, with the program's state freed, the kind holds the
window's outputs against its plain reference. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the line's last key.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List  # noqa: E402

_CHECKOUT = Path(__file__).resolve().parents[1]
# Kernel and build caches at fixed paths inside the checkout; a library
# the port uses must not pull in JAX through its Flax hooks.
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CHECKOUT / ".bench_cache" / "torch")
os.environ["TRITON_CACHE_DIR"] = str(_CHECKOUT / ".bench_cache" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# One intra-op thread: the host's share of a batch is one thread's work,
# and idle OpenMP and MKL workers spinning beside it slowed it and spread
# the runs (TREC-COVID cell on an H100 host of 8 cores: 6,025-6,527
# queries/s with 8 threads, 6,421-6,718 with 1).
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402

from rag_bench import spec  # noqa: E402
from rag_bench.trace import (  # noqa: E402
    Trace,
    device_ops,
    gaps,
    host_offset_ns,
    is_kernel,
    union_ns,
)
from rag_bench.work import peaks  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "classmate_rag_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``classmate_rag_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context(SimpleNamespace):
    """What a metric reader reads (``metrics/<name>.py``): the window
    (``window.py``), ``setup_s``, the device ``trace`` (None untraced) and
    the card's ``peak`` (bf16 FLOP/s, bytes/s; None for a card not in
    ``work.py``'s table), and the values of the cell's kind as further
    attributes (``hybrid``: ``dim``, ``scope_rows``, ``postings``)."""

    def __init__(self, window, setup_s: float, trace, peak, **values):
        super().__init__(window=window, setup_s=setup_s, trace=trace,
                         peak=peak, **values)


def read_metric(name: str, ctx: Context):
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "rag_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def _finite(x: float) -> float:
    return 1e300 if math.isinf(x) or math.isnan(x) else x


def breakdown(tr: Trace, window) -> Dict[str, list]:
    """The ten device operations that took most time, and the idle
    gaps by what the host was doing (inside the store call, waiting in
    the fetch, between batches)."""
    by_name: Dict[str, float] = {}
    for n, s, e in tr.ops:
        key = n if len(n) <= 96 else n[:93] + "..."
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    marks = []
    for x in window.served:
        off = tr.host_offset_ns
        marks += [(x.t_call + off, "store call"),
                  (x.t_return + off, "fetch"),
                  (x.t_fetched + off, "between batches")]
    starts = np.array([m[0] for m in marks], np.int64)
    total: Dict[str, float] = {}
    longest: Dict[str, float] = {}
    for a, b in gaps(tr.ops):
        i = int(np.searchsorted(starts, (a + b) // 2, side="right")) - 1
        label = marks[i][1] if i >= 0 else "before the first batch"
        total[label] = total.get(label, 0.0) + (b - a) / 1e9
        longest[label] = max(longest.get(label, 0.0), (b - a) / 1e9)
    idle = sorted(total.items(), key=lambda kv: -kv[1])
    idle += sorted(((f"longest, {k}", v) for k, v in longest.items()),
                   key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle[:10]]}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> Dict:
    """One run of ``cell`` on ``device``; the result line's object (and,
    with ``control``, the control's readings under ``control`` where the
    cell's kind has a control)."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = spec.load_kind(cell.kind)
    loop = importlib.import_module(f"rag_bench.loops.{cell.traffic['loop']}")

    phases = {"start": time.perf_counter() - t_start}

    def mark(phase: str) -> None:
        phases[phase] = time.perf_counter() - t_start

    run = kind.Run(cell, seed, dev)
    mark("inputs")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    try:
        run.build(mark)
        if cuda:
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start
        phases["warm_up"] = setup_s
        if trace and cuda:
            from torch.profiler import ProfilerActivity, profile

            offset = host_offset_ns()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                window = run.drive(loop, seconds)
                torch.cuda.synchronize(dev)
        else:
            window = run.drive(loop, seconds)
        memory_peak = (int(torch.cuda.max_memory_allocated(dev)) if cuda
                       else 0)
    finally:
        run.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    tr = None
    if prof is not None:
        tr = Trace(device_ops(prof), offset)
        del prof

    # Correctness, with the program's state freed.
    t_check = time.perf_counter()
    correct, checks, out_control = run.check(
        window, control and kind.CONTROL is not None)

    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = Context(window, setup_s, tr, peaks(card), **run.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = read_metric(m["name"], ctx)
        if v is None:
            print(f"rag_bench: {m['name']}: nothing to read",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_out = {"platform": "gpu" if cuda else "cpu", "kind": card,
                  "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_out}
    if tr is not None and tr.ops:
        device_out["busy_s"] = union_ns(tr.ops) / 1e9
        device_out["window_s"] = window.seconds
        result["breakdown"] = breakdown(tr, window)
    result["info"] = {
        "batches": len(window.served), "window_s": window.seconds,
        "setup_s": setup_s, "setup_phases_end_s": phases, **run.info,
        "check_s": time.perf_counter() - t_check,
        "kernels_traced": (sum(is_kernel(o[0]) for o in tr.ops)
                           if tr is not None else None),
    }
    if tr is not None and tr.ops:
        counts: Dict[str, int] = {}
        for n, _s, _e in tr.ops:
            counts[n[:80]] = counts.get(n[:80], 0) + 1
        result["info"]["launches_per_batch"] = [
            [n, c / len(window.served)]
            for n, c in sorted(counts.items(), key=lambda kv: -kv[1])[:12]]
    if out_control is not None:
        result["control"] = {k: _finite(v) for k, v in out_control.items()}
    result["checks"] = {n: {"value": _finite(c["value"]),
                            "limit": c["limit"]} for n, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"rag_bench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", _T0)
    bad = forbidden_modules()
    if bad:
        print(f"rag_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    info = result.pop("info")
    print("rag_bench: " + json.dumps(info), file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
