"""HTTP serving load harness: sustained /ask QPS through the port's
server.

Measures the product path end to end: HTTP parse → MicroBatcher
aggregation → the fused retrieval under the read-write device lock →
the generation tail → the JSON reply. Closed-loop clients (one thread
each) send /ask; the QPS is requests answered inside the counting
window over its wall time, after a warm-up. ``--mutate N`` fires up
to N /add + /delete pairs from the middle third of the window on (the
storm gets max(window / 3, 60 s) for its rounds, then the window runs
to its end; a round in flight then finishes after it), reports the
latencies before, during and after the storm, and then checks that the
served index is still right: every round that ran answered 200, and
the rows of the harness's questions equal those of the same index
loaded anew from disk on the same device.

    python -m classmate_rag_tpu_torch.tools.bench_serve \\
        --clients 32 --seconds 10 --port 0 [--mutate 8] [--device cpu]

Run with ``INDEX_DIR``/``BM25_DIR``/``DENSE_DIR`` pointing at a built
index (``build_product_index``), or let it index a synthetic corpus with
``--synthetic N``. ``--port 0`` binds a free port.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from classmate_rag_tpu_torch.device import resolve_device

QUESTIONS = [
    "w12 w40 w7 what is the rate", "w3 w99 how does w41 relate",
    "w5 w1 w2 compute the measure", "w77 w21 bound of the limit",
]


def _build_synthetic(rt, n_chunks: int) -> None:
    """Index a synthetic corpus through the runtime's store and catalog,
    then persist it."""
    from classmate_rag_tpu_torch.index.catalog import CatalogEntry

    rng = np.random.default_rng(7)
    vocab = [f"w{i}" for i in range(4000)]
    batch = 4096
    for start in range(0, n_chunks, batch):
        ids = [f"s{i}" for i in range(start, min(start + batch, n_chunks))]
        texts = [" ".join(rng.choice(vocab, size=30)) for _ in ids]
        vecs = rng.standard_normal((len(ids), rt.store.dim)).astype(
            np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        rt.store.upsert(ids, vecs, [t.split() for t in texts],
                        [{} for _ in ids])
        for cid, text in zip(ids, texts):
            rt.catalog.upsert(CatalogEntry(id=cid, text=text,
                                           tokens=text.split(), metadata={}))
    rt.persist()


def _pcts(ms_list) -> dict:
    s = sorted(ms_list)
    if not s:
        return {"p50_ms": None, "p95_ms": None, "n": 0}
    return {"p50_ms": round(s[len(s) // 2], 3),
            "p95_ms": round(s[min(len(s) - 1, int(0.95 * len(s)))], 3),
            "n": len(s)}


def rows_equal_reload(rt, k: int) -> dict:
    """The harness's questions through the served retriever against the
    same index loaded anew from disk on the same device: ids equal."""
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.index.store import IndexStore

    cfg = rt.cfg
    fresh = IndexStore.load_or_create(
        rt.store.dim, cfg.dense_dir, Catalog.load_or_create(cfg.bm25_dir),
        slab_rows=cfg.dense_slab_rows,
        terms_per_chunk=min(cfg.bm25_terms_per_chunk, 512),
        rescore=cfg.dense_rescore, rescore_pool=cfg.dense_rescore_pool,
        select=cfg.dense_select, device=rt.store.device,
    )
    ret = dataclasses.replace(rt.retriever, store=fresh, sharded=None)
    differ = []
    for q in QUESTIONS:
        got = [r["id"] for r in rt.retriever.retrieve(question=q, top_k=k)]
        want = [r["id"] for r in ret.retrieve(question=q, top_k=k)]
        if got != want:
            differ.append({"question": q, "served": got, "reloaded": want})
    return {"questions": len(QUESTIONS), "equal": not differ,
            "differ": differ, "reloaded_rows": fresh.n_rows}


def run(args, runtime=None) -> dict:
    """The load run of ``args`` (see ``parse_args``) against ``runtime``
    (default: ``get_runtime`` on ``args.device``); the report."""
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime
    from classmate_rag_tpu_torch.serve import make_server
    from classmate_rag_tpu_torch.utils.metrics import metrics

    rt = runtime or get_runtime(device=resolve_device(args.device))
    if args.synthetic:
        _build_synthetic(rt, args.synthetic)
    server = make_server("127.0.0.1", args.port, runtime=rt)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        return _load(args, rt, port, metrics)
    finally:
        server.shutdown()
        server.server_close()


def _load(args, rt, port: int, metrics) -> dict:
    def post(conn, route, payload):
        conn.request("POST", route, json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return resp.status

    # Blocking warm-up probe: the first ask places the index on the card.
    probe = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    status = post(probe, "/ask", {"question": QUESTIONS[0], "k": args.k})
    probe.close()
    if status != 200:
        return {"error": f"warmup probe failed: {status}", "errors": 1}
    stop = threading.Event()
    measuring = threading.Event()
    counts = [0] * args.clients
    latencies: list = []     # (seconds into the window, latency ms)
    lat_lock = threading.Lock()
    t_start = [0.0]
    errors = [0]
    rejects = [0]
    err_statuses: dict = {}

    def fetch_stats():
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/stats")
        body = json.loads(c.getresponse().read())
        c.close()
        return body

    mutation_log: list = []
    storm_dir = tempfile.TemporaryDirectory(prefix="storm_")

    def mutation_storm() -> None:
        """Each round ingests a small document (/add), then deletes it
        by path (/delete), through the product's HTTP surface."""
        for i in range(args.mutate):
            if stop.is_set():
                return
            doc = Path(storm_dir.name) / f"storm_{i}.txt"
            doc.write_text(
                f"storm document {i} about w{i % 50} w{(i * 7) % 50} "
                f"and stormterm{i}", encoding="utf-8")
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            t0 = time.perf_counter()
            add = post(c, "/add", {"path": str(doc),
                                   "course": "stormcourse"})
            add_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            delete = post(c, "/delete", {"path": str(doc)})
            c.close()
            mutation_log.append({
                "add_status": add, "add_s": round(add_s, 4),
                "delete_status": delete,
                "delete_s": round(time.perf_counter() - t0, 4)})

    def client(ci: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        qi = ci
        while not stop.is_set():
            payload = {"question": QUESTIONS[qi % len(QUESTIONS)],
                       "k": args.k}
            qi += 1
            t0 = time.perf_counter()
            status = 0
            try:
                status = post(conn, "/ask", payload)
            except Exception:
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
            dt = time.perf_counter() - t0
            if measuring.is_set():
                if status == 200:
                    counts[ci] += 1
                    with lat_lock:
                        latencies.append(
                            (time.perf_counter() - t_start[0], dt * 1e3))
                elif status == 503:
                    # Backpressure reject: expected under overload.
                    with lat_lock:
                        rejects[0] += 1
                else:
                    with lat_lock:
                        errors[0] += 1
                        err_statuses[status] = err_statuses.get(status, 0) + 1
            if status == 503:
                time.sleep(0.02)  # honour Retry-After in miniature
        conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.clients)]
    for t in threads:
        t.start()
    time.sleep(args.warmup_seconds)
    # The server's own timer counts only the window.
    stats_before = fetch_stats() if args.mutate else None
    metrics.reset()
    t_start[0] = time.perf_counter()
    measuring.set()
    t0 = time.perf_counter()
    storm = storm_window = None
    if args.mutate:
        # The storm fires in the middle third of the window.
        time.sleep(args.seconds / 3)
        storm_t0 = time.perf_counter() - t_start[0]
        storm = threading.Thread(target=mutation_storm, daemon=True)
        storm.start()
        storm.join(timeout=max(args.seconds / 3, 60))
        storm_window = (storm_t0, time.perf_counter() - t_start[0])
        remaining = args.seconds - (time.perf_counter() - t0)
        if remaining > 0:
            time.sleep(remaining)
    else:
        time.sleep(args.seconds)
    # Close the counting window at the wall's end: requests that finish
    # after it would land in the numerator without their time.
    measuring.clear()
    wall = time.perf_counter() - t0
    stop.set()
    for t in threads:
        t.join(timeout=90)
    if storm is not None:
        # A round still in flight ends before the index is read back; no
        # round starts after the stop.
        storm.join(timeout=600)
    # The server's own admission-to-response timer, beside the clients':
    # under one interpreter lock the clients' threads compete with the
    # server's, and their tails carry that wait.
    snap = metrics.snapshot()
    stats_after = fetch_stats() if args.mutate else None
    storm_dir.cleanup()

    total = sum(counts)
    out = {
        "http_ask_qps": round(total / wall, 3),
        "clients": args.clients,
        "requests": total,
        "rejects_503": rejects[0],
        "errors": errors[0],
        "error_statuses": err_statuses,
        **_pcts([ms for (_t, ms) in latencies]),
        "server_ask_mean_ms": snap.get("serve_ask_mean_ms"),
        "server_ask_p95_ms": snap.get("serve_ask_p95_ms"),
        "seconds": round(wall, 3),
        "device": str(rt.store.device),
        "n_rows": rt.store.n_rows,
    }
    if args.mutate and storm_window:
        lo, hi = storm_window
        # Rounds that ran all answered 200 (a round outlasting the
        # storm's share of the window ends the rounds early).
        ok = bool(mutation_log) and all(
            r["add_status"] == r["delete_status"] == 200
            for r in mutation_log)
        out["mutation"] = {
            "storm_window_s": [round(lo, 3), round(hi, 3)],
            "rounds": mutation_log,
            "rounds_planned": args.mutate,
            "rounds_ok": ok,
            "before": _pcts([ms for (t, ms) in latencies if t < lo]),
            "during": _pcts([ms for (t, ms) in latencies if lo <= t <= hi]),
            "after": _pcts([ms for (t, ms) in latencies if t > hi]),
            "maintenance_before": (stats_before or {}).get("maintenance")
            or {},
            "maintenance_after": (stats_after or {}).get("maintenance")
            or {},
            "reload": rows_equal_reload(rt, args.k),
        }
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--warmup-seconds", type=float, default=3.0)
    ap.add_argument("--port", type=int, default=8123,
                    help="0 binds a free port")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="index a synthetic corpus of N chunks first")
    ap.add_argument("--mutate", type=int, default=0,
                    help="fire N /add + /delete pairs in the middle third "
                         "of the window; latencies by phase, then the "
                         "rows checked against a reload")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def passed(out: dict) -> bool:
    """No error, and after a storm every round 200 and rows equal."""
    mut = out.get("mutation")
    return out.get("errors", 1) == 0 and (
        mut is None or (mut["rounds_ok"] and mut["reload"]["equal"]))


def main(argv=None) -> int:
    out = run(parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0 if passed(out) else 1


if __name__ == "__main__":
    raise SystemExit(main())
