"""HTTP serving daemon: the warm runtime behind a JSON API (port of the
JAX package's ``serve.py``; same routes, same JSON).

The daemon holds the device-resident Runtime — resident index tensors,
warm embedder — behind a dependency-free stdlib HTTP server:

  POST /ask      {"question": ..., "filters": {...}, "k": 8, "hybrid": true}
  POST /preview  {"question": ..., "filters": {...}, "k": 8}
  POST /add      {"path": ..., "course": ..., "tags": ...}
  POST /delete   {"ids": [...]} or {"path": ...} or filters
  GET  /stats
  GET  /healthz

Threaded server; device access follows reader-writer discipline
(utils/rwlock.py): query dispatches run concurrently, while index
mutations (/add, /delete) take the exclusive writer side — the in-place
O(delta) device sync must never run under a reading batch. Host work
(loaders, parsing, generation) overlaps freely.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from classmate_rag_tpu_torch.device import DeviceLike
from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
from classmate_rag_tpu_torch.utils.rwlock import ReadWriteLock, read_scope, write_scope


class Overloaded(Exception):
    """Admission control rejection → HTTP 503 with Retry-After. Explicit
    rejects under overload beat unbounded queueing into second-long tails
    and opaque 500s."""


def _meta_from_payload(payload: Dict[str, Any]):
    filters = payload.get("filters") or {}
    return normalize_cli_metadata(
        course=filters.get("course") or payload.get("course"),
        unit=filters.get("unit") or payload.get("unit"),
        language=filters.get("language") or payload.get("language"),
        doc_type=filters.get("doc_type") or payload.get("doc_type"),
        author=filters.get("author") or payload.get("author"),
        semester=filters.get("semester") or payload.get("semester"),
        tags=filters.get("tags") or payload.get("tags"),
        subject=filters.get("subject") or payload.get("subject"),
    )


class MicroBatcher:
    """Aggregate concurrent /ask requests into one fused device dispatch.

    Requests with identical (filters, k, hybrid, subject) keys batch
    together: the first arrival becomes the batch leader, waits up to
    ``max_wait_ms`` for followers (bounded at ``max_batch``), runs
    ``ask_question_batch`` once, and hands each caller its result. Under
    load this turns N serialized device round-trips into one — the shape
    the fused hybrid step is built for. A lone request pays at most the
    wait window.
    """

    def __init__(self, runtime, device_lock: threading.Lock,
                 max_batch: int = 32, max_wait_ms: float = 6.0,
                 follower_timeout_s: float = 8.0) -> None:
        self.runtime = runtime
        self.device_lock = device_lock
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        # Deadline for a follower waiting on its batch leader (retrieval +
        # generation for the whole batch). Sized to the generation tail,
        # not to patience: against a 6 ms batching window a stuck leader
        # should turn into a retryable 503 within seconds — holding a
        # follower's socket for minutes makes backpressure meaningless.
        # A timed-out follower gets Overloaded (503 + Retry-After) while
        # the leader's own request still completes. SERVE_FOLLOWER_TIMEOUT_S
        # overrides.
        self.follower_timeout = follower_timeout_s
        self._lock = threading.Lock()
        self._batches: Dict[Any, dict] = {}

    def ask(self, question: str, meta, top_k: int, hybrid: bool,
            subject: Optional[str]):
        from classmate_rag_tpu_torch.pipeline.ask import (
            finish_ask_batch, retrieve_batch_for_ask,
        )

        key = (json.dumps(meta.to_dict(), sort_keys=True, default=str),
               top_k, hybrid, subject)
        with self._lock:
            batch = self._batches.get(key)
            if batch is None or batch["closed"]:
                batch = {
                    "questions": [], "meta": meta, "done": threading.Event(),
                    "full": threading.Event(),
                    "results": None, "error": None, "closed": False,
                }
                self._batches[key] = batch
                leader = True
            else:
                leader = False
            idx = len(batch["questions"])
            batch["questions"].append(question)
            if len(batch["questions"]) >= self.max_batch:
                batch["closed"] = True
                batch["full"].set()

        if leader:
            if not batch["closed"]:
                # Wake early when the batch fills before the window ends.
                batch["full"].wait(self.max_wait)
            with self._lock:
                batch["closed"] = True
                if self._batches.get(key) is batch:
                    del self._batches[key]
            try:
                # Reader side of the device lock covers ONLY the fused
                # retrieval dispatch (concurrent with other queries,
                # exclusive against mutations); the generation/citation
                # tail is host-side and runs outside any lock.
                with read_scope(self.device_lock):
                    batched = retrieve_batch_for_ask(
                        questions=batch["questions"], filters=batch["meta"],
                        top_k=top_k, hybrid=hybrid, runtime=self.runtime,
                    )
                batch["results"] = finish_ask_batch(
                    questions=batch["questions"], batched=batched,
                    filters=batch["meta"], top_k=top_k, hybrid=hybrid,
                    forced_subject=subject, runtime=self.runtime,
                )
            except Exception as exc:  # propagate to every waiter
                batch["error"] = exc
            batch["done"].set()
        else:
            if not batch["done"].wait(timeout=self.follower_timeout):
                # Grace re-check: the leader may complete between the
                # wait expiring and this line — a computed result must
                # never be discarded over a timer race.
                batch["done"].wait(timeout=0.05)
        if batch["error"] is not None:
            raise batch["error"]
        if batch["results"] is None:
            # Batch genuinely overran the follower deadline: an explicit
            # retryable signal (503), not an opaque 500. The leader's own
            # request still completes and returns normally.
            raise Overloaded(
                f"ask batch exceeded follower_timeout="
                f"{self.follower_timeout}s"
            )
        return batch["results"][idx]


class RagRequestHandler(BaseHTTPRequestHandler):
    server_version = "classmate-rag-tpu-torch/0.1"
    runtime = None          # injected by serve()
    device_lock = ReadWriteLock()
    # Bounded admission: at most this many query requests in flight;
    # excess get an immediate 503 + Retry-After instead of queueing into
    # second-long tails (the host's generation/HTTP tail saturates long
    # before the device does).
    admission: threading.Semaphore = threading.Semaphore(32)
    retry_after_s = 1

    # -- plumbing -------------------------------------------------------
    def _send(self, code: int, obj: Any) -> None:
        body = json.dumps(obj, ensure_ascii=False, default=str).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Optional[Dict[str, Any]]:
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b"{}"
            obj = json.loads(raw or b"{}")
            if not isinstance(obj, dict):
                raise ValueError("payload must be a JSON object")
            return obj
        except (ValueError, json.JSONDecodeError) as exc:
            self._send(400, {"error": f"bad request: {exc}"})
            return None

    def log_message(self, fmt: str, *args: Any) -> None:  # quiet by default
        pass

    # -- routes ----------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        if self.path == "/healthz":
            self._send(200, {"ok": True})
        elif self.path == "/stats":
            from classmate_rag_tpu_torch.pipeline.stats import index_stats

            with read_scope(self.device_lock):
                self._send(200, index_stats(self.runtime))
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def _send_overloaded(self, detail: str) -> None:
        body = json.dumps(
            {"error": "overloaded", "detail": detail,
             "retry_after_s": self.retry_after_s}
        ).encode("utf-8")
        self.send_response(503)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Retry-After", str(self.retry_after_s))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        # Admission BEFORE any body work: shed load must cost near-zero
        # host CPU. The unread body forces the connection closed —
        # keep-alive would mis-frame the next request on this socket.
        gated = self.path in ("/ask", "/preview")
        if gated and not self.admission.acquire(blocking=False):
            self.close_connection = True
            self._send_overloaded("admission queue full")
            return
        try:
            payload = self._read_json()
            if payload is None:
                return
            if self.path == "/ask":
                self._handle_ask(payload)
            elif self.path == "/preview":
                self._handle_preview(payload)
            elif self.path == "/add":
                self._handle_add(payload)
            elif self.path == "/delete":
                self._handle_delete(payload)
            else:
                self._send(404, {"error": f"no route {self.path}"})
        except Overloaded as exc:
            self._send_overloaded(str(exc))
        except (ValueError, FileNotFoundError) as exc:
            self._send(400, {"error": str(exc)})
        except Exception as exc:  # pragma: no cover - last-resort 500
            self._send(500, {"error": f"{type(exc).__name__}: {exc}"})
        finally:
            if gated:
                self.admission.release()

    def _handle_ask(self, payload: Dict[str, Any]) -> None:
        from classmate_rag_tpu_torch.utils.metrics import metrics

        with metrics.timer("serve_ask"):
            self._handle_ask_inner(payload)

    def _handle_ask_inner(self, payload: Dict[str, Any]) -> None:
        question = str(payload.get("question") or "").strip()
        if not question:
            raise ValueError("missing 'question'")
        res = self.batcher.ask(
            question,
            _meta_from_payload(payload),
            int(payload.get("k", 8)),
            bool(payload.get("hybrid", True)),
            payload.get("subject"),
        )
        self._send(200, {
            "question": res.question,
            "answer": res.answer,
            "language": res.language,
            "sources": res.sources,
            "route": res.route,
            "route_reason": res.route_reason,
            "retrieved": [
                {"id": r.get("id"), "scores": r.get("scores"),
                 "metadata": r.get("metadata")}
                for r in res.retrieved
            ],
        })

    def _handle_preview(self, payload: Dict[str, Any]) -> None:
        from classmate_rag_tpu_torch.admin.inspect import retrieve_preview

        question = str(payload.get("question") or "").strip()
        if not question:
            raise ValueError("missing 'question'")
        with read_scope(self.device_lock):
            out = retrieve_preview(
                question=question,
                filters=_meta_from_payload(payload),
                top_k=int(payload.get("k", 8)),
                hybrid=bool(payload.get("hybrid", True)),
                runtime=self.runtime,
            )
        self._send(200, out)

    def _handle_add(self, payload: Dict[str, Any]) -> None:
        from classmate_rag_tpu_torch.pipeline.ingest import ingest_file

        path = payload.get("path")
        if not path:
            raise ValueError("missing 'path'")
        with write_scope(self.device_lock):
            res = ingest_file(
                path=path,
                doc_meta=_meta_from_payload(payload),
                runtime=self.runtime,
            )
        out = dataclasses.asdict(res)
        out.pop("chunk_ids", None)  # thousands of ids for a big PDF
        self._send(200, out)

    def _handle_delete(self, payload: Dict[str, Any]) -> None:
        """Admin delete: {"ids": [...]} or {"path"/filters} — the CLI
        delete verb's resolution semantics behind HTTP (ids take full
        precedence), under the exclusive writer side of the device lock
        like /add."""
        from classmate_rag_tpu_torch.admin.manage import delete_by_ids, resolve_ids

        where = _meta_from_payload(payload).to_dict()
        if not (payload.get("ids") or payload.get("path") or where):
            # An empty selector would resolve EVERY chunk.
            raise ValueError(
                "refusing to delete without ids, path, or filters"
            )
        # Resolution is READ-ONLY (catalog streaming under the catalog's
        # own lock) and can take seconds at serving scale — it must NOT
        # hold the exclusive device writer side, or every concurrent
        # query stalls behind it. Only the actual delete mutates device
        # state. A chunk added between resolve and delete
        # for the same path survives — same read-then-delete window any
        # admin CLI has.
        with read_scope(self.device_lock):
            ids = resolve_ids(
                ids=payload.get("ids"),
                path=payload.get("path"),
                where=where,
                runtime=self.runtime,
            )
        if ids:
            with write_scope(self.device_lock):
                res = delete_by_ids(ids, runtime=self.runtime)
        else:
            res = {"vector_deleted": 0, "catalog_deleted": 0}
        self._send(200, {"ids_resolved": len(ids), **res})


def make_server(host: str = "127.0.0.1", port: int = 8080,
                runtime=None, max_pending: Optional[int] = None,
                follower_timeout_s: Optional[float] = None,
                device: DeviceLike = None,
                ) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server with a warm runtime
    (``get_runtime(device=device)`` unless ``runtime`` is given; None
    means CUDA).

    ``max_pending`` bounds in-flight query requests (SERVE_MAX_PENDING
    env, default 32): excess requests get 503 + Retry-After immediately.
    """
    import os

    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    rt = runtime or get_runtime(device=device)
    lock = ReadWriteLock()
    if max_pending is None:
        max_pending = int(os.getenv("SERVE_MAX_PENDING", "32"))
    batcher_kw = {}
    if follower_timeout_s is None:
        env_t = os.getenv("SERVE_FOLLOWER_TIMEOUT_S")
        follower_timeout_s = float(env_t) if env_t else None
    if follower_timeout_s is None:
        # Size the follower deadline to the generation tail of the
        # CONFIGURED backend, not to a fixed number: the extractive
        # runner answers a batch in milliseconds (8 s is a stuck-leader
        # bound), while a real decode model legitimately spends tens of
        # seconds on a 32-question batch at LLM_MAX_TOKENS=768 — an 8 s
        # deadline there would 503 every follower of every healthy batch
        # and defeat micro-batching entirely. Derived from the runtime
        # ACTUALLY serving the requests (rt.cfg), not a fresh
        # load_config(): the caller may have built the runtime under a
        # different LLM_BACKEND than the current env/global state.
        backend = rt.cfg.llm_backend.lower()
        follower_timeout_s = 8.0 if backend == "extractive" else 60.0
    batcher_kw["follower_timeout_s"] = follower_timeout_s
    handler = type("Handler", (RagRequestHandler,), {
        "runtime": rt,
        "device_lock": lock,
        "batcher": MicroBatcher(rt, lock, **batcher_kw),
        "admission": threading.Semaphore(max(max_pending, 1)),
    })
    return ThreadingHTTPServer((host, port), handler)


def serve(host: str = "127.0.0.1", port: int = 8080,
          device: DeviceLike = None) -> None:
    server = make_server(host, port, device=device)
    rt = server.RequestHandlerClass.runtime
    # Readiness gate: at serving scale the first query of a fresh
    # process pays the one-time device placement of the slabs and the
    # split layout. A daemon absorbs that at startup, not the first
    # caller: join the runtime's background warm-up before announcing
    # readiness.
    t = getattr(rt, "warmup_thread", None)
    if t is not None:
        t.join()
    print(json.dumps({"serving": f"http://{host}:{port}"}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
