"""The product path through the port's corpus-sharded engine: Runtime,
ask, the server, stats and the admin rebuild (the JAX package's
tests/test_runtime_sharded.py, for the port).

``local_devices`` is patched to ``[cpu] * 4``, standing for a host with
four cards. Then the default configuration (``N_SHARDS`` 0) builds a
4-shard ``ShardedHybridIndex``, the retriever asks through it, and every
answer (text, sources, retrieved ids) EQUALS a one-device runtime's over
the same on-disk index, fused scores within 1e-5. Admin mutations reach
the engine through the store's journal and move O(delta) bytes.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

import classmate_rag_tpu_torch.pipeline.runtime as trt_mod
from classmate_rag_tpu_torch.config import load_config
from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
from classmate_rag_tpu_torch.pipeline.ask import ask_question
from classmate_rag_tpu_torch.pipeline.ingest import ingest_file
from classmate_rag_tpu_torch.pipeline.runtime import (
    get_runtime,
    reset_runtime,
)

CARDS = 4
DOCS = {
    "calc.md": (
        "The derivative of a function measures its rate of change. "
        "It is the limit of the difference quotient.\n\n"
        "The product rule and the chain rule compute derivatives of "
        "products and compositions. Practice with polynomial examples.\n\n"
        "Integrals accumulate the area under a curve. The fundamental "
        "theorem of calculus links both operations."
    ),
    "pasta.txt": (
        "Boil salted water in a large pot. Cook the pasta nine minutes. "
        "Drain it and toss with tomato sauce and basil."
    ),
    "linear.txt": (
        "Matrix multiplication composes linear transformations. "
        "Eigenvalues and eigenvectors characterize a linear map."
    ),
}
QUESTIONS = [
    "what is the derivative rate of change",
    "how long to cook pasta",
    "eigenvalues of a linear map",
]


@pytest.fixture()
def env(tmp_path, monkeypatch):
    root = tmp_path / "indexes"
    for var, rel in (("INDEX_DIR", ""), ("DENSE_DIR", "/dense"),
                     ("BM25_DIR", "/bm25"), ("EMB_CACHE_DIR", "/emb")):
        monkeypatch.setenv(var, str(root) + rel)
    monkeypatch.setenv("EMBEDDING_BACKEND", "hash")
    monkeypatch.setenv("LLM_BACKEND", "extractive")
    cpu = torch.device("cpu")
    monkeypatch.setattr(trt_mod, "local_devices", lambda _d: [cpu] * CARDS)
    yield tmp_path
    reset_runtime()
    load_config(reload=True)


def _runtime(monkeypatch, tmp_path, n_shards):
    monkeypatch.setenv("N_SHARDS", str(n_shards))
    load_config(reload=True)
    reset_runtime()
    rt = get_runtime(reload=True, device="cpu")
    if len(rt.store) == 0:
        for name, text in DOCS.items():
            path = tmp_path / name
            path.write_text(text)
            ingest_file(path=path, doc_meta=normalize_cli_metadata(
                course="calc101" if "calc" in name else "misc"), runtime=rt)
        rt.persist()
    return rt


def _ask(rt, question, **kw):
    kw.setdefault("filters", normalize_cli_metadata())
    return ask_question(question=question, runtime=rt, **kw)


def _same_answer(got, want):
    assert got.answer == want.answer
    assert got.sources == want.sources
    assert [r["id"] for r in got.retrieved] == [
        r["id"] for r in want.retrieved]
    for a, b in zip(got.retrieved, want.retrieved):
        assert a["scores"]["fused"] == pytest.approx(
            b["scores"]["fused"], abs=1e-5)


@pytest.mark.parametrize("n_shards,want", [(0, CARDS), (1, None), (4, 4),
                                           (3, 2), (8, CARDS)])
def test_n_shards_picks_the_engine(env, monkeypatch, n_shards, want):
    """0 = one shard a card, 1 = one device, n = n clamped to the cards
    and walked down to a divisor of the slab (4096 % 3 → 2)."""
    rt = _runtime(monkeypatch, env, n_shards)
    if want is None:
        assert rt.sharded is None and rt.retriever.sharded is None
        return
    assert rt.sharded.n_shards == want
    assert rt.sharded.mesh == [torch.device("cpu")] * want
    assert rt.retriever.sharded is rt.sharded
    assert rt.load_timings["sharded_s"] >= 0.0


def test_asks_identical_to_one_device(env, monkeypatch):
    """Plain and filtered asks, one at a time and in a batch."""
    from classmate_rag_tpu_torch.pipeline.ask import ask_question_batch

    rt1 = _runtime(monkeypatch, env, 1)
    filt = normalize_cli_metadata(course="calc101")
    singles = [_ask(rt1, q, top_k=4) for q in QUESTIONS]
    filtered = _ask(rt1, "derivative", filters=filt, top_k=3)
    batch1 = ask_question_batch(questions=QUESTIONS, filters=filt,
                                runtime=rt1)
    rt4 = _runtime(monkeypatch, env, 0)
    assert rt4.sharded is not None and len(rt4.store) == len(rt1.store)
    calls = []
    real = rt4.sharded.query_batch
    rt4.sharded.query_batch = lambda *a, **k: calls.append(1) or real(*a, **k)
    for q, want in zip(QUESTIONS, singles):
        _same_answer(_ask(rt4, q, top_k=4), want)
    _same_answer(_ask(rt4, "derivative", filters=filt, top_k=3), filtered)
    for got, want in zip(ask_question_batch(questions=QUESTIONS,
                                            filters=filt, runtime=rt4),
                         batch1):
        _same_answer(got, want)
    assert len(calls) == len(QUESTIONS) + 2


def test_mutation_visible_and_o_delta(env, monkeypatch):
    """A delete moves bias bytes, not the corpus, and the deleted chunk
    leaves the sharded answers; an embedding update scatters one row."""
    rt = _runtime(monkeypatch, env, 0)
    before = _ask(rt, "how long to cook pasta", top_k=2)
    victim = before.retrieved[0]["id"]
    placed = rt.sharded.bytes_placed_total
    rt.store.delete([victim])
    rt.catalog.delete([victim])
    after = _ask(rt, "how long to cook pasta", top_k=2)
    assert victim not in [r["id"] for r in after.retrieved]
    moved = rt.sharded.bytes_placed_total - placed
    assert moved < placed / 4, (moved, placed)

    store = rt.store
    row = 0
    entry = rt.catalog.get(store.ids[row])
    store.upsert([store.ids[row]], -store.emb[row:row + 1].astype(np.float32),
                 [entry.tokens], [dict(entry.metadata)])
    rt.sharded.ensure_fresh()
    assert rt.sharded.bytes_placed_last_refresh < 16 * store.dim
    q = store.emb[row:row + 1].astype(np.float32)
    assert np.array_equal(
        rt.sharded.query_batch(q, [[]], None, top_k=2).rows.numpy(),
        store.hybrid_topk_batch(q, [[]], None, top_k=2).rows.numpy())


def test_server_asks_through_the_engine(env, monkeypatch):
    from classmate_rag_tpu_torch.serve import make_server

    rt = _runtime(monkeypatch, env, 0)
    calls = []
    real = rt.sharded.query_batch
    rt.sharded.query_batch = lambda *a, **k: calls.append(1) or real(*a, **k)
    server = make_server("127.0.0.1", 0, runtime=rt)
    worker = threading.Thread(target=server.serve_forever, daemon=True)
    worker.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=60)
        conn.request("POST", "/ask",
                     json.dumps({"question": "what is the derivative",
                                 "k": 3}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["retrieved"]
        assert calls, "/ask must go through the sharded engine"
    finally:
        server.shutdown()
        server.server_close()
        worker.join(30)
    assert not worker.is_alive()


def test_stats_and_rebuild(env, monkeypatch):
    """stats carries the engine's block; a rebuild wraps the new store
    in a new engine that answers as the new store does."""
    from classmate_rag_tpu_torch.admin.backup import rebuild_embeddings
    from classmate_rag_tpu_torch.pipeline.stats import index_stats

    rt = _runtime(monkeypatch, env, 0)
    stats = index_stats(runtime=rt)["sharded"]
    assert stats["n_shards"] == CARDS
    assert sum(stats["rows_per_shard"]) == len(rt.store)
    old = rt.sharded
    out = rebuild_embeddings("other-model", runtime=rt)
    assert out["updated"] == len(rt.store)
    assert rt.sharded is not old and rt.sharded.store is rt.store
    assert rt.retriever.sharded is rt.sharded
    got = _ask(rt, QUESTIONS[0], top_k=4)
    rt.retriever.sharded = None
    _same_answer(got, _ask(rt, QUESTIONS[0], top_k=4))
