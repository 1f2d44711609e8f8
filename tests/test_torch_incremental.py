"""The port's O(delta) device sync (classmate_rag_tpu_torch/index/store.py)
against the JAX package's, on the same mutation sequences.

After every step both stores answer the same batch: rows EQUAL, scores
within atol/rtol 1e-5 (f32 on both sides, sums in another order), and
``device_full_uploads`` / ``split_full_builds`` /
``split_snapshot_restores`` EQUAL to the JAX package's. The port's rows
must also equal those of a store built in full from the same host state
(``from_host_state``: one structural upload, one layout build).

The sequences follow tests/test_incremental_lexical.py and
tests/test_store_delta_persist.py: overwrites, appends within capacity,
new vocabulary, an A→B→A cycle, deletes, capacity growth, an overlay
past its reserve and a backlog past ``_OLD_LEX_CAP``. The last test runs
asks in one thread while another ingests and persists.
"""

import sys
import threading

import numpy as np
import pytest

import jax

import classmate_rag_tpu.index.lexical as jlex
import classmate_rag_tpu.index.store as jstore_mod
import classmate_rag_tpu_torch.index.store as tstore_mod
from classmate_rag_tpu.index.store import IndexStore as JStore
from classmate_rag_tpu_torch.index.store import IndexStore as TStore

DIM = 32
VOCAB = [f"w{i}" for i in range(60)]
COUNTERS = ("device_full_uploads", "split_full_builds",
            "split_snapshot_restores")


def _doc(rng):
    return [VOCAB[i] for i in rng.integers(0, len(VOCAB), rng.integers(4, 12))]


def _emb(rng, n=1):
    e = rng.standard_normal((n, DIM)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


class Pair:
    """The same mutations on a JAX store and a port store."""

    def __init__(self, tmp_path, seed=11, n0=30, slab_rows=8):
        self.rng = np.random.default_rng(seed)
        kw = dict(slab_rows=slab_rows, terms_per_chunk=16, rescore="on",
                  rescore_pool=16)
        self.js = JStore(DIM, tmp_path / "j", **kw)
        self.ts = TStore(DIM, tmp_path / "t", device="cpu", **kw)
        self.upsert([f"d{i}" for i in range(n0)], n0)

    def upsert(self, ids, n=None, docs=None, metas=None):
        n = len(ids) if n is None else n
        emb = _emb(self.rng, n)
        docs = docs or [_doc(self.rng) for _ in range(n)]
        metas = metas or [{"course": f"c{i % 3}"} for i in range(n)]
        for s in (self.js, self.ts):
            s.upsert(ids, emb, docs, metas)

    def delete(self, ids):
        for s in (self.js, self.ts):
            s.delete(ids)

    def check(self, tag):
        qv = _emb(self.rng, 4)
        terms = [_doc(self.rng)[:4] for _ in range(4)]
        terms[2] = []
        for where in (None, {"course": "c1"}):
            want = jax.device_get(
                self.js.hybrid_topk_batch(qv, terms, where, top_k=6))
            got = self.ts.hybrid_topk_batch(qv, terms, where, top_k=6)
            assert got.rows.numpy().tolist() == np.asarray(
                want.rows).tolist(), f"{tag} where={where}"
            for g, w in ((got.fused, want.fused),
                         (got.vec_dist, want.vec_dist),
                         (got.bm25_score, want.bm25_score)):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                    equal_nan=True, err_msg=tag)
            fresh = TStore.from_host_state(
                self.ts.host_state(), device="cpu", slab_rows=8,
                rescore="on", rescore_pool=16,
            ).hybrid_topk_batch(qv, terms, where, top_k=6)
            assert got.rows.tolist() == fresh.rows.tolist(), tag
        for name in COUNTERS:
            assert getattr(self.ts, name) == getattr(self.js, name), (
                tag, name)


@pytest.mark.parametrize("head_df", [256, 3], ids=["tail-only", "head"])
def test_small_deltas_stay_incremental(tmp_path, monkeypatch, head_df):
    """At the default df threshold every term of this corpus is a tail
    term; at 3 the frequent ones form the head matrix, whose columns the
    sync then scatters."""
    for cls in (JStore, TStore):
        monkeypatch.setattr(cls, "HEAD_DF_THRESHOLD", head_df)
    p = Pair(tmp_path)
    p.check("initial")
    assert p.ts.device_full_uploads == p.ts.split_full_builds == 1
    for i in (2, 9, 17):                       # token overwrites
        p.upsert([f"d{i}"])
        p.check(f"overwrite d{i}")
    p.upsert(["d30", "d31"])                   # append within capacity
    p.check("append")
    p.upsert(["d5"], docs=[["zebra", "quagga", "zebra", "w3"]])
    p.check("new vocab")
    _, rows = p.ts.bm25_topk(["zebra", "quagga"], None, 4)
    assert rows[0] == p.ts.id_to_row["d5"]
    row9 = p.ts.id_to_row["d9"]
    inv = sorted(p.ts.vocab, key=p.ts.vocab.__getitem__)
    a_tokens = [inv[t] for t, f in zip(p.ts.term_ids[row9], p.ts.tfs[row9])
                if t >= 0 and f > 0 for _ in range(int(f))]
    p.upsert(["d9"], docs=[["w1", "w2"]])      # A -> B
    p.check("A->B")
    p.upsert(["d9"], docs=[a_tokens])          # B -> A
    p.check("B->A")
    p.delete(["d3", "d11"])
    p.check("delete")
    p.upsert(["d12"], metas=[{"course": "c1", "tag_x": True}])
    p.check("metadata")
    # No O(corpus) path ran for any of these.
    assert p.ts.device_full_uploads == p.ts.split_full_builds == 1
    p.upsert([f"g{j}" for j in range(8)])      # capacity growth: structural
    p.check("growth")
    assert p.ts.device_full_uploads == p.ts.split_full_builds == 2


def test_large_backlog_is_structural(tmp_path):
    p = Pair(tmp_path)
    p.check("initial")
    p.upsert([f"d{i}" for i in range(10)])     # 10 * 4 > 30 rows
    p.check("backlog")
    assert p.ts.device_full_uploads == 2


def test_overlay_past_reserve_rebuilds(tmp_path, monkeypatch):
    """An overlay that outgrows its reserve makes the plan infeasible:
    both packages rebuild the layout in full, then go on O(delta)."""
    orig = jlex.plan_tail_delta

    def small_reserve(*a, reserve, **k):
        return orig(*a, reserve=min(reserve, 24), **k)

    monkeypatch.setattr(jlex, "plan_tail_delta", small_reserve)
    monkeypatch.setattr(tstore_mod, "plan_tail_delta", small_reserve)
    p = Pair(tmp_path)
    p.check("initial")
    for j in range(6):
        p.upsert([f"d{2 * j}", f"d{2 * j + 1}"])
        p.check(f"round {j}")
    assert p.ts.split_full_builds > 1          # the reserve ran out
    assert p.ts.device_full_uploads == 1       # the tensors stayed


def test_old_capture_cap_forces_rebuild(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore_mod, "_OLD_LEX_CAP", 2)
    monkeypatch.setattr(tstore_mod, "_OLD_LEX_CAP", 2)
    p = Pair(tmp_path)
    p.check("initial")
    for i in range(5):                         # more rows than the cap
        p.upsert([f"d{i}"])
    p.check("past the cap")
    assert p.ts.split_full_builds == 2 and p.ts.device_full_uploads == 1


def test_tensors_do_not_alias_host_arrays(tmp_path):
    """The resident tensors are copies: a host write before the sync
    must not show in them (the in-place scatter is the only writer)."""
    p = Pair(tmp_path)
    p.check("initial")
    dev = p.ts._sync_device()
    for name in ("term_ids", "tfs", "doc_len", "valid"):
        assert dev[name].data_ptr() != getattr(p.ts, name).ctypes.data
    before = dev["doc_len"].clone()
    p.ts.doc_len[0] += 5.0
    assert dev["doc_len"].equal(before)


def _write_doc(path, g):
    words = " ".join(f"term{g}x{k} shared words" for k in range(6))
    path.write_text(f"Document {g} about topic {g % 3}. {words}.")


def test_ask_while_ingest_matches_serial(tmp_index_env, tmp_path,
                                         monkeypatch):
    """Asks in one thread while another ingests and persists, under the
    serving read/write lock: every ask equals the serial run's ask at the
    generation it saw."""
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ingest import ingest_file
    from classmate_rag_tpu_torch.pipeline.runtime import (
        get_runtime, reset_runtime,
    )
    from classmate_rag_tpu_torch.utils.rwlock import (
        ReadWriteLock, read_scope, write_scope,
    )

    n_gen = 6
    docs = tmp_path / "docs"
    docs.mkdir()
    paths = [docs / f"doc{g}.txt" for g in range(n_gen + 1)]
    for g, path in enumerate(paths):
        _write_doc(path, g)
    questions = ["topic shared words", "term3x1 document",
                 "term5x4 words", "document topic"]
    meta = normalize_cli_metadata(course="c")

    def asked(rt):
        return [[(r["id"], r["scores"]["fused"]) for r in res]
                for res in rt.retriever.retrieve_batch(questions=questions)]

    def runtime_in(sub):
        for var, rel in (("INDEX_DIR", ""), ("DENSE_DIR", "/dense"),
                         ("BM25_DIR", "/bm25"), ("EMB_CACHE_DIR", "/emb")):
            monkeypatch.setenv(var, str(tmp_path / sub) + rel)
        reset_runtime()
        return get_runtime(reload=True, device="cpu")

    serial_rt = runtime_in("serial")
    serial = []
    for g, path in enumerate(paths):
        ingest_file(path=path, doc_meta=meta, runtime=serial_rt)
        serial.append(asked(serial_rt))

    rt = runtime_in("live")
    ingest_file(path=paths[0], doc_meta=meta, runtime=rt)
    lock = ReadWriteLock()
    state = {"gen": 0}
    seen = []
    done = threading.Event()

    def writer():
        try:
            for g in range(1, n_gen + 1):
                with write_scope(lock):
                    ingest_file(path=paths[g], doc_meta=meta, runtime=rt)
                    rt.persist()
                    state["gen"] = g
        finally:
            done.set()

    def reader():
        while not done.is_set():
            with read_scope(lock):
                seen.append((state["gen"], asked(rt)))

    # One writer, four readers, and a short switch interval so that the
    # threads interleave inside the sync and the scatters.
    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    with read_scope(lock):
        seen.append((state["gen"], asked(rt)))
    assert seen[-1][0] == n_gen
    for gen, got in seen:
        assert [[i for i, _ in q] for q in got] == [
            [i for i, _ in q] for q in serial[gen]], gen
        for gq, sq in zip(got, serial[gen]):
            np.testing.assert_allclose([s for _, s in gq],
                                       [s for _, s in sq], rtol=1e-6)
    reset_runtime()
