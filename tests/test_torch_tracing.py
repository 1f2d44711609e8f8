"""The port's spans and counters (``utils/metrics.py`` tracing, the store
call's and the fused step's spans, the store's filtered-df cache
counters), on the CPU.

- One store call with tracing on records ``store.batch`` with every
  stage span as a descendant, all with one batch id, each inside its
  parent's interval, and counts equal to the host arrays of the same
  inputs (``_split_query_arrays``).
- With tracing off a store call records nothing, constructs no span and
  takes no lock of the metrics module; a disabled span allocates
  nothing.
- A filtered query twice: one miss, then one hit; an ``upsert`` clears
  the cache and the next lookup misses.
"""

import itertools
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from classmate_rag_tpu_torch.index.lexical import pack_query_terms
from classmate_rag_tpu_torch.index.store import IndexStore
from classmate_rag_tpu_torch.ops import hybrid_step
from classmate_rag_tpu_torch.utils import metrics as metrics_mod
from classmate_rag_tpu_torch.utils.metrics import Metrics, metrics

D, ROWS, WIDTH = 16, 600, 16
KNOBS = dict(k_vector=4, k_bm25=4, top_k=4, pool=8)
# Each span of one store call and its parent.
PARENT = {
    "store.batch": None,
    "store.inputs": "store.batch",
    "store.inputs.sync": "store.inputs",
    "store.inputs.mask": "store.inputs",
    "store.inputs.df": "store.inputs",
    "store.inputs.terms": "store.inputs",
    "store.inputs.split": "store.inputs",
    "store.inputs.pack": "store.inputs",
    "step": "store.batch",
    "step.dense": "step",
    "step.bm25_core": "step",
    "step.bm25_select": "step",
    "step.fuse": "step",
}


def _words(rng, n):
    # Zipf over 400 words: a few in most rows (head), many rare (tail).
    return [f"w{int(x)}" for x in np.minimum(rng.zipf(1.3, n), 400)]


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture()
def store(tmp_path):
    rng = np.random.default_rng(5)
    st = IndexStore(D, tmp_path, slab_rows=256, terms_per_chunk=WIDTH,
                    device="cpu")
    st.HEAD_DF_THRESHOLD = 40           # head and tail terms at this size
    st.upsert([f"r{i}" for i in range(ROWS)], _unit(rng, ROWS, D),
              [_words(rng, 12) for _ in range(ROWS)],
              [{"course": f"c{i % 3}"} for i in range(ROWS)])
    return st


def _batch(seed=9, b=6):
    rng = np.random.default_rng(seed)
    return _unit(rng, b, D), [_words(rng, 5) for _ in range(b)]


def test_store_call_records_every_stage_of_one_batch(store):
    q, terms = _batch()
    store.hybrid_topk_batch(q, terms, None, **KNOBS)   # layout built
    with metrics.tracing() as spans:
        store.hybrid_topk_batch(q, terms, None, **KNOBS)
    assert sorted(s.name for s in spans) == sorted(PARENT)
    by_name = {s.name: s for s in spans}
    root = by_name["store.batch"]
    assert root.parent_id is None and root.batch_id == root.span_id
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.batch_id == root.span_id, s.name
        if PARENT[s.name] is not None:
            parent = by_id[s.parent_id]
            assert parent.name == PARENT[s.name], s.name
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
    # The stages of each parent run one after the other.
    for parent in ("store.inputs", "step"):
        kids = sorted((s for s in spans if PARENT[s.name] == parent),
                      key=lambda s: s.t0_ns)
        for a, b in zip(kids, kids[1:]):
            assert a.t1_ns <= b.t0_ns

    # Counts: the host arrays of the same inputs.
    q_terms, q_counts = pack_query_terms(store.vocab, terms, 32)
    qa = store._split_query_arrays(q_terms, q_counts)
    r_cap = store._sync_split()["r_cap"]
    live = int((qa["u_lens"] > 0).sum())
    assert live > 0 and len(qa["h_slots"]) > 0
    assert by_name["store.inputs.split"].counts == {
        "tail_postings": int(qa["u_lens"].sum()),
        "tail_slots": live * r_cap,
    }
    assert 0 < qa["u_lens"].sum() <= live * r_cap
    assert by_name["step.bm25_core"].counts == {
        "bm25_k_slots": len(qa["h_slots"]) + len(qa["t_tids"]),
    }
    for name in PARENT:
        if name not in ("store.inputs.split", "step.bm25_core"):
            assert by_name[name].counts == {}, name


def test_unpacked_step_records_its_stages_outside_a_batch(store):
    q, terms = _batch(seed=11)
    args, kw = store.hybrid_step_inputs(q, terms, None, **KNOBS)
    qa = hybrid_step.unpack_query_arrays(
        args[8], **{s: kw.pop(s) for s in ("h", "u", "t", "b", "m")})
    cols = ("h_slots", "h_tids", "u_starts", "u_lens", "u_cols", "t_tids",
            "q_tids", "q_counts", "has_terms")
    with metrics.tracing() as spans:
        hybrid_step.hybrid_query_step_split(
            *args[:8], *(qa[c] for c in cols), *args[9:], **kw)
    assert [s.name for s in spans] == ["step.dense", "step.bm25_core",
                                       "step.bm25_select", "step.fuse"]
    # With no store call around them each stage is a root of its own.
    assert all(s.parent_id is None and s.batch_id == s.span_id
               for s in spans)


class _CountingLock:
    def __init__(self):
        self.inner, self.taken = threading.Lock(), 0

    def __enter__(self):
        self.taken += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)

    def acquire(self, *a, **kw):
        self.taken += 1
        return self.inner.acquire(*a, **kw)

    def release(self):
        return self.inner.release()


def test_store_call_with_tracing_off_records_nothing(store, monkeypatch):
    q, terms = _batch()
    with metrics.tracing() as spans:
        pass
    lock = _CountingLock()
    monkeypatch.setattr(metrics, "_lock", lock)

    def no_record(*a, **kw):
        raise AssertionError("a span was made with tracing off")

    monkeypatch.setattr(metrics_mod, "_OpenSpan", no_record)
    got = store.hybrid_topk_batch(q, terms, {"course": "c1"}, **KNOBS)
    assert got.rows.shape == (len(terms), KNOBS["top_k"])
    assert spans == [] and lock.taken == 0
    with metrics.span("x") as sp:
        assert sp is None


def test_disabled_span_allocates_nothing():
    m = Metrics()
    for _ in range(100):                 # warm the interpreter's caches
        with m.span("store.inputs"):
            pass

    def peak_rise(n):
        spans = itertools.repeat(None, n)
        tracemalloc.start()
        try:
            base, _ = tracemalloc.get_traced_memory()
            tracemalloc.reset_peak()
            for _ in spans:
                with m.span("store.inputs"):
                    pass
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()

    # No byte a span: 10,000 spans raise the peak by the interpreter's
    # own few bytes, once (the least of three tries: another thread of
    # the process may allocate meanwhile).
    assert min(peak_rise(10_000) for _ in range(3)) < 256
    assert m.span("a") is m.span("b")    # one shared no-op context


def test_df_filter_cache_counts_a_miss_then_a_hit(store):
    q, terms = _batch(seed=13)
    where = {"course": "c2"}
    seen = []
    for _ in range(2):
        store.hybrid_topk_batch(q, terms, where, **KNOBS)
        seen.append((store.df_filter_cache_misses,
                     store.df_filter_cache_hits))
    assert seen == [(1, 0), (1, 1)]
    rng = np.random.default_rng(1)
    store.upsert(["new"], _unit(rng, 1, D), [_words(rng, 8)],
                 [{"course": "c2"}])
    assert not store._df_filter_cache
    store.hybrid_topk_batch(q, terms, where, **KNOBS)
    assert (store.df_filter_cache_misses, store.df_filter_cache_hits) == (2, 1)
    store.hybrid_topk_batch(q, terms, None, **KNOBS)     # counts in neither
    assert (store.df_filter_cache_misses, store.df_filter_cache_hits) == (2, 1)


def test_timer_records_a_span_while_tracing_and_keeps_its_ring():
    m = Metrics()
    with m.tracing() as spans:
        with m.span("outer"):
            with m.timer("retrieve"):
                pass
    with m.timer("retrieve"):
        pass
    assert [s.name for s in spans] == ["retrieve", "outer"]
    inner, outer = spans
    assert inner.parent_id == outer.span_id == inner.batch_id
    snap = m.snapshot()
    assert snap["retrieve_count"] == 2 and "retrieve_mean_ms" in snap


def test_spans_nest_by_thread_and_tracing_is_not_reentrant():
    m = Metrics()
    with m.tracing() as spans:
        with m.span("main"):
            t = threading.Thread(target=lambda: m.span("other").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with pytest.raises(RuntimeError):
            with m.tracing():
                pass
    other, main = spans
    assert other.name == "other" and other.parent_id is None
    assert other.batch_id == other.span_id and main.batch_id == main.span_id
    with m.span("after") as sp:
        assert sp is None


def test_threads_record_every_span_with_unique_ids_and_own_parents():
    import os
    import sys

    m = Metrics()
    n_threads, n_batches = 2 * (os.cpu_count() or 4), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with m.tracing() as spans:
            def work(k):
                for _ in range(n_batches):
                    with m.span(f"root{k}"):
                        with m.span(f"child{k}"):
                            pass

            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(spans) == 2 * n_threads * n_batches
    by_id = {s.span_id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name.startswith("child"):
            parent = by_id[s.parent_id]
            assert parent.name == "root" + s.name[len("child"):]
            assert s.batch_id == parent.span_id
        else:
            assert s.parent_id is None and s.batch_id == s.span_id


def test_index_stats_lists_the_df_cache_counters(store):
    from types import SimpleNamespace

    from classmate_rag_tpu_torch.pipeline.stats import index_stats

    q, terms = _batch(seed=17)
    for _ in range(3):
        store.hybrid_topk_batch(q, terms, {"course": "c0"}, **KNOBS)
    rt = SimpleNamespace(store=store, catalog=[], sharded=None,
                         cfg=SimpleNamespace(dense_dir=store.directory,
                                             bm25_dir=store.directory,
                                             emb_cache_dir=store.directory))
    m = index_stats(runtime=rt)["maintenance"]
    assert (m["df_filter_cache_misses"], m["df_filter_cache_hits"]) == (1, 2)
    assert torch.is_tensor(store._df_filter_cache[next(iter(
        store._df_filter_cache))])
