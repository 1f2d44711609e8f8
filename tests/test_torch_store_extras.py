"""The port's last store, BM25, step and config functions against the
JAX package's: ``ops/hybrid_step.hybrid_query_step``,
``IndexStore.rows_to_ids`` / ``device_seconds_per_batch``,
``SearchResult``, ``lexical.bm25_oracle_scores`` and
``config.config_as_dict``.

Tolerances: rows must be EQUAL; fused RRF scores agree within 1e-5
(sums of at most two exact terms, as in test_torch_hybrid_step.py);
vector distances and BM25 scores within 1e-5 (f32, sums in another
order); the pure-Python oracle is bit-equal to the JAX package's (the
same float64 operations in the same order) and within rtol 1e-5 of the
store's f32 BM25.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from classmate_rag_tpu_torch import config as tcfg
from classmate_rag_tpu_torch.index import lexical as tlex
from classmate_rag_tpu_torch.index import store as tstore_mod
from classmate_rag_tpu_torch.ops.hybrid_step import (
    hybrid_query_step,
    hybrid_query_step_split_packed,
)

try:
    import jax.numpy as jnp

    from classmate_rag_tpu import config as jcfg
    from classmate_rag_tpu.index import lexical as jlex
    from classmate_rag_tpu.index import store as jstore_mod
    from classmate_rag_tpu.ops.hybrid_step import hybrid_query_step as j_step
except ImportError:   # no JAX installed: only the cuda cases run
    jnp = None


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs the JAX package (the reference side)")


DIM = 64

DOCS = [
    "the derivative measures the rate of change of a function",
    "the integral accumulates the area under a curve",
    "matrix multiplication composes linear transformations",
    "eigenvalues and eigenvectors characterize linear maps",
    "derivative rules include the product rule and chain rule",
    "cooking pasta requires boiling water and adding salt",
    "gradient descent updates parameters against the gradient",
    "the chain rule differentiates composed functions",
]


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _both_stores(tmp_path, ids, embs, tokens, metas, **kw):
    """A JAX store and a CPU port store, given the same upserts."""
    j = jstore_mod.IndexStore(embs.shape[1], tmp_path / "j", **kw)
    t = tstore_mod.IndexStore(embs.shape[1], tmp_path / "t", device="cpu",
                              **kw)
    for s in (j, t):
        s.upsert(ids, embs, tokens, metas)
    return j, t


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """test_parallel.py's single-device corpus, in both packages."""
    rng = np.random.default_rng(11)
    ids = [f"id{i}" for i in range(len(DOCS))]
    embs = _unit(rng, len(DOCS), DIM)
    tokens = [tlex.tokenize(t, "en") for t in DOCS]
    metas = [{"course": "math" if i < 5 else "misc"}
             for i in range(len(DOCS))]
    return _both_stores(tmp_path_factory.mktemp("built"), ids, embs, tokens,
                        metas, slab_rows=16, terms_per_chunk=32)


def _query_arrays(store):
    """test_parallel.py's query arrays: a two-term query and one whose
    only term is outside the math subset."""
    rng = np.random.default_rng(5)
    q_vecs = _unit(rng, 2, DIM)
    q_terms = np.full((2, 8), -1, np.int32)
    q_counts = np.zeros((2, 8), np.float32)
    for j, t in enumerate(tlex.tokenize("derivative rule", "en")[:8]):
        tid = store.vocab.get(t)
        if tid is not None:
            q_terms[0, j] = tid
            q_counts[0, j] = 1.0
    q_terms[1, 0] = store.vocab.get("pasta", -1)
    q_counts[1, 0] = 1.0
    return q_vecs, q_terms, q_counts


@pytest.mark.parametrize("where", [None, {"course": "math"}])
@pytest.mark.parametrize("knobs", [
    dict(k_vector=3, k_bm25=3, top_k=4, pool=2),
    dict(k_vector=4, k_bm25=4, top_k=6, pool=6),
    dict(k_vector=3, k_bm25=5, top_k=8, pool=8, use_mmr=False),
])
def test_hybrid_query_step_matches_jax(built, where, knobs):
    jst, tst = built
    vpad = jst.vocab_pad
    assert tst.vocab_pad == vpad and tst.vocab == jst.vocab
    q_vecs, q_terms, q_counts = _query_arrays(jst)

    jdev = jst._sync_device()
    jbias = jst._mask_bias(where)
    subset_df, _ = jlex.device_fns()
    jdf = subset_df(jdev["term_ids"], jdev["tfs"],
                    jbias == 0.0 if where else jnp.asarray(jst.valid), vpad)
    want = j_step(jdev["emb"], jdev["term_ids"], jdev["tfs"],
                  jdev["doc_len"], jdf, jbias, jnp.asarray(q_vecs),
                  jnp.asarray(q_terms), jnp.asarray(q_counts),
                  vocab_pad=vpad, **knobs)

    tdev = tst._sync_device()
    tbias = tst._mask_bias(where)
    tdf = tst._df_for_where(where, tbias, vpad)
    np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))
    got = hybrid_query_step(
        tdev["emb"], tdev["term_ids"], tdev["tfs"], tdev["doc_len"], tdf,
        tbias, torch.from_numpy(q_vecs), torch.from_numpy(q_terms),
        torch.from_numpy(q_counts), vocab_pad=vpad, **knobs)

    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    assert (got.rows >= 0).any()
    for a, b in ((got.fused, want.fused), (got.vec_dist, want.vec_dist),
                 (got.bm25_score, want.bm25_score)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
    if where:
        rows = got.rows.numpy()
        assert set(rows[rows >= 0].tolist()) <= set(range(5))


@pytest.fixture(scope="module")
def zipf_store():
    """A port store over a zipf word soup (400 chunks, 300 words), the
    dense scan without the f16 rescore so that both steps read the same
    bf16 scores."""
    rng = np.random.default_rng(3)
    vocab = [f"t{chr(97 + i % 26)}{chr(97 + i // 26)}" for i in range(300)]
    p = 1.0 / np.arange(1, 301)
    p /= p.sum()
    docs = [[vocab[i] for i in rng.choice(300, size=int(n), p=p)]
            for n in rng.integers(20, 60, size=400)]
    emb = _unit(rng, 400, 32)
    store = tstore_mod.IndexStore(32, slab_rows=128, terms_per_chunk=64,
                                  rescore="off", device="cpu")
    store.upsert([f"c{i}" for i in range(400)], emb, docs,
                 [{"course": f"c{i % 3}"} for i in range(400)])
    queries = []
    for _ in range(24):
        d = int(rng.integers(0, 400))
        qv = emb[d] + 0.3 * rng.standard_normal(32).astype(np.float32)
        terms = list(rng.choice(docs[d], size=2, replace=False))
        queries.append((qv / np.linalg.norm(qv), terms))
    return store, queries


@pytest.mark.parametrize("where", [None, {"course": "c1"}])
def test_nonsplit_step_equals_split_step(zipf_store, where):
    store, queries = zipf_store
    q = np.stack([qv for qv, _t in queries])
    terms = [t for _q, t in queries]
    knobs = dict(k_vector=8, k_bm25=8, top_k=8, pool=24)
    args, kwargs = store.hybrid_step_inputs(q, terms, where, **knobs)
    split = hybrid_query_step_split_packed(*args, **kwargs)
    dev = store._sync_device()
    q_terms, q_counts = tlex.pack_query_terms(store.vocab, terms, 32)
    whole = hybrid_query_step(
        dev["emb"], dev["term_ids"], dev["tfs"], dev["doc_len"], args[5],
        args[6], args[7], torch.from_numpy(q_terms),
        torch.from_numpy(q_counts), vocab_pad=store.vocab_pad, **knobs)
    np.testing.assert_array_equal(whole.rows.numpy(), split.rows.numpy())
    np.testing.assert_allclose(whole.fused.numpy(), split.fused.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(whole.bm25_score.numpy(),
                               split.bm25_score.numpy(), rtol=1e-5,
                               atol=1e-5, equal_nan=True)


def _eps_corpus(seed):
    """Random docs over 30 words; 'the' is in ~80 % of them, so its idf
    is negative and the ε rule replaces it."""
    rng = np.random.default_rng(seed)
    words = [f"w{chr(97 + i)}" for i in range(26)] + ["xa", "xb", "xc",
                                                      "the"]
    docs = []
    for _ in range(int(rng.integers(20, 60))):
        doc = [words[i] for i in rng.integers(0, 29, size=int(
            rng.integers(3, 15)))]
        if rng.random() < 0.8:
            doc += ["the"] * int(rng.integers(1, 3))
        docs.append(doc)
    queries = [["the"], ["the", "wa", "wb"], ["xa", "xa", "zz"],
               list(rng.choice(words, size=4))]
    return docs, queries


@pytest.mark.parametrize("seed", range(4))
def test_bm25_oracle_matches_jax(seed):
    docs, queries = _eps_corpus(seed)
    for q in queries:
        assert (tlex.bm25_oracle_scores(docs, q)
                == jlex.bm25_oracle_scores(docs, q))
    assert tlex.bm25_oracle_scores([], ["a"]) == []
    assert tlex.bm25_oracle_scores([[]], ["a"]) == [0.0]


@pytest.mark.parametrize("seed", range(3))
def test_bm25_oracle_matches_store(seed):
    docs, queries = _eps_corpus(seed)
    n = len(docs)
    store = tstore_mod.IndexStore(8, slab_rows=64, terms_per_chunk=32,
                                  device="cpu")
    store.upsert([f"d{i}" for i in range(n)],
                 _unit(np.random.default_rng(seed), n, 8), docs,
                 [{}] * n)
    for q in queries:
        want = np.asarray(tlex.bm25_oracle_scores(docs, q))
        vals, rows = store.bm25_topk(q, k=n)
        got = np.zeros(n)
        got[rows[rows >= 0]] = vals[rows >= 0]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# Fields that only one package's Config has, with the reason: none.
ONLY_ONE_CONFIG = {}


def test_config_as_dict_matches_jax(monkeypatch):
    for mod in (jcfg, tcfg):
        monkeypatch.setattr(mod, "_SINGLETON", None)
    for var, val in (("EMBEDDING_BACKEND", "hash"), ("K_VECTOR", "5"),
                     ("DENSE_SELECT", "exact"), ("LLM_TEMPERATURE", "0.3"),
                     ("USE_MMR", "0"), ("N_SHARDS", "2"),
                     ("ENCODER_CHECKPOINT", "/ck")):
        monkeypatch.setenv(var, val)
    got = tcfg.config_as_dict()
    want = jcfg.config_as_dict()
    assert set(got) ^ set(want) == set(ONLY_ONE_CONFIG)
    assert {k: got[k] for k in want} == want
    assert got["k_vector"] == 5 and got["use_mmr"] is False
    assert tcfg.config_as_dict(tcfg.load_config(reload=True)) == got


def test_rows_to_ids_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    n = 40
    ids = [f"r{i}" for i in range(n)]
    docs = [[f"w{chr(97 + i % 26)}"] * (1 + i % 3) for i in range(n)]
    j, t = _both_stores(tmp_path, ids, _unit(rng, n, 16), docs,
                        [{"course": "a"}] * n, slab_rows=32,
                        terms_per_chunk=8)
    for s in (j, t):
        assert s.delete(["r3", "r17", "r39"]) == 3
        s.upsert(["r3", "new"], _unit(rng, 2, 16), [["wa"], ["wb"]],
                 [{}, {}])
    rows = [-5, -1, 0, 3, 17, 39, 40, t.n_rows - 1, t.n_rows, t.n_rows + 7,
            t.capacity, t.capacity + 3]
    assert t.rows_to_ids(rows) == j.rows_to_ids(rows)
    assert t.rows_to_ids(rows)[:4] == [None, None, "r0", "r3"]
    assert t.rows_to_ids([]) == []


def test_search_result_matches_jax():
    fields = [(f.name, f.type) for f in dataclasses.fields(
        tstore_mod.SearchResult)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(
        jstore_mod.SearchResult)]
    r = tstore_mod.SearchResult(row=3, id="c3", score=0.5)
    assert dataclasses.astuple(r) == dataclasses.astuple(
        jstore_mod.SearchResult(3, "c3", 0.5))


@pytest.mark.parametrize("where", [None, {"course": "c2"}])
def test_device_seconds_per_batch_cpu(zipf_store, where):
    store, queries = zipf_store
    q = np.stack([qv for qv, _t in queries])
    terms = [t for _q, t in queries]
    before = store.hybrid_topk_batch(q, terms, where)
    secs = store.device_seconds_per_batch(q, terms, where, iters=3,
                                          top_k=8, pool=24)
    assert secs > 0 and store.device_timing == "wall"
    after = store.hybrid_topk_batch(q, terms, where)
    for a, b in zip(after, before):
        assert torch.equal(torch.nan_to_num(a, nan=-7.0),
                           torch.nan_to_num(b, nan=-7.0))


@pytest.fixture(scope="module")
def card_store():
    """60,000 chunks × 768 on the card, and a batch of 256 queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: times the scan kernel's batch")
    rng = np.random.default_rng(0)
    n, d, b = 60_000, 768, 256
    vocab = [f"w{i}" for i in range(2000)]
    docs = [[vocab[i] for i in rng.integers(0, 2000, size=60)]
            for _ in range(n)]
    emb = _unit(rng, n, d)
    store = tstore_mod.IndexStore(d, slab_rows=4096, terms_per_chunk=64,
                                  device="cuda")
    store.upsert([f"c{i}" for i in range(n)], emb, docs,
                 [{"course": f"c{i % 3}"} for i in range(n)])
    q = emb[:b] + 0.1 * _unit(rng, b, d)
    return store, q, [docs[i][:3] for i in range(b)]


@pytest.mark.cuda
def test_device_seconds_within_wall_on_card(card_store):
    """The card's time for a batch (each call held behind a spin) is at
    most the wall time of one ``hybrid_topk_batch`` ending in a host
    fetch."""
    store, q, terms = card_store
    for _ in range(3):
        store.hybrid_topk_batch(q, terms).rows.cpu()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        store.hybrid_topk_batch(q, terms).rows.cpu()
        walls.append(time.perf_counter() - t0)
    secs = store.device_seconds_per_batch(q, terms, iters=16)
    assert store.device_timing == "held stream"
    assert 0 < secs <= min(walls), (secs, walls)


@pytest.mark.cuda
@pytest.mark.parametrize("select", ["exact", "approx"])
@pytest.mark.parametrize("where", [None, {"course": "c1"}])
def test_step_never_waits_for_the_host_on_card(card_store, select, where):
    """The fused step queues its work and returns: no call in it waits
    for the card (torch's sync debug mode raises on one)."""
    store, q, terms = card_store
    store.select = select
    try:
        args, kwargs = store.hybrid_step_inputs(q, terms, where)
        assert kwargs["select"] == select
        want = hybrid_query_step_split_packed(*args, **kwargs).rows.cpu()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = hybrid_query_step_split_packed(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(out.rows.cpu(), want)
    finally:
        store.select = "auto"
