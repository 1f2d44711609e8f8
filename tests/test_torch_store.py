"""The port's IndexStore (classmate_rag_tpu_torch/index/store.py) vs the
JAX package's IndexStore, driven through the same upserts, deletes,
re-upserts and filters on numpy-seeded data.

Tolerances: rows must be EQUAL; scores are f32 on both sides with sums
in another order and agree to atol/rtol 1e-5 (NaN where a branch did
not return the row on both sides).
"""

import numpy as np
import pytest
import torch

import jax

from classmate_rag_tpu.index.store import IndexStore as JStore
from classmate_rag_tpu_torch.index.store import IndexStore as TStore

D = 32
FILTERS = [
    None,
    {"course": "c1"},
    {"tags": "tag2"},
    {"course": "c2", "language": "en"},
    {"language": "auto", "doc_type": "other"},   # sentinels: no narrowing
    {"course": "no-such-course"},                # unknown value: empty
    {"tags": "tag1,no-such-tag"},                # impossible tag: empty
]


def _meta(i, salt=0):
    meta = {"course": f"c{(i + salt) % 3}",
            "language": "it" if i % 2 else "en", "doc_type": "txt"}
    if (i + salt) % 4:
        meta[f"tag_tag{(i + salt) % 3}"] = True
    return meta


def _docs(rng, lengths):
    """Zipf word soup. Every document gets its own length: rows with
    equal term counts and equal lengths would tie exactly in BM25, and
    the reference's fast-mode rescore resolves such ties by rounding
    noise (its sum order), not by row."""
    words = [f"t{i}" for i in range(200)]
    w = 1.0 / np.arange(1, 201)
    w /= w.sum()
    return [list(rng.choice(words, size=int(n), p=w)) for n in lengths]


def _unit(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _mutate(stores, rng):
    """Upsert 300, delete 40, re-upsert 30 changed, add 250 (grows the
    capacity past two slabs). Returns the docs and vectors."""
    lengths = 4 + rng.permutation(580)
    docs = _docs(rng, lengths[:550])
    emb = _unit(rng, 550)
    ids = [f"c{i}" for i in range(550)]
    for s in stores:
        s.upsert(ids[:300], emb[:300], docs[:300],
                 [_meta(i) for i in range(300)])
    yield docs, emb
    for s in stores:
        s.delete(ids[10:50])
    yield docs, emb
    re = list(range(20, 50))
    emb[re] = _unit(rng, len(re))
    for i, doc in zip(re, _docs(rng, lengths[550:])):
        docs[i] = doc
    for s in stores:
        s.upsert([ids[i] for i in re], emb[re], [docs[i] for i in re],
                 [_meta(i, salt=1) for i in re])
        s.upsert(ids[300:], emb[300:], docs[300:],
                 [_meta(i) for i in range(300, 550)])
    yield docs, emb


def _queries(rng, docs, emb, b=8):
    which = rng.integers(0, len(docs), size=b)
    q = emb[which] + 0.3 * rng.standard_normal((b, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    terms = [list(docs[i][:3]) for i in which]
    terms[1] = []
    return q.astype(np.float32), terms


def _same_batch(js, ts, q, terms, where):
    want = jax.device_get(js.hybrid_topk_batch(q, terms, where))
    got = ts.hybrid_topk_batch(q, terms, where)
    assert got.rows.numpy().tolist() == np.asarray(want.rows).tolist()
    for g, w in ((got.fused, want.fused), (got.vec_dist, want.vec_dist),
                 (got.bm25_score, want.bm25_score)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
    return got


@pytest.mark.parametrize("select", ["auto", "approx"])
def test_store_matches_through_mutations(tmp_path, select):
    rng = np.random.default_rng(0)
    js = JStore(D, tmp_path, slab_rows=256, terms_per_chunk=16,
                select=select)
    ts = TStore(D, slab_rows=256, terms_per_chunk=16, select=select,
                device="cpu")
    for step, (docs, emb) in enumerate(_mutate([js, ts], rng)):
        assert ts.capacity == js.capacity and ts.select_mode == js.select_mode
        q, terms = _queries(rng, docs, emb)
        for where in FILTERS:
            got = _same_batch(js, ts, q, terms, where)
            if where and "no-such" in str(where):
                assert np.all(got.rows.numpy() == -1)
        # The per-branch entry points.
        for where in FILTERS[:3]:
            jv, jr = js.dense_topk(q[:2], where, 8)
            tv, tr = ts.dense_topk(q[:2], where, 8)
            assert np.array_equal(jr, tr)
            np.testing.assert_allclose(jv, tv, rtol=1e-5, atol=1e-5)
            jv, jr = js.bm25_topk(terms[0], where, 8)
            tv, tr = ts.bm25_topk(terms[0], where, 8)
            assert np.array_equal(jr, tr)
            np.testing.assert_allclose(jv, tv, rtol=1e-5, atol=1e-5)
        # The O(corpus) paths run exactly when the JAX package's do: the
        # deletes sync O(delta); the capacity growth re-uploads and
        # rebuilds. The host df is built once.
        for name in ("device_full_uploads", "split_full_builds",
                     "split_snapshot_restores", "df_full_builds"):
            assert getattr(ts, name) == getattr(js, name), name
        assert ts.device_full_uploads == (1, 1, 2)[step]
        assert ts.df_full_builds == 1
    assert ts.capacity == 1024 and len(ts) == len(js) == 540


def test_from_host_state_matches_jax_store(tmp_path):
    rng = np.random.default_rng(1)
    js = JStore(D, tmp_path, slab_rows=256, terms_per_chunk=16)
    for docs, emb in _mutate([js], rng):
        pass
    state = {
        "ids": list(js.ids), "emb": js.emb, "term_ids": js.term_ids,
        "tfs": js.tfs, "doc_len": js.doc_len, "valid": js.valid,
        "field_cols": js.field_cols, "tag_bits": js.tag_bits,
        "vocab": dict(js.vocab),
        "interns": {f: dict(t.to_id) for f, t in js.interns.items()},
        "tag_slots": dict(js.tag_slots),
    }
    ts = TStore.from_host_state(state, device="cpu", slab_rows=256)
    assert ts.n_rows == js.n_rows and ts.capacity == js.capacity
    q, terms = _queries(rng, docs, emb)
    for where in FILTERS:
        _same_batch(js, ts, q, terms, where)
    # host_state round-trips.
    again = TStore.from_host_state(ts.host_state(), device="cpu")
    a = ts.hybrid_topk_batch(q, terms, FILTERS[1])
    b = again.hybrid_topk_batch(q, terms, FILTERS[1])
    assert torch.equal(a.rows, b.rows)
    assert ts.device_full_uploads == 1 and ts.split_full_builds == 1


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TStore(D)
