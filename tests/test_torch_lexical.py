"""The port's lexical module (classmate_rag_tpu_torch/index/lexical.py)
vs the JAX package's ``index/lexical.py``, on the same numpy-seeded data.

Host copies must give EQUAL arrays. Device math is f32 on both sides with
sums in different orders: exact-mode scores agree to atol 1e-5 (rtol
1e-5); fast mode rounds operands to bf16 on both sides and agrees to
1e-4; df counts are integers and must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from classmate_rag_tpu.index import lexical as jlex
from classmate_rag_tpu_torch.index import lexical as tlex

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lambda", "mu", "nu", "xi", "omicron",
         "pi", "rho", "sigma", "tau", "upsilon", "phi", "chi", "psi",
         "omega"]


def _corpus(seed=0, n=300, vocab=400):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, vocab + 1)
    w /= w.sum()
    docs = []
    for _ in range(n):
        ln = int(rng.integers(5, 40))
        docs.append([f"t{i}" for i in rng.choice(vocab, size=ln, p=w)])
    return rng, docs


def _packed(docs, width=24):
    vocab = {}
    ids = np.full((len(docs), width), -1, np.int32)
    tfs = np.zeros((len(docs), width), np.uint8)
    dl = np.zeros(len(docs), np.float32)
    for i, d in enumerate(docs):
        ids[i], tfs[i], dl[i] = tlex.pack_tokens(d, vocab, width)
    return vocab, ids, tfs, dl


@pytest.mark.parametrize("lang", ["en", "it", None])
def test_tokenizer_matches(lang):
    rng = np.random.default_rng(1)
    pool = WORDS + ["The", "di", "perché", "È", "x", "naïve", "ÀÖØ",
                    "l'acqua", "a1b2", "--", "über"]
    for _ in range(50):
        text = " ".join(rng.choice(pool, size=12))
        assert tlex.tokenize_py(text, lang) == jlex.tokenize_py(text, lang)


def test_pack_tokens_and_query_terms_match():
    _, docs = _corpus()
    jv, tv = {}, {}
    for d in docs[:50]:
        a = jlex.pack_tokens(d, jv, 8)
        b = tlex.pack_tokens(d, tv, 8)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2] == b[2]
    assert jv == tv
    queries = [docs[i][:6] + ["unknown"] for i in range(10)] + [[]]
    a = jlex.pack_query_terms(jv, queries, 4)
    b = tlex.pack_query_terms(tv, queries, 4)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# (head byte budget, df threshold): the second overflows the 128-slot
# minimum head, so heavy terms fall to segmented tail postings.
LAYOUTS = [(1 << 20, 8), (600, 1)]


@pytest.mark.parametrize("budget,thr", LAYOUTS)
def test_split_layout_and_query_arrays_match(budget, thr):
    _, docs = _corpus(seed=2)
    vocab, ids, tfs, _ = _packed(docs)
    kw = dict(head_bytes_budget=budget, head_df_threshold=thr, seg_cap=4)
    a = jlex.build_split_layout(ids, tfs, len(vocab), **kw)
    b = tlex.build_split_layout(ids, tfs, len(vocab), **kw)
    assert set(b) <= set(a)
    for key in b:
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
    if budget < 1000:
        assert b["n_overflow"] > 0
    q_terms, q_counts = tlex.pack_query_terms(
        vocab, [d[:8] for d in docs[:16]], 8
    )
    qa = jlex.split_query_arrays(a["lut"], a["offsets"], q_terms, q_counts,
                                 r_cap=a["r_cap"])
    qb = tlex.split_query_arrays(b["lut"], b["offsets"], q_terms, q_counts,
                                 r_cap=b["r_cap"])
    for key in qb:
        assert np.array_equal(qa[key], qb[key]), key


def _stats(seed=3):
    rng = np.random.default_rng(seed)
    df = rng.integers(0, 200, size=513).astype(np.float32)
    df[-1] = 0.0
    return df, np.float32(150.0)


def test_okapi_idf_weights_sat_rows_match():
    df, n_sub = _stats()
    a = np.asarray(jlex.okapi_idf(jnp.asarray(df), jnp.float32(n_sub)))
    b = tlex.okapi_idf(torch.from_numpy(df), torch.tensor(n_sub)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert (b < 0).sum() == 0  # ε rule replaced every negative idf

    rng = np.random.default_rng(4)
    q_terms = np.full((3, 6), -1, np.int32)
    q_terms[0, :4] = [5, 9, 9, 500]          # duplicate term adds
    q_terms[1, :2] = [1, 2]
    q_counts = rng.integers(1, 3, size=(3, 6)).astype(np.float32)
    tw = tlex.okapi_query_weights(
        torch.from_numpy(b), torch.from_numpy(q_terms),
        torch.from_numpy(q_counts), 512,
    ).numpy()
    for i in range(3):
        jw = np.asarray(jlex.okapi_query_weights(
            jnp.asarray(a), jnp.asarray(q_terms[i]), jnp.asarray(q_counts[i]),
            512,
        ))
        np.testing.assert_allclose(tw[i], jw, rtol=1e-5, atol=1e-5)
    assert np.all(tw[:, 512] == 0.0) and np.all(tw[2] == 0.0)

    term_ids = rng.integers(-1, 512, size=(40, 7)).astype(np.int32)
    tfs = rng.integers(0, 5, size=(40, 7)).astype(np.uint8)
    dl = rng.uniform(5, 50, size=40).astype(np.float32)
    sj = np.asarray(jlex.okapi_score_rows(
        jnp.asarray(term_ids), jnp.asarray(tfs), jnp.asarray(dl),
        jnp.float32(20.0), jnp.asarray(tw[0]), 512,
    ))
    st = tlex.okapi_score_rows(
        torch.from_numpy(term_ids), torch.from_numpy(tfs),
        torch.from_numpy(dl), torch.tensor(20.0), torch.from_numpy(tw[0]),
        512,
    ).numpy()
    np.testing.assert_allclose(sj, st, rtol=1e-5, atol=1e-5)


def test_subset_df_matches():
    _, docs = _corpus(seed=5)
    vocab, ids, tfs, _ = _packed(docs)
    keep = np.random.default_rng(6).random(len(docs)) < 0.4
    subset_df, _ = jlex.device_fns()
    a = np.asarray(subset_df(jnp.asarray(ids), jnp.asarray(tfs),
                             jnp.asarray(keep), 512))
    b = tlex.subset_df(torch.from_numpy(ids), torch.from_numpy(tfs),
                       torch.from_numpy(keep), 512).numpy()
    assert np.array_equal(a, b)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("budget,thr", LAYOUTS)
def test_bm25_split_score_core_matches(fast, budget, thr):
    _, docs = _corpus(seed=7)
    vocab, ids, tfs, dl = _packed(docs)
    vpad = 512
    lay = tlex.build_split_layout(ids, tfs, len(vocab),
                                  head_bytes_budget=budget,
                                  head_df_threshold=thr, seg_cap=4)
    if budget < 1000:
        assert lay["n_overflow"] > 0 and int(np.diff(lay["offsets"]).max()) > 4
    keep = np.random.default_rng(8).random(len(docs)) < 0.8
    df = tlex.subset_df(torch.from_numpy(ids), torch.from_numpy(tfs),
                        torch.from_numpy(keep), vpad).numpy()
    n_sub = np.float32(keep.sum())
    idf = tlex.okapi_idf(torch.from_numpy(df), torch.tensor(n_sub)).numpy()
    avgdl = np.float32(dl[keep].sum() / n_sub)
    q_terms, q_counts = tlex.pack_query_terms(
        vocab, [docs[i][:6] + docs[i][:2] for i in range(0, 64, 4)], 8
    )
    qa = tlex.split_query_arrays(lay["lut"], lay["offsets"], q_terms,
                                 q_counts, r_cap=lay["r_cap"])
    args = [lay["tf_head"], lay["post_rows"], lay["post_tfs"], dl, keep, idf,
            avgdl, qa["h_slots"], qa["h_tids"], qa["u_starts"], qa["u_lens"],
            qa["u_cols"], qa["t_tids"], q_terms, q_counts]
    kw = dict(vocab_pad=vpad, r_cap=lay["r_cap"], fast=fast)
    a = np.asarray(jlex.bm25_split_score_core(
        *[jnp.asarray(x) for x in args], **kw))
    b = tlex.bm25_split_score_core(
        *[torch.as_tensor(np.asarray(x)) for x in args], **kw).numpy()
    tol = 1e-4 if fast else 1e-5
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    assert np.count_nonzero(b) > 0
