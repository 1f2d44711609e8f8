"""The port's fused hybrid step and its parts
(classmate_rag_tpu_torch/ops/{mmr,fusion,hybrid_step}.py) vs the JAX
package's, on the same numpy-seeded arrays.

Tolerances: rows must be EQUAL (ties resolve to the lowest row on both
sides; test data keep real near-ties out). Scores are f32 on both sides
with sums in another order: vector distances and BM25 scores agree to
atol/rtol 1e-5, RRF fused scores (a sum of at most two exact terms) to
1e-6, NaN where a branch did not return the row on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from classmate_rag_tpu.ops import hybrid_step as jstep
from classmate_rag_tpu.ops.fusion import rrf_merge as j_rrf
from classmate_rag_tpu.ops.mmr import mmr_order as j_mmr
from classmate_rag_tpu_torch.index import lexical as tlex
from classmate_rag_tpu_torch.ops import hybrid_step as tstep
from classmate_rag_tpu_torch.ops.fusion import rrf_merge as t_rrf
from classmate_rag_tpu_torch.ops.mmr import mmr_order as t_mmr
from classmate_rag_tpu_torch.utils.numerics import NEG_INF


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, equal_nan=True)


def test_mmr_matches_batched():
    rng = np.random.default_rng(0)
    q = _unit(rng, 6, 32)
    cands = _unit(rng, 6, 24, 32)
    valid = rng.random((6, 24)) < 0.8
    valid[5] = False                 # exhausted pool → all -1
    valid[4, 3:] = False             # pool smaller than k
    got = t_mmr(torch.from_numpy(q), torch.from_numpy(cands),
                torch.from_numpy(valid), 8).numpy()
    for b in range(6):
        want = np.asarray(j_mmr(jnp.asarray(q[b]), jnp.asarray(cands[b]),
                                jnp.asarray(valid[b]), 8))
        assert got[b].tolist() == want.tolist()
    assert np.all(got[5] == -1)


def test_mmr_exact_ties_pick_lowest_index():
    q = np.zeros((1, 4), np.float32)
    q[0, 0] = 1.0
    cands = np.tile(q[:, None, :], (1, 6, 1))   # six identical candidates
    valid = np.ones((1, 6), bool)
    got = t_mmr(torch.from_numpy(q), torch.from_numpy(cands),
                torch.from_numpy(valid), 4).numpy()[0]
    want = np.asarray(j_mmr(jnp.asarray(q[0]), jnp.asarray(cands[0]),
                            jnp.asarray(valid[0]), 4))
    assert got.tolist() == want.tolist() == [0, 1, 2, 3]


def _rrf_cases():
    vec = np.array([[5, 3, 9, -1], [1, 2, -1, -1], [4, 6, 8, 10],
                    [-1, -1, -1, -1], [7, 7, 2, 1]], np.int32)
    bm = np.array([[3, 7, 5], [2, 1, -1], [11, 12, 13], [-1, -1, -1],
                   [1, 7, 9]], np.int32)
    vdist = np.array([[0.1, 0.2, 0.3, 0.0], [0.1, 0.2, 0, 0],
                      [0.5, 0.5, 0.5, 0.5], [0, 0, 0, 0],
                      [0.2, 0.2, 0.3, 0.4]], np.float32)
    bsc = np.array([[9.0, 8.0, 7.0], [5.0, 4.0, 0.0], [1.0, 1.0, 1.0],
                    [0, 0, 0], [3.0, 2.0, 1.0]], np.float32)
    return vec, bm, vdist, bsc


@pytest.mark.parametrize("weights,top_k", [((1.0, 1.0), 6), ((0.7, 1.3), 8),
                                           ((1.0, 1.0), 3)])
def test_rrf_matches(weights, top_k):
    """Duplicates, NaN branches, an empty query and exact fused ties
    (row 2: both lists at equal ranks, equal distances)."""
    vec, bm, vdist, bsc = _rrf_cases()
    got = t_rrf(*(torch.from_numpy(x) for x in (vec, bm, vdist, bsc)),
                *weights, 60, top_k)
    for b in range(len(vec)):
        want = j_rrf(jnp.asarray(vec[b]), jnp.asarray(bm[b]),
                     jnp.asarray(vdist[b]), jnp.asarray(bsc[b]),
                     *weights, 60, top_k)
        assert got[0][b].tolist() == np.asarray(want[0]).tolist()
        for g, w in zip(got[1:], want[1:]):
            _close(g[b].numpy(), w, 1e-6)
    assert np.isnan(got[3][2].numpy()).any()   # vector-only rows


def test_rescore_candidates_matches():
    rng = np.random.default_rng(1)
    q = _unit(rng, 4, 32)
    cand16 = _unit(rng, 4, 12, 32).astype(np.float16)
    rows = rng.permutation(100)[:48].reshape(4, 12).astype(np.int32)
    vals = rng.random((4, 12)).astype(np.float32)
    vals[0, 5:] = NEG_INF
    cand16[1, 7] = cand16[1, 2]                # exact tie: lower row first
    want = jstep.rescore_candidates(jnp.asarray(q), jnp.asarray(cand16),
                                    jnp.asarray(rows), jnp.asarray(vals))
    got = tstep.rescore_candidates(
        torch.from_numpy(q), torch.from_numpy(cand16),
        torch.from_numpy(rows).long(), torch.from_numpy(vals))
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    _close(got[1].numpy(), want[1])
    assert got[2].tolist() == np.asarray(want[2]).tolist()


@pytest.mark.parametrize("select", ["exact", "approx"])
def test_bm25_postprocess_ties_and_empty_terms(select):
    rng = np.random.default_rng(2)
    scores = np.zeros((4, 200), np.float32)
    scores[0, [3, 50, 120]] = [2.0, 2.0, 1.0]  # few matches: zero-score fill
    scores[1] = rng.integers(0, 3, size=200)   # heavy ties
    scores[2, 7] = 4.0
    bias = np.zeros(200, np.float32)
    bias[::7] = NEG_INF
    has_terms = np.array([[True], [True], [False], [True]])
    want = jstep._bm25_postprocess(jnp.asarray(scores), jnp.asarray(bias),
                                   jnp.asarray(has_terms), k_bm25=8,
                                   select=select)
    got = tstep._bm25_postprocess(torch.from_numpy(scores),
                                  torch.from_numpy(bias),
                                  torch.from_numpy(has_terms), k_bm25=8,
                                  select=select)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    _close(got[1].numpy(), want[1])
    assert np.all(got[0][2].numpy() == -1)


def _fixture(seed=3, n=900, d=64, b=16):
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(300)]
    w = 1.0 / np.arange(1, 301)
    w /= w.sum()
    docs = [list(rng.choice(words, size=int(rng.integers(5, 30)), p=w))
            for _ in range(n)]
    cap = 1024
    vocab = {}
    ids = np.full((cap, 16), -1, np.int32)
    tfs = np.zeros((cap, 16), np.uint8)
    dl = np.zeros(cap, np.float32)
    for i, doc in enumerate(docs):
        ids[i], tfs[i], dl[i] = tlex.pack_tokens(doc, vocab, 16)
    emb16 = np.zeros((cap, d), np.float16)
    emb16[:n] = _unit(rng, n, d)
    which = rng.integers(0, n, size=b)
    q = emb16[which].astype(np.float32) + 0.3 * rng.standard_normal(
        (b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    terms = [list(rng.choice(docs[i], size=min(4, len(docs[i])),
                             replace=False)) for i in which]
    terms[3] = []                      # empty-term query
    terms[5] = ["nowhere"]             # no vocab-known term
    lay = tlex.build_split_layout(ids, tfs, len(vocab),
                                  head_bytes_budget=40 * cap,
                                  head_df_threshold=20)
    q_terms, q_counts = tlex.pack_query_terms(vocab, terms, 8)
    qa = tlex.split_query_arrays(lay["lut"], lay["offsets"], q_terms,
                                 q_counts, r_cap=lay["r_cap"])
    return dict(n=n, emb16=emb16, ids=ids, tfs=tfs, dl=dl, q=q, lay=lay,
                qa=qa, q_terms=q_terms, q_counts=q_counts, vpad=4096)


def _bias_df(fx, filtered):
    cap = fx["ids"].shape[0]
    bias = np.full(cap, NEG_INF, np.float32)
    bias[: fx["n"]] = 0.0
    if filtered:
        bias[: fx["n"]: 3] = NEG_INF
    df = tlex.subset_df(torch.from_numpy(fx["ids"]),
                        torch.from_numpy(fx["tfs"]),
                        torch.from_numpy(bias == 0.0), fx["vpad"]).numpy()
    return bias, df


@pytest.mark.parametrize("select,with16,filtered", [
    ("exact", True, False), ("exact", False, False), ("exact", True, True),
    ("approx", True, False), ("approx", True, True), ("exact", False, True),
])
def test_fused_step_matches(select, with16, filtered):
    fx = _fixture()
    bias, df = _bias_df(fx, filtered)
    lay, qa = fx["lay"], fx["qa"]
    has_terms = np.any(fx["q_terms"] >= 0, axis=1, keepdims=True)
    emb16 = fx["emb16"]
    arrays = [lay["tf_head"], lay["post_rows"], lay["post_tfs"], fx["dl"], df,
              bias, fx["q"], qa["h_slots"], qa["h_tids"], qa["u_starts"],
              qa["u_lens"], qa["u_cols"], qa["t_tids"], fx["q_terms"],
              fx["q_counts"], has_terms]
    tail = [emb16 if with16 else None, fx["ids"], fx["tfs"]]
    kw = dict(k_vector=8, k_bm25=8, top_k=8, pool=24, vocab_pad=fx["vpad"],
              r_cap=lay["r_cap"], rescore_pool=32, select=select)
    want = jstep.hybrid_query_step_split(
        jnp.asarray(emb16).astype(jnp.bfloat16),
        *[jnp.asarray(x) for x in arrays],
        *[None if x is None else jnp.asarray(x) for x in tail], **kw)
    got = tstep.hybrid_query_step_split(
        torch.from_numpy(emb16).to(torch.bfloat16),
        *[torch.from_numpy(np.asarray(x)) for x in arrays],
        *[None if x is None else torch.from_numpy(x) for x in tail], **kw)
    want = jax.device_get(want)
    assert got.rows.numpy().tolist() == np.asarray(want.rows).tolist()
    _close(got.fused.numpy(), want.fused, 1e-6)
    _close(got.vec_dist.numpy(), want.vec_dist)
    _close(got.bm25_score.numpy(), want.bm25_score)
    assert np.all(np.isnan(got.bm25_score.numpy()[3]))   # empty terms
    assert (got.rows.numpy() >= 0).sum() > 8 * 12
    if filtered:
        live = got.rows.numpy()[got.rows.numpy() >= 0]
        assert np.all(live % 3 != 0)


def test_bm25_rescore_pool_matches_and_keeps_exact_ties():
    """Same values as the reference's gather pass; and two rows with the
    same term counts and length, packed in different slot orders, score
    bit-equal (the port sums in query-term order)."""
    rng = np.random.default_rng(4)
    n, width = 60, 10
    term_ids = np.full((n, width), -1, np.int32)
    tfs = np.zeros((n, width), np.uint8)
    for i in range(n):
        k = int(rng.integers(2, width + 1))
        term_ids[i, :k] = rng.permutation(40)[:k]
        tfs[i, :k] = rng.integers(1, 6, size=k)
    term_ids[7] = term_ids[3][::-1]
    tfs[7] = tfs[3][::-1]
    dl = rng.uniform(5, 40, size=n).astype(np.float32)
    dl[7] = dl[3]
    idf = rng.uniform(0.1, 3.0, size=513).astype(np.float32)
    rows = np.stack([rng.permutation(n)[:16] for _ in range(3)]).astype(
        np.int32)
    rows[0, :2] = [3, 7]
    q_tids = np.full((3, 6), -1, np.int32)
    q_tids[:, :4] = np.stack([rng.permutation(40)[:4] for _ in range(3)])
    q_tids[0, :4] = term_ids[3, :4]
    q_counts = rng.integers(1, 3, size=(3, 6)).astype(np.float32)
    want = np.asarray(jstep.bm25_rescore_pool(
        jnp.asarray(rows), jnp.asarray(term_ids), jnp.asarray(tfs),
        jnp.asarray(dl), jnp.float32(20.0), jnp.asarray(idf),
        jnp.asarray(q_tids), jnp.asarray(q_counts), 512))
    got = tstep.bm25_rescore_pool(
        torch.from_numpy(rows), torch.from_numpy(term_ids),
        torch.from_numpy(tfs), torch.from_numpy(dl), torch.tensor(20.0),
        torch.from_numpy(idf), torch.from_numpy(q_tids),
        torch.from_numpy(q_counts)).numpy()
    _close(got, want)
    assert got[0, 0] == got[0, 1] > 0
