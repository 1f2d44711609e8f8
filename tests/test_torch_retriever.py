"""The port's HybridRetriever (classmate_rag_tpu_torch/retrieval/hybrid.py)
vs the JAX package's, over the same word-soup corpus, embedder and
questions.

Tolerances: ids and their order must be EQUAL; fused scores agree to
1e-6, vector distances and BM25 scores to atol/rtol 1e-5, and a branch
that did not return a chunk reports None on both sides.
"""

import numpy as np
import pytest

from classmate_rag_tpu.embeddings.hashing import HashingEmbedder as JEmb
from classmate_rag_tpu.index.catalog import Catalog as JCatalog
from classmate_rag_tpu.index.catalog import CatalogEntry as JEntry
from classmate_rag_tpu.index.lexical import tokenize_py as j_tokenize
from classmate_rag_tpu.index.store import IndexStore as JStore
from classmate_rag_tpu.retrieval.hybrid import HybridRetriever as JRet
from classmate_rag_tpu_torch.embeddings.hashing import HashingEmbedder as TEmb
from classmate_rag_tpu_torch.index.catalog import Catalog as TCatalog
from classmate_rag_tpu_torch.index.catalog import CatalogEntry as TEntry
from classmate_rag_tpu_torch.index.store import IndexStore as TStore
from classmate_rag_tpu_torch.retrieval.hybrid import HybridRetriever as TRet

D = 64
SYLL = ["ka", "lo", "mi", "ne", "ru", "sa", "te", "vo", "zi", "pa", "qu",
        "de"]


def _corpus(n=400, seed=0):
    rng = np.random.default_rng(seed)
    words = sorted({a + b + c for a in SYLL for b in SYLL for c in SYLL})
    words = [words[i] for i in rng.permutation(len(words))[:300]]
    w = 1.0 / np.arange(1, len(words) + 1)
    w /= w.sum()
    texts = [" ".join(rng.choice(words, size=int(rng.integers(6, 40)), p=w))
             for _ in range(n)]
    metas = [{"course": f"c{i % 4}", "language": "en",
              **({"tag_lab": True} if i % 3 == 0 else {})} for i in range(n)]
    questions = [" ".join(rng.choice(words, size=int(rng.integers(1, 6))))
                 for _ in range(11)]
    questions[4] = "   "             # blank question: empty result
    questions[7] = "the of and"      # stopwords only: dense-only
    return texts, metas, questions


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    texts, metas, questions = _corpus()
    ids = [f"doc{i}" for i in range(len(texts))]
    tokens = [j_tokenize(t, "en") for t in texts]
    je, te = JEmb(D), TEmb(D)
    vecs = je.encode_passages(texts)
    assert np.array_equal(vecs, te.encode_passages(texts))
    js = JStore(D, tmp_path_factory.mktemp("idx"), slab_rows=256,
                terms_per_chunk=32)
    ts = TStore(D, slab_rows=256, terms_per_chunk=32, device="cpu")
    jc = JCatalog.load_or_create(tmp_path_factory.mktemp("cat"))
    tc = TCatalog()
    for s in (js, ts):
        s.upsert(ids, vecs, tokens, metas)
    for i, cid in enumerate(ids):
        jc.upsert(JEntry(cid, texts[i], tokens[i], metas[i]))
        tc.upsert(TEntry(cid, texts[i], tokens[i], metas[i]))
    return JRet(js, jc, je), TRet(ts, tc, te), questions


def _same(a, b):
    assert [x["id"] for x in a] == [x["id"] for x in b]
    for x, y in zip(a, b):
        assert x["document"] == y["document"]
        assert x["metadata"] == y["metadata"]
        for key, tol in (("fused", 1e-6), ("vector_distance", 1e-5),
                         ("bm25_score", 1e-5)):
            u, v = x["scores"][key], y["scores"][key]
            assert (u is None) == (v is None), key
            if u is not None:
                assert abs(u - v) <= tol * (1 + abs(u)), key


@pytest.mark.parametrize("filters", [None, {"course": "c2"},
                                     {"tags": "lab"}, {"course": "nope"}])
def test_retrieve_batch_matches(pair, filters):
    jr, tr, questions = pair
    want = jr.retrieve_batch(questions=questions, filters=filters)
    got = tr.retrieve_batch(questions=questions, filters=filters)
    assert len(got) == len(questions)
    for a, b in zip(want, got):
        _same(a, b)
    assert got[4] == []
    if filters == {"course": "nope"}:
        assert all(g == [] for g in got)
    else:
        assert sum(len(g) for g in got) >= 8 * 9
        assert all(x["scores"]["bm25_score"] is None for x in got[7])


@pytest.mark.parametrize("hybrid", [True, False])
def test_single_retrieve_matches(pair, hybrid):
    jr, tr, questions = pair
    for q in questions[:3]:
        want = jr.retrieve(question=q, top_k=5, hybrid=hybrid)
        got = tr.retrieve(question=q, top_k=5, hybrid=hybrid)
        _same(want, got)
        assert len(got) == 5
        if not hybrid:
            assert all(x["scores"]["bm25_score"] is None for x in got)


@pytest.mark.parametrize("env", [
    {},
    {"K_VECTOR": "12", "RRF_K": "30", "WEIGHT_BM25": "0.5",
     "USE_MMR": "false", "MMR_MAX_POOL": "40", "DENSE_SELECT": "approx",
     "DENSE_RESCORE_POOL": "64", "USE_HYBRID": "yes", "K_BM25": "oops"},
])
def test_retrieval_config_matches(monkeypatch, tmp_path, env):
    """The port's retrieval knobs read the same variables, with the same
    defaults and parsing, as the JAX package's config."""
    import classmate_rag_tpu.config as jconfig
    from classmate_rag_tpu_torch.config import (
        ENV_NAMES, load_retrieval_config,
    )

    # The JAX config is a process-wide singleton: restore it afterwards.
    monkeypatch.setattr(jconfig, "_SINGLETON", jconfig._SINGLETON)
    monkeypatch.chdir(tmp_path)          # no .env file in the way
    for var in ENV_NAMES.values():
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    want = jconfig.load_config(reload=True)
    got = load_retrieval_config()
    for name in ENV_NAMES:
        assert getattr(got, name) == getattr(want, name), name


# ---------------------------------------------------------------------------
# The slice as a whole: each package ingests the same passages with its own
# small_test E5 encoder and answers the same questions through it.
#
# Tolerance: the two encoders agree to ~1e-6 per component (see
# test_torch_encoder.py), so dense scores agree to well under TIE = 1e-4.
# Ids must be equal position by position, except at positions whose rows
# have a dense score within TIE of another row of the same list; those
# are compared as sets, as compare_topk does for the scan kernel. BM25
# scores agree to 1e-4 and fused scores to 1e-6 wherever the ids agree.
# ---------------------------------------------------------------------------

TIE = 1e-4


@pytest.fixture(scope="module")
def e5_pair(tmp_path_factory):
    from classmate_rag_tpu.embeddings.encoder import E5Encoder as JE5
    from classmate_rag_tpu.embeddings.model import EncoderConfig as JCfg
    from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder as TE5
    from classmate_rag_tpu_torch.embeddings.model import EncoderConfig as TCfg

    texts, metas, _q = _corpus(n=300, seed=3)
    rng = np.random.default_rng(4)
    questions = [" ".join(rng.choice(t.split(), size=min(4, len(t.split())),
                                     replace=False)) for t in texts[::12]]
    ids = [f"p{i}" for i in range(len(texts))]
    tokens = [j_tokenize(t, "en") for t in texts]
    je = JE5(model_name="test-tiny", config=JCfg.small_test())
    te = TE5(model_name="test-tiny", config=TCfg.small_test(), device="cpu")
    jvecs, tvecs = je.encode_passages(texts), te.encode_passages(texts)
    js = JStore(te.dim, tmp_path_factory.mktemp("e5idx"), slab_rows=256,
                terms_per_chunk=32)
    ts = TStore(te.dim, slab_rows=256, terms_per_chunk=32, device="cpu")
    js.upsert(ids, jvecs, tokens, metas)
    ts.upsert(ids, tvecs, tokens, metas)
    jc = JCatalog.load_or_create(tmp_path_factory.mktemp("e5cat"))
    tc = TCatalog()
    for i, cid in enumerate(ids):
        jc.upsert(JEntry(cid, texts[i], tokens[i], metas[i]))
        tc.upsert(TEntry(cid, texts[i], tokens[i], metas[i]))
    return (JRet(js, jc, je), TRet(ts, tc, te), questions,
            dict(zip(ids, jvecs)), je)


def _same_up_to_ties(a, b, qvec, vec_of):
    ia, ib = [x["id"] for x in a], [x["id"] for x in b]
    assert len(ia) == len(ib)
    diff = [p for p in range(len(ia)) if ia[p] != ib[p]]
    if diff:
        score = {cid: float(vec_of[cid] @ qvec) for cid in set(ia) | set(ib)}

        def tied(cid):
            return any(abs(score[cid] - score[o]) < TIE
                       for o in score if o != cid)

        assert all(tied(ia[p]) and tied(ib[p]) for p in diff), (ia, ib)
        assert {ia[p] for p in diff} == {ib[p] for p in diff}, (ia, ib)
    for x, y in zip(a, b):
        if x["id"] != y["id"]:
            continue
        for key, tol in (("fused", 1e-6), ("bm25_score", 1e-4)):
            u, v = x["scores"][key], y["scores"][key]
            assert (u is None) == (v is None), key
            if u is not None:
                assert abs(u - v) <= tol * (1 + abs(u)), key
    return len(diff)


@pytest.mark.parametrize("filters", [None, {"course": "c1"}])
def test_e5_slice_matches(e5_pair, filters):
    jr, tr, questions, vec_of, je = e5_pair
    want = jr.retrieve_batch(questions=questions, filters=filters)
    got = tr.retrieve_batch(questions=questions, filters=filters)
    qvecs = je.encode_queries(questions)
    swapped = sum(_same_up_to_ties(a, b, q, vec_of)
                  for a, b, q in zip(want, got, qvecs))
    assert sum(len(g) for g in got) == 8 * len(questions)
    assert swapped <= len(questions)   # ties are the exception


def test_e5_device_handoff_equals_host_path(e5_pair):
    """The port's retriever takes the encoder's tensor (use_device_encode)
    and gives the same rows as the host path."""
    import dataclasses

    _jr, tr, questions, _v, _je = e5_pair
    seen = []
    store = tr.store
    orig = store.hybrid_topk_batch

    def spy(q, *args, **kw):
        seen.append(type(q).__name__)
        return orig(q, *args, **kw)

    store.hybrid_topk_batch = spy
    try:
        dev = tr.retrieve_batch(questions=questions[:5])
        host = dataclasses.replace(tr, use_device_encode=False) \
            .retrieve_batch(questions=questions[:5])
    finally:
        del store.hybrid_topk_batch
    assert seen == ["Tensor", "ndarray"]
    assert [[x["id"] for x in r] for r in dev] == \
        [[x["id"] for x in r] for r in host]
