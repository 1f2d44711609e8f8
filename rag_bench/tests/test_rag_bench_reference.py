"""The reference at the cells' sizes (``reference/hybrid.py``) against
the frozen oracle (``reference/oracle.py``) at a small size."""

import numpy as np
import pytest
import torch

from rag_bench.corpus import make_batches, make_corpus
from rag_bench.reference import oracle
from rag_bench.reference.hybrid import (
    OkapiIndex,
    Query,
    Reference,
    bf16_round,
    top_rows,
)
from rag_bench.tests.conftest import tiny


def _setup(name, rows=800):
    cell = tiny(name, rows=rows, batch=12, pool=2)
    corpus = make_corpus(cell.config, 21, "cpu")
    batches = make_batches(corpus, cell.config, cell.traffic, 21)
    docs = [list(t) for t in corpus.token_lists(0, corpus.n)]
    return cell, corpus, batches, docs


def test_okapi_index_equals_oracle_bm25():
    _cell, corpus, batches, docs = _setup("trec-covid-171k.hybrid-b256")
    slow = oracle.OracleBM25(docs)
    fast = OkapiIndex(corpus.tokens, corpus.offsets)
    for b in batches:
        for ids, words in zip(b.term_ids, b.terms):
            want = slow.get_scores(words)
            got = fast.get_scores(ids)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            rows = np.arange(corpus.n)
            np.testing.assert_allclose(fast.row_scores(ids, rows), got,
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["msmarco-1m.hybrid-b256",
                                  "trec-covid-171k.course-b256"])
def test_reference_equals_oracle(name):
    cell, corpus, batches, docs = _setup(name)
    emb = corpus.emb.astype(np.float32)
    ref = Reference(corpus.tokens, corpus.offsets, corpus.emb, corpus.course,
                    cell.config["retrieval"], "cpu")
    bm25 = oracle.OracleBM25(docs)
    for b in batches:
        qs = [Query(b.q_vecs[j], b.term_ids[j], b.course)
              for j in range(len(b.terms))]
        got = ref.answer(qs)
        for j, a in enumerate(got):
            if b.course is None:
                want = oracle.oracle_query(b.q_vecs[j], b.terms[j], emb, bm25)
            else:
                rows_sub = corpus.course_rows(b.course)
                sub = oracle.OracleBM25([docs[i] for i in rows_sub])
                want = oracle.oracle_query_masked(b.q_vecs[j], b.terms[j], emb,
                                                  sub, rows_sub)
            assert a.rows.tolist() == want


def test_top_rows_is_a_stable_argsort():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 5, 200).astype(np.float32)       # many ties
    for k in (1, 8, 37, 200):
        np.testing.assert_array_equal(
            top_rows(x, k), np.argsort(-x, kind="stable")[:k])


def test_bf16_round_matches_torch():
    x = np.random.default_rng(1).standard_normal(10000).astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16_round(x), want)


def test_control_departs_from_the_reference():
    cell, corpus, batches, _docs = _setup("trec-covid-171k.hybrid-b256")
    r = cell.config["retrieval"]
    exact = Reference(corpus.tokens, corpus.offsets, corpus.emb,
                      corpus.course, r, "cpu")
    ctrl = Reference(corpus.tokens, corpus.offsets, corpus.emb,
                     corpus.course, r, "cpu", precision="control")
    b = batches[0]
    qs = [Query(b.q_vecs[j], b.term_ids[j], None) for j in range(12)]
    a, c = exact.answer(qs), ctrl.answer(qs)
    assert any(x.rows.tolist() != y.rows.tolist() for x, y in zip(a, c))
