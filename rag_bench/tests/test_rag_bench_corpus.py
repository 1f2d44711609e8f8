"""The generator: the same seed gives the same inputs, and each
configuration's lengths keep its source's means."""

import numpy as np
import pytest

from rag_bench import spec
from rag_bench.corpus import make_batches, make_corpus, stream_seed
from rag_bench.tests.conftest import tiny


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 11, 2**40 + 3, -5])
def test_same_seed_same_inputs(seed):
    cell = tiny("trec-covid-171k.course-b256", rows=500)
    a = make_corpus(cell.config, seed, "cpu")
    b = make_corpus(cell.config, seed, "cpu")
    for x, y in ((a.tokens, b.tokens), (a.offsets, b.offsets),
                 (a.emb, b.emb), (a.course, b.course)):
        np.testing.assert_array_equal(x, y)
    ba = make_batches(a, cell.config, cell.traffic, seed)
    bb = make_batches(b, cell.config, cell.traffic, seed)
    for x, y in zip(ba, bb):
        np.testing.assert_array_equal(x.q_vecs, y.q_vecs)
        assert x.terms == y.terms and x.where == y.where
    c = make_corpus(cell.config, seed + 1, "cpu")
    assert not np.array_equal(a.tokens[:100], c.tokens[:100])


def test_streams_differ():
    assert len({stream_seed(7, s) for s in range(4)}) == 4


@pytest.mark.parametrize("name", ["msmarco-passage-1m", "trec-covid-171k"])
def test_mean_lengths_match_source(name):
    cfg = dict(spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json"))
    cfg["passages"] = 20000
    corpus = make_corpus(cfg, 3, "cpu")
    lens = np.diff(corpus.offsets)
    assert abs(lens.mean() / cfg["published_passage_words_mean"] - 1) < 0.05
    traffic = {"batch": 256, "pool_batches": 8, "filter": None}
    batches = make_batches(corpus, cfg, traffic, 3)
    qlen = np.mean([len(t) for b in batches for t in b.terms])
    assert abs(qlen / cfg["published_query_words_mean"] - 1) < 0.05
    assert lens.max() <= cfg["retrieval"]["terms_per_chunk"]


def test_queries_come_from_their_course():
    cell = tiny("trec-covid-171k.course-b256", rows=2000, pool=4)
    corpus = make_corpus(cell.config, 9, "cpu")
    for b in make_batches(corpus, cell.config, cell.traffic, 9):
        assert b.where == {"course": f"c{b.course}"}
        words = set(corpus.tokens[np.concatenate([
            np.arange(corpus.offsets[r], corpus.offsets[r + 1])
            for r in corpus.course_rows(b.course)])].tolist())
        assert all(set(t.tolist()) <= words for t in b.term_ids)
