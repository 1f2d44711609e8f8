"""The port's benchmark (``classmate_rag_tpu_torch/bench.py``) against
the repository's root ``bench.py`` on the CPU: the same corpus, queries
and oracle (bit-equal), the same recall on the same size, the product
stage's asserts and keys, the line's keys, and failures that reach the
exit code.

The root file runs on JAX's CPU platform (tests/conftest.py); the port
with ``device="cpu"``, its children with ``--device cpu``.
"""

import json

import numpy as np
import pytest
import torch

import bench as root_bench
from classmate_rag_tpu_torch import bench

N = 3000


def _small(monkeypatch, n_queries=64, batch=32):
    """The timed passes cut to a few batches, on both sides."""
    for mod, batch_name in ((bench, "BATCH"), (root_bench, "TPU_BATCH")):
        monkeypatch.setattr(mod, "N_QUERIES", n_queries)
        monkeypatch.setattr(mod, batch_name, batch)
        monkeypatch.setattr(mod, "MIN_PASS_S", 0.05)
    monkeypatch.setenv("BENCH_PASSES", "1")
    monkeypatch.setenv("BENCH_FILTERED_QUERIES", "16")


def test_corpus_and_queries_equal_root(monkeypatch):
    monkeypatch.setattr(bench, "N_QUERIES", 96)
    monkeypatch.setattr(root_bench, "N_QUERIES", 96)
    rng_t, rng_r = np.random.default_rng(42), np.random.default_rng(42)
    docs_t, emb_t = bench.build_corpus(rng_t, N)
    docs_r, emb_r = root_bench.build_corpus(rng_r, N)
    assert docs_t == docs_r
    assert emb_t.dtype == emb_r.dtype and emb_t.tobytes() == emb_r.tobytes()
    q_t = bench.make_queries(rng_t, docs_t, emb_t)
    q_r = root_bench.make_queries(rng_r, docs_r, emb_r)
    assert len(q_t) == len(q_r) == 96
    for (vt, tt), (vr, tr) in zip(q_t, q_r):
        assert vt.tobytes() == vr.tobytes()
        assert tt == tr


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    docs, emb = bench.build_corpus(rng, N)
    queries = bench.make_queries(rng, docs, emb)[:24]
    return docs, emb, queries


@pytest.mark.parametrize("cls", ["OracleBM25", "FastOracleBM25"])
def test_oracle_bm25_scores_equal_root(corpus, cls):
    docs, _emb, queries = corpus
    got = getattr(bench, cls)(docs)
    want = getattr(root_bench, cls)(docs)
    for _qv, terms in queries + [(None, ["no-such-word", "w0"])]:
        assert got.get_scores(terms).tobytes() == (
            want.get_scores(terms).tobytes())
    if cls == "FastOracleBM25":
        # The postings are built without the root's loop: same state.
        assert list(got.vocab.items()) == list(want.vocab.items())
        for name in ("post_rows", "post_tfs", "offsets", "idf", "_denom"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_oracle_query_rows_equal_root(corpus):
    docs, emb, queries = corpus
    bm = bench.FastOracleBM25(docs)
    rbm = root_bench.FastOracleBM25(docs)
    for qv, terms in queries:
        assert (bench.oracle_query(qv, terms, emb, bm)
                == root_bench.oracle_query(qv, terms, emb, rbm))


@pytest.mark.parametrize("case", [c[0] for c in bench._FILTER_CASES
                                  if c[2] is not None])
def test_oracle_query_masked_rows_equal_root(corpus, case):
    docs, emb, queries = corpus
    pred = dict((c[0], c[2]) for c in bench._FILTER_CASES)[case]
    rows_sub = np.nonzero(pred(np.arange(N)))[0]
    sub = [docs[i] for i in rows_sub]
    bm, rbm = bench.OracleBM25(sub), root_bench.OracleBM25(sub)
    for qv, terms in queries[:8]:
        assert (bench.oracle_query_masked(qv, terms, emb, bm, rows_sub)
                == root_bench.oracle_query_masked(qv, terms, emb, rbm,
                                                  rows_sub))
    assert [bench._bench_meta(i) for i in range(40)] == [
        root_bench._bench_meta(i) for i in range(40)]


@pytest.fixture(scope="module")
def scales():
    """Both run_scale's at N chunks with the filter cases, the passes
    cut (module scope: pytest's monkeypatch is per test)."""
    mp = pytest.MonkeyPatch()
    try:
        _small(mp)
        detail = {}
        got = bench.run_scale(N, n_oracle=32, filtered_oracle=True,
                              device="cpu", detail=detail)
        want = root_bench.run_scale(N, n_oracle=32, filtered_oracle=True)
    finally:
        mp.undo()
    return got, want, detail


def test_run_scale_recall_equals_root(scales):
    got, want, detail = scales
    assert set(got) == set(want)
    for key in ("recall_vs_oracle@8", "n_oracle_queries", "corpus_chunks",
                "rescore", "recall_filtered@8"):
        assert got[key] == want[key], key
    assert got["recall_vs_oracle@8"] >= 0.99
    assert got["filtered"] == want["filtered"]
    assert got["value"] > 0 and got["device_ceiling_qps"] > 0
    assert detail["select_mode"] == "exact" and detail["device"] == "cpu"
    assert detail["device_timing"] == "wall"
    assert set(detail["seconds"]) == {
        "corpus", "upsert", "first_batch", "timed_passes", "device_probe",
        "oracle", "filtered"}
    # The CPU runs the plain versions: no kernel launch counted.
    assert detail["timed_launches"] == {"topk_scan": 0, "topk_merge": 0,
                                        "row_select": 0,
                                        "row_select_merge": 0,
                                        "bm25_sat_gemm": 0}
    assert detail["timed_batches"] >= 2


# The keys the root file's run_product_stage returns (its own keys and
# the warm child's report, bench.py:659-822), with no child_rc: the
# port raises on a child that exits non-zero.
PRODUCT_KEYS = {
    "corpus_chunks", "build_s", "warmup_s", "cold_scan_start_s",
    "cold_scan_split_s", "warm_start_s", "warm_split_s",
    "rss_after_load_mb", "load_split_s", "n_rows", "ready_s", "first_ask_s",
    "answer_nonempty", "retrieved_k", "ask_p50_ms", "ask_p95_ms",
    "ask_mean_ms", "n_asks", "add_s", "persist_s", "persist_delta_bytes",
    "persist_rewrote_base", "ask_after_add_first_ms", "ask_after_add_p50_ms",
    "device_full_uploads", "split_full_builds", "split_snapshot_restores",
    "df_full_builds", "rss_final_mb",
}


def test_product_stage_cpu(monkeypatch):
    """tests/test_tools.py's asserts of the root file's product stage:
    fresh children cold-start the runtime from the persisted index on
    the parent's device, answer asks, and the /add persists O(delta)."""
    monkeypatch.setenv("EMBEDDING_BACKEND", "hash")
    monkeypatch.setattr(bench, "PRODUCT_ASKS", 3)
    res = bench.run_product_stage(1200, device="cpu")
    assert res["n_rows"] == 1200
    assert res["answer_nonempty"]
    assert res["retrieved_k"] > 0
    assert res["ask_p95_ms"] > 0
    assert res["cold_scan_start_s"] > 0
    assert not res["persist_rewrote_base"]
    assert 0 < res["persist_delta_bytes"] < 1_000_000
    assert set(res) == PRODUCT_KEYS
    assert res["n_asks"] == 3
    assert res["device_full_uploads"] == 1


def _main_line(monkeypatch, capsys, argv):
    _small(monkeypatch, n_queries=32, batch=16)
    monkeypatch.setattr(bench, "N_CHUNKS", 800)
    monkeypatch.setattr(bench, "SCALE2_CHUNKS", 600)
    monkeypatch.setattr(bench, "N_ORACLE", 16)
    rc = bench.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_line_has_root_keys(scales, monkeypatch, capsys):
    rc, line = _main_line(monkeypatch, capsys, ["--device", "cpu"])
    assert rc == 0
    _got, want, _d = scales
    # The root file's main: metric, unit, the primary run_scale's keys,
    # backend and scale2 (scale3 and product run on the card only).
    assert set(line) == {"metric", "unit", "backend", "scale2", "card",
                         *want}
    assert line["metric"] == "hybrid_query_qps"
    assert line["backend"] == "cpu" and line["card"] is None
    assert set(line["scale2"]) == set(want) - {"filtered",
                                               "recall_filtered@8"}
    assert line["scale2"]["corpus_chunks"] == 600


def test_failed_stage_exits_nonzero(monkeypatch, capsys):
    real = bench.run_scale

    def failing(n_chunks, *a, **kw):
        if n_chunks == 600:
            raise RuntimeError("scale2 fails")
        return real(n_chunks, *a, **kw)

    monkeypatch.setattr(bench, "run_scale", failing)
    rc, line = _main_line(monkeypatch, capsys, ["--device", "cpu"])
    assert rc == 1
    assert line["scale2"] == {"error": "RuntimeError: scale2 fails"}
    assert line["corpus_chunks"] == 800


def test_main_without_card_runs_nothing(monkeypatch):
    """No --device: CUDA or an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def must_not_run(*a, **kw):
        raise AssertionError("ran without a card")

    monkeypatch.setattr(bench, "run_scale", must_not_run)
    for argv in ([], ["product-child", "3"], ["product-warmup"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(argv)
