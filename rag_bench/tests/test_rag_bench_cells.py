"""Every cell's run at a size the CPU holds, held against the reference;
the run's faults and the control must come out not correct."""

import json
import subprocess
import sys

import pytest
import torch

import numpy as np

from rag_bench import judge, spec
from rag_bench.corpus import make_corpus
from rag_bench.tests.conftest import (CASES, COURSE, SEED, load_case,
                                      run_tiny, tiny)

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def small(name):
    # The 1M cell's route (approx) starts at 500,000 rows: forced here.
    return tiny(name, **({"select": "approx"} if "1m" in name else {}))


@pytest.mark.parametrize("name", CASES)
def test_cell_window_is_correct(name):
    res = run_tiny(small(name))
    assert res["correct"], res["checks"]
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "checks"
    assert res["attempted"] >= 16 and res["failed"] == 0
    e2e = {m["name"] for m in load_case(name).end_to_end}
    assert set(res["metrics"]) == e2e
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert set(res["checks"]) == set(judge.NAMES)
    assert res["info"]["route"] == ("approx" if "1m" in name else "exact")


def test_traced_run_reports_per_layer_metrics():
    name = "trec-covid-171k.hybrid-b256"
    res = run_tiny(small(name), trace=True)
    assert res["correct"]
    # On the CPU there is no device trace: the host spans alone.
    assert set(res["metrics"]) == {"batch_latency_p95_ms", "store_call_ms",
                                   "fetch_wait_ms"}


def test_line_is_json_with_finite_numbers():
    res = run_tiny(small(COURSE))
    res.pop("info")
    json.loads(json.dumps(res, allow_nan=False))


def _patched(monkeypatch, wrap):
    from classmate_rag_tpu_torch.index.store import IndexStore

    orig = IndexStore.hybrid_topk_batch
    monkeypatch.setattr(IndexStore, "hybrid_topk_batch",
                        lambda self, *a, **k: wrap(orig, self, *a, **k))


def _altered(orig, self, *a, **k):
    res = orig(self, *a, **k)
    rows = res.rows.clone()
    rows[:, 0] = (rows[:, 0] + 1) % self.n_rows
    return res._replace(rows=rows)


def _half_batch(orig, self, q_vecs, terms, where, **k):
    h = len(terms) // 2
    res = orig(self, q_vecs[:h], terms[:h], where, **k)
    return type(res)(*(torch.cat([t, t]) for t in res))


class _Stale:
    def __init__(self):
        self.first = None

    def __call__(self, orig, self_, *a, **k):
        if self.first is None:
            self.first = orig(self_, *a, **k)
        return self.first


def _dense_leak(corpus):
    """A mask fault in the dense branch: the longest query of each
    filtered batch gets, in its last slot, its nearest row outside the
    course, with that row's true vector distance and no BM25 score."""
    emb = corpus.emb.astype(np.float32)

    def wrap(orig, self, q_vecs, terms, where, **k):
        res = orig(self, q_vecs, terms, where, **k)
        if where is None:
            return res
        j = max(range(len(terms)), key=lambda i: len(terms[i]))
        sims = emb @ q_vecs[j]
        sims[corpus.course == int(where["course"][1:])] = -np.inf
        r = int(np.argmax(sims))
        rows, vd, bm = (t.clone() for t in (res.rows, res.vec_dist,
                                             res.bm25_score))
        rows[j, -1], vd[j, -1], bm[j, -1] = r, float(1.0 - sims[r]), float("nan")
        return res._replace(rows=rows, vec_dist=vd, bm25_score=bm)

    return wrap


def test_dense_leak_out_of_the_filter_is_not_correct(monkeypatch):
    cell = small(COURSE)
    corpus = make_corpus(cell.config, SEED, "cpu")
    _patched(monkeypatch, _dense_leak(corpus))
    res = run_tiny(cell)
    assert not res["correct"]
    checks = res["checks"]
    # One leaked slot among the sample's stays under the slot limit: the
    # out-of-filter row's infinite distance gap is what catches it.
    assert checks["slot_miss_share"]["value"] <= checks[
        "slot_miss_share"]["limit"]
    assert checks["vec_dist_gap"]["value"] > 1e299


@pytest.mark.parametrize("fault", ["altered", "half_batch", "stale"])
@pytest.mark.parametrize("name", CASES)
def test_faults_are_not_correct(monkeypatch, name, fault):
    wrap = {"altered": _altered, "half_batch": _half_batch,
            "stale": _Stale()}[fault]
    _patched(monkeypatch, wrap)
    res = run_tiny(small(name))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CASES)
def test_control_is_not_correct(name):
    cell = small(name)
    res = run_tiny(cell, control=True)
    assert res["correct"]
    assert any(v > cell.limits[n] for n, v in res["control"].items()), \
        res["control"]


def test_without_a_card_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "rag_bench.run", "--workload",
         "trec-covid-171k.hybrid-b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=spec.CHECKOUT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rag_bench import run
    import time

    cell = small("trec-covid-171k.hybrid-b256")
    res = run.run_cell(cell, 5, 0.5, True, "cuda:0", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
