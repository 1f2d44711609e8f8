"""Readings pinned from the harness as it stood before a cell's set-up,
loop and check moved into its kind (``kinds/hybrid.py``): the same seed
gives the same checks, sampled answers and control readings, and every
reader the same value from the same window and trace."""

import hashlib

import numpy as np
import pytest
import torch

from rag_bench import judge, run
from rag_bench.tests.conftest import CASES, COURSE, SEED, run_tiny, tiny
from rag_bench.trace import Trace
from rag_bench.window import Served, Window

# At ``tiny`` size and SEED, one intra-op thread, a 2 s window: the three
# numbers compared and a digest of the first served repetition of each
# sampled query (rows, fused, vector and BM25 scores).
CASE_READINGS = {
    "msmarco-1m.hybrid-b256": (
        {"slot_miss_share": 0.0, "vec_dist_gap": 5.960464477539063e-08,
         "bm25_rel_gap": 1.5633622751920484e-07},
        "a5f35298dccf458959675b4f82d3592fb054176397d066a3735db47847277b9d"),
    "trec-covid-171k.hybrid-b256": (
        {"slot_miss_share": 0.0, "vec_dist_gap": 5.960464477539063e-08,
         "bm25_rel_gap": 1.9276407670076878e-07},
        "63a8d2bb08af5b54041db57d41e53daa148903e9fa0ff7bbd6c01843e03e7993"),
    "trec-covid-171k.course-b256": (
        {"slot_miss_share": 0.0, "vec_dist_gap": 5.960464477539063e-08,
         "bm25_rel_gap": 2.3436756180217344e-07},
        "d66aa7e7e6315cbb0d2e8473b441d9c2e5754e079671048693faa3288d938164"),
}
CONTROL_READINGS = {"slot_miss_share": 0.08333333333333333,
                    "vec_dist_gap": 0.0013030394911766052,
                    "bm25_rel_gap": 0.004460881204246844}
READERS = {
    "query_qps": 21801.582798185205,
    "setup_s": 37.25,
    "batch_latency_p95_ms": 10.0297332,
    "store_call_ms": 3.1860965,
    "fetch_wait_ms": 4.4611315,
    "step_device_ms": 1.21671475,
    "kernels_per_batch": 3.25,
    "topk_scan_roofline": 48.71040712868239,
    "step_mfu": 4.050933487828948,
    "device_idle_pct": 88.84967815390658,
}
LONG = "void at::native::elementwise_kernel<128, 4>(int, " + "x" * 90 + ")"
BREAKDOWN = {
    "device_ops": [
        ["void topk_scan_kernel<128>(...)", 0.043234968],
        [LONG[:93] + "...", 0.004718016],
        ["sort", 0.004521432],
        ["elementwise", 0.003999996],
        ["Memcpy DtoH (Device -> Pageable)", 0.0028320000000000007],
        ["void topk_merge_kernel(...)", 0.0019278959999999993],
        ["Memcpy HtoD (Pageable -> Device)", 0.001]],
    "idle_gaps": [
        ["fetch", 0.25362195000000004],
        ["between batches", 0.22195593799999996],
        ["store call", 0.012895849],
        ["before the first batch", 0.004],
        ["longest, between batches", 0.009147757],
        ["longest, fetch", 0.007803958],
        ["longest, before the first batch", 0.004],
        ["longest, store call", 0.002117606]],
}

MS = 1_000_000
PEAK = (989e12, 3.35e12)
OFF = 1_760_000_000_123_456_789     # wall clock minus perf_counter, ns


def synthetic():
    """48 batches of 254-256 queries over a pool of 7, one of them
    failed, calls of 3-7 ms, fetches of 2-11 ms, pauses of 0-8 ms; on the
    card a copy before the first batch, then per batch a scan, a merge,
    an elementwise kernel overlapping the merge, a copy, and on every
    fourth batch one more kernel inside the fetch."""
    served, ops = [], [("Memcpy HtoD (Pageable -> Device)", MS, 2 * MS)]
    t = 5 * MS
    for i in range(48):
        call = 3 * MS + (i * 7919) % (4 * MS)
        wait = 2 * MS + (i * 104729) % (9 * MS)
        failed = i == 17
        served.append(Served((i * 5) % 7, t, t + call, t + call + wait,
                             256 - i % 3, None if failed else (),
                             "RuntimeError: planted" if failed else None))
        k = t + call // 3
        scan = 900_000 + (i * 31) % 200_000
        ops.append(("void topk_scan_kernel<128>(...)", k, k + scan))
        ops.append(("void topk_merge_kernel(...)", k + scan,
                    k + scan + 40_000 + (i * 7) % 9_000))
        ops.append((LONG if i % 2 else "sort", k + scan + 20_000,
                    k + scan + 20_000 + (i * 8191) % (3 * MS)))
        if i % 4 == 1:
            ops.append(("elementwise", t + call + wait // 2,
                        t + call + wait // 2 + 333_333))
        ops.append(("Memcpy DtoH (Device -> Pageable)",
                    t + call + wait - 60_000, t + call + wait - 1_000))
        t += call + wait + (i % 5) * 2 * MS + (i * 613) % MS + 1_000
    ops = sorted(((n, a + OFF, b + OFF) for n, a, b in ops),
                 key=lambda o: o[1])
    return Window(served), Trace(ops, host_offset_ns=OFF)


def synthetic_context():
    w, tr = synthetic()
    return run.Context(w, 37.25, tr, PEAK, dim=768,
                       scope_rows=lambda p: 1_000_000 - 1_000 * p,
                       postings=lambda p: 3_000_000 + 17 * p)


@pytest.fixture
def one_thread():
    # The approx route's float32 GEMMs round otherwise with more than one
    # intra-op thread on the CPU; a run of the benchmark has one.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(got):
    h = hashlib.sha256()
    for reps in got:
        a = reps[0]
        for arr in (a.rows, a.fused, a.vec_dist, a.bm25):
            x = np.ascontiguousarray(arr)
            h.update(str(x.dtype).encode())
            h.update(x.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CASES)
def test_checks_and_answers_pinned(monkeypatch, one_thread, name):
    judged = []
    readings = judge.readings

    def spy(ref, queries, want, got):
        judged.append(got)
        return readings(ref, queries, want, got)

    monkeypatch.setattr(judge, "readings", spy)
    cell = tiny(name, **({"select": "approx"} if "1m" in name else {}))
    res = run_tiny(cell, seconds=2.0, control=name == COURSE)
    # Two batches or more: both pool batches served, so the sample is
    # drawn from the same pairs.
    assert res["info"]["batches"] >= 2
    checks, digest = CASE_READINGS[name]
    assert {n: c["value"] for n, c in res["checks"].items()} == checks
    assert _digest(judged[0]) == digest
    if name == COURSE:
        assert res["control"] == CONTROL_READINGS
    else:
        assert "control" not in res


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_pinned(name):
    assert run.read_metric(name, synthetic_context()) == READERS[name]


def test_breakdown_pinned():
    w, tr = synthetic()
    assert run.breakdown(tr, w) == BREAKDOWN
