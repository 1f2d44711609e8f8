"""Each metric's reader on a canned window and profiler trace, against
numbers worked by hand; readers with nothing to read return None."""

import pytest

from rag_bench import run, work
from rag_bench.trace import Trace, gaps, union_ns
from rag_bench.window import Served, Window

MS = 1_000_000
PEAK = (989e12, 3.35e12)


def canned(trace=True):
    # Two batches of 256: calls of 4 and 6 ms, fetches of 6 and 4 ms;
    # the second starts 1 ms after the first ends: 21 ms of window.
    w = Window([Served(0, 0, 4 * MS, 10 * MS, 256, ()),
                Served(1, 11 * MS, 17 * MS, 21 * MS, 256, ())])
    ops = [
        ("void topk_scan_kernel<128>(...)", 2 * MS, 3 * MS),
        ("void topk_merge_kernel(...)", 3 * MS, 3 * MS + MS // 2),
        ("sort", 3 * MS + MS // 2, 9 * MS),
        ("Memcpy DtoH (Device -> Pageable)", 9 * MS, 10 * MS),
        ("void topk_scan_kernel<128>(...)", 13 * MS, 14 * MS),
        ("void topk_merge_kernel(...)", 14 * MS, 14 * MS + MS // 2),
        ("elementwise", 14 * MS, 20 * MS),            # overlaps the merge
    ]
    tr = Trace(ops, host_offset_ns=0) if trace else None
    return run.Context(w, 12.5, tr, PEAK, dim=768,
                       scope_rows=lambda p: 1_000_000,
                       postings=lambda p: 3_000_000)


@pytest.mark.parametrize("name,want", [
    ("query_qps", 512 / 0.021),
    ("batch_latency_p95_ms", 10 + 0.95 * (10 - 10)),
    ("setup_s", 12.5),
    ("store_call_ms", 5.0),
    ("fetch_wait_ms", 5.0),
    # Kernels: 1 + 0.5 + 5.5 + 1 + 0.5 + 6 = 14.5 ms over 2 batches.
    ("step_device_ms", 7.25),
    ("kernels_per_batch", 3.0),
    # Scans: 2 x 1.54e9 B / 3.35e12 over 3 ms of scan + merge.
    ("topk_scan_roofline", 100 * 2 * 1.54e9 / 3.35e12 / 0.003),
    ("step_mfu", 100 * 2 * (1.54e9 + 15e6 + 4e6) / 3.35e12 / 0.021),
    # Busy: [2, 10] and [13, 20] ms: 15 of 21 ms.
    ("device_idle_pct", 100 * (1 - 15 / 21)),
])
def test_reader(name, want):
    assert run.read_metric(name, canned()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["step_device_ms", "kernels_per_batch",
                                  "topk_scan_roofline", "device_idle_pct"])
def test_trace_readers_without_a_trace(name):
    assert run.read_metric(name, canned(trace=False)) is None


def test_roofline_without_a_known_card():
    ctx = canned()
    ctx.peak = None
    assert run.read_metric("topk_scan_roofline", ctx) is None
    assert run.read_metric("step_mfu", ctx) is None


def test_union_and_gaps():
    ops = canned().trace.ops
    assert union_ns(ops) == 15 * MS
    assert gaps(ops) == [(10 * MS, 13 * MS)]


def test_breakdown_names_the_host_phase_of_each_gap():
    ctx = canned()
    out = run.breakdown(ctx.trace, ctx.window)
    assert out["device_ops"][0] == ["elementwise", 0.006]
    assert len(out["device_ops"]) == 5          # by name
    # The gap 10-13 ms: its middle (11.5 ms) lies in the second call.
    assert out["idle_gaps"][0] == ["store call", 0.003]


def test_batch_p95_over_all_batches():
    w = Window([Served(i % 3, i * 100 * MS, i * 100 * MS + MS,
                       i * 100 * MS + (i + 1) * MS, 1, ())
                for i in range(100)])
    ctx = run.Context(w, 1.0, None, None)
    # Latencies 1..100 ms: numpy's linear 95th percentile is 95.05.
    assert run.read_metric("batch_latency_p95_ms", ctx) == pytest.approx(
        95.05)


def test_work_counts_feed_the_readers():
    assert work.scan_least_s(256, 1_000_000, 768, PEAK) == pytest.approx(
        1.54e9 / 3.35e12)
