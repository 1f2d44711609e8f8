"""The dense scan's share of its roofline, %: the least time of the
window's scans (every query against the vectors of the rows it may
return, each bf16 vector and f32 mask bias read once) over the profiler
time of ``topk_scan_kernel`` and ``topk_merge_kernel``."""

from rag_bench import work


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    spent = sum(e - s for n, s, e in ctx.trace.kernels
                if "topk_scan_kernel" in n or "topk_merge_kernel" in n)
    if not spent:
        return None
    least = sum(work.scan_least_s(x.queries, ctx.scope_rows(x.pool),
                                  ctx.dim, ctx.peak)
                for x in ctx.window.served)
    return 100.0 * least / (spent / 1e9)
