"""Share of the traced window in which no operation ran on the card, %:
one minus the union of the profiler's device intervals over the window."""

from rag_bench.trace import union_ns


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.window.seconds:
        return None
    return 100.0 * (1.0 - union_ns(ctx.trace.ops) / 1e9 / ctx.window.seconds)
