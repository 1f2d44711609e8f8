"""Device time of one decode step, ms: the CUDA event pair that the
program's ``decode.step`` span carries under tracing, mean over the
window's steps."""

from rag_bench.metrics_answer import span_device_ms


def read(ctx):
    return span_device_ms(getattr(ctx, "spans", None), "decode.step")
