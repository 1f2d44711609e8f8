"""Device time of a batch's prefill, ms: the CUDA event pair that the
program's ``decode.prefill`` span carries under tracing, mean over the
window's batches."""

from rag_bench.metrics_answer import span_device_ms


def read(ctx):
    return span_device_ms(getattr(ctx, "spans", None), "decode.prefill")
