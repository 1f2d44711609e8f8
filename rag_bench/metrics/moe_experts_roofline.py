"""The routed experts' share of their roofline, %: the least time of the
window's forwards' routed experts over the profiler time of the
grouped-GEMM kernels that compute them (``torch._grouped_mm``'s CUTLASS
kernels, matched by name). A forward's least time
(``work_answer.experts_least_s``): its (token, expert) pairs, 2 x 3 x
hidden x expert width FLOPs each, and every expert's three bf16
matrices read once. Its pairs: the tokens the program's ``decode.prefill``
span (``tokens``) or ``decode.step`` span (``rows``, one token a row; a
step that runs a forward) counts, times the experts a token and the
expert layers."""

from rag_bench import work_answer

# The grouped products' kernels: CUTLASS 3 grouped GEMMs (their problem
# shape type is in the name), nothing else of the step.
NAMES = ("GroupProblemShape",)


def read(ctx):
    cfg = getattr(ctx, "answer_config", None)
    spans = getattr(ctx, "spans", None)
    if cfg is None or not spans or ctx.trace is None or ctx.peak is None:
        return None
    spent = sum(e - s for n, s, e in ctx.trace.kernels
                if any(k in n for k in NAMES))
    if not spent:
        return None
    per_token = cfg.num_experts_per_tok * work_answer.n_moe_layers(cfg)
    last = ctx.max_new - 1            # the last step samples, runs no forward
    least = 0.0
    for s in spans:
        if s.name == "decode.prefill":
            tokens = s.counts["tokens"]
        elif s.name == "decode.step" and s.counts["step"] < last:
            tokens = s.counts["rows"]
        else:
            continue
        least += work_answer.experts_least_s(cfg, tokens * per_token,
                                             ctx.peak)
    return 100.0 * least / (spent / 1e9)
