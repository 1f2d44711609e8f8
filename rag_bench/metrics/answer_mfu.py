"""The answer batches' share of the card's peak, %: the least time of the
window's batches (each batch's prefill over its real prompt tokens and
its decode forwards, each forward at the larger of its FLOP and byte
bounds: ``work_answer.batch_least_s``) over the window's wall time."""

from rag_bench import work_answer


def read(ctx):
    cfg = getattr(ctx, "answer_config", None)
    if cfg is None or ctx.peak is None or not ctx.window.seconds:
        return None
    least = {}
    for x in ctx.window.served:
        if x.pool not in least:
            least[x.pool] = work_answer.batch_least_s(
                cfg, ctx.prompt_lens[x.pool], ctx.max_new, ctx.peak)
    return 100.0 * sum(least[x.pool] for x in ctx.window.served
                       if x.out is not None) / ctx.window.seconds
