"""The whole batch's share of the card's peak, %: the least time of the
window's batches (the dense scan, the posting entries of each batch's
distinct query words over the rows searched, the rows' lengths) over the
window's wall time."""

from rag_bench import work


def read(ctx):
    if ctx.peak is None or not ctx.window.seconds:
        return None
    least = sum(work.batch_least_s(x.queries, ctx.scope_rows(x.pool),
                                   ctx.dim, ctx.postings(x.pool), ctx.peak)
                for x in ctx.window.served)
    return 100.0 * least / ctx.window.seconds
