"""Time a batch from the store call's return to its results on the host:
the host waiting for the card to finish the step."""


def read(ctx):
    s = ctx.window.served
    return (sum(x.t_fetched - x.t_return for x in s) / len(s) / 1e6
            if s else None)
