"""Host time inside ``IndexStore.hybrid_topk_batch`` a batch (making the
inputs, queueing the step, and any wait for the card inside it), the
benchmark's own span around the call."""


def read(ctx):
    s = ctx.window.served
    return sum(x.t_return - x.t_call for x in s) / len(s) / 1e6 if s else None
