"""CUDA kernel time in the traced window a batch (torch.profiler)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    busy = sum(e - s for _n, s, e in ctx.trace.kernels)
    return busy / len(ctx.window.served) / 1e6
