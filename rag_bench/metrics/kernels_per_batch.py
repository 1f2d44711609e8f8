"""CUDA kernel launches in the traced window a batch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / len(ctx.window.served)
