"""Queries answered in the window over the window's seconds."""


def read(ctx):
    w = ctx.window
    return (w.attempted - w.failed) / w.seconds if w.seconds else None
