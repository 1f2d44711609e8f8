"""95th percentile over all the window's batches of the time from the
call into the store to the batch's rows and scores on the host: the
closed loop's batch latency, a per-layer reading (it moves with the
host's speed from run to run more than an end-to-end bound holds)."""

import numpy as np


def read(ctx):
    lat = [(s.t_fetched - s.t_call) / 1e6 for s in ctx.window.served]
    return float(np.percentile(lat, 95)) if lat else None
