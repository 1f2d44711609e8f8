"""Host time to queue one decode step, ms: the program's ``decode.step``
span (its host clock), mean over the window's steps. Beside
``decode_step_device_ms`` it says whether launches pace the decode."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    steps = [s for s in spans or () if s.name == "decode.step"]
    if not steps:
        return None
    return sum(s.t1_ns - s.t0_ns for s in steps) / len(steps) / 1e6
