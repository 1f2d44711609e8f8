"""What the ``answer`` kind's device-time readers share: the program's
spans that carry a CUDA event pair (``cuda_events``) under tracing."""


def span_device_ms(spans, name):
    """Mean device time, ms, of the spans ``name`` with an event pair;
    None when there are none (untraced, or not on a card)."""
    pairs = [s.counts["cuda_events"] for s in spans or ()
             if s.name == name and "cuda_events" in s.counts]
    if not pairs:
        return None
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
