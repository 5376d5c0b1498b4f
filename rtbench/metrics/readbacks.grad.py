"""readbacks.grad: the host's reads of device values a grad step (the
program's counter "readbacks").

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no recorder."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("grad.step")
    if not tot:
        return None
    return tot["counters"].get("readbacks", 0) / tot["units"]
