"""readback_wait_ms.frame: the host's time blocked in its reads of
device values (every "readback.*" program span, on the host clock), ms a
frame.

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no recorder."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("frame")
    if not tot:
        return None
    return sum(s["host_ms"] for n, s in tot["spans"].items()
               if n.startswith("readback.")) / tot["units"]
