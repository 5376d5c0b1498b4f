"""accel_build_ms.grad: the cluster accel built from the parameters in
api.image_loss each grad step (the program span "grad.accel"), stream ms a
step.

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
    s = tot["spans"].get("grad.accel")
    return None if s is None else s["stream_ms"] / tot["units"]
