"""rows_summed.grad: the gathered rows whose gradients the grad step sums
(the program's counter "rows_summed", from the shapes: no read-back).

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no such counter."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("grad.step")
    if not tot or "rows_summed" not in tot["counters"]:
        return None
    return tot["counters"]["rows_summed"] / tot["units"]
