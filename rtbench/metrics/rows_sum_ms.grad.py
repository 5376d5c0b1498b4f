"""rows_sum_ms.grad: the grad step's segmented row sums, the backward of its
row gathers (the program span "grad.rows_sum", on autograd's thread inside
"grad.backward"), stream ms a step.

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no such span."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("grad.step")
    if not tot:
        return None
    s = tot["spans"].get("grad.rows_sum")
    return None if s is None else s["stream_ms"] / tot["units"]
