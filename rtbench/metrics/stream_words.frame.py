"""stream_words.frame: the candidate words the streamed tier's passes hand
their stream kernels a frame (the program's counter "stream_words": tiles
x k of each pass's list, from its shape), summed over the passes.

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no such counter."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("frame")
    if not tot or "stream_words" not in tot["counters"]:
        return None
    return tot["counters"]["stream_words"] / tot["units"]
