"""bounce_words.frame: the candidate words that the passes of the tiled
tier's mirror bounces after the primary pass hand their kernels a frame
(the program's counter "bounce_words": tiles x k of each such pass's list,
from the k its cull read), summed over the passes.

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no such counter (a
one-bounce frame, or a program without the counter)."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("frame")
    if not tot or "bounce_words" not in tot["counters"]:
        return None
    return tot["counters"]["bounce_words"] / tot["units"]
