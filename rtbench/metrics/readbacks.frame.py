"""readbacks.frame: the host's reads of device values a frame (the
program's counter "readbacks": the culls' S, k and need, the traversal
wrappers' regions, render_tiled's overflow and live rays).

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
    return tot["counters"].get("readbacks", 0) / tot["units"]
