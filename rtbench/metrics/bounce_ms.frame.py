"""bounce_ms.frame: render/tiled.py render_tiled's mirror bounces after the
primary pass (the program span "render.bounce": each later bounce's
closest-hit pass, its shadow passes and its shading), stream ms a frame.

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no such span (a
one-bounce frame, or a program without the span)."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("frame")
    if not tot:
        return None
    s = tot["spans"].get("render.bounce")
    return None if s is None else s["stream_ms"] / tot["units"]
