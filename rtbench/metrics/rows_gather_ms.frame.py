"""rows_gather_ms.frame: render/tiled.py _trace_rows' gather of the
packed shade rows by slot id (accel.shade[gid], where gradients enter; the
program span "render.rows"), stream ms a frame.

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
    s = tot["spans"].get("render.rows")
    return None if s is None else s["stream_ms"] / tot["units"]
