"""cull_stage2_ms.frame: stage 2 of the frame's culls (bvh/cull.py
cull_clusters_sorted2: the box table, the chunk loop, the cut, the cat and
the excess sums, through the read of k; the program span "cull.stage2"),
stream ms a frame summed over both culls.

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
    s = tot["spans"].get("cull.stage2")
    return None if s is None else s["stream_ms"] / tot["units"]
