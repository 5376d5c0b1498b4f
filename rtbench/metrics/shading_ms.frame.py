"""shading_ms.frame: render/tiled.py render_tiled's shading: the hit
recompute and material columns ("render.surface"), each light's target
and shadow segments ("render.lights"), its BRDF and falloff and the
bounce's radiance ("render.shade"), stream ms a frame.

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
    parts = [tot["spans"].get(n) for n in ("render.surface", "render.lights", "render.shade")]
    return None if None in parts else sum(s["stream_ms"] for s in parts) / tot["units"]
