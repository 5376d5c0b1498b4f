"""wavefront_shading_ms.frame: render/whitted.py's shading in the
streamed tier's wavefront integrator: the shading frame and material rows
("wavefront.surface"), each light's shadow rays ("wavefront.lights"), the
BRDF, falloff, the bounce's radiance and its mirror continuation
("wavefront.shade"), stream ms a frame. The tracers (culls, stream
kernels, recover_hit) run outside these spans.

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no such span."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("frame")
    if not tot:
        return None
    parts = [tot["spans"].get(n) for n in ("wavefront.surface", "wavefront.lights",
                                           "wavefront.shade")]
    return None if None in parts else sum(s["stream_ms"] for s in parts) / tot["units"]
