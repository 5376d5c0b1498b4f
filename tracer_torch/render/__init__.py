from tracer_torch.render.whitted import (
    WhittedConfig, direct_lighting, make_brute_tracers, render_image, render_wavefront,
    shading_frame)

__all__ = [
    "WhittedConfig", "render_image", "render_wavefront", "make_brute_tracers",
    "shading_frame", "direct_lighting",
]
