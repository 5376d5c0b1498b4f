"""traversal_ms.frame: the traversal wrappers of kernels/traversal2.py as
render/tiled.py calls them (trace_tiles_split: closest_hit_kernel and
closest_fast_kernel; any_hit_tiles_graded: anyhit_kernel), ms a frame,
mean over the window's frames."""
SPANS = {"traversal.closest": "tracer_torch.render.tiled:trace_tiles_split",
         "traversal.anyhit": "tracer_torch.render.tiled:any_hit_tiles_graded"}


def read(t):
    parts = [t.per_unit_ms(n) for n in SPANS]
    return None if None in parts else sum(parts)
