"""integrator_self_ms.frame: render/tiled.py render_tiled (as api.py's
tiled frame calls it) less the cull and traversal spans inside it, ms a
frame: rays, shading, light targets, the untile and its own read-backs."""
SPANS = {"render": "tracer_torch.api:render_tiled",
         "cull": "tracer_torch.render.tiled:cull_clusters_sorted2",
         "traversal.closest": "tracer_torch.render.tiled:trace_tiles_split",
         "traversal.anyhit": "tracer_torch.render.tiled:any_hit_tiles_graded"}


def read(t):
    parts = [t.per_unit_ms(n) for n in SPANS]
    if None in parts:
        return None
    return parts[0] - sum(parts[1:])
