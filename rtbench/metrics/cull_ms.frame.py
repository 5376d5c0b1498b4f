"""cull_ms.frame: the frame's culls (bvh/cull.py cull_clusters_sorted2, as
render/tiled.py calls it: one a closest-hit pass and one a light's shadow
pass), ms a frame summed over them, mean over the window's frames."""
SPANS = {"cull": "tracer_torch.render.tiled:cull_clusters_sorted2"}


def read(t):
    return t.per_unit_ms("cull")
