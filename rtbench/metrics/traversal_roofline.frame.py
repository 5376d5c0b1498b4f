"""traversal_roofline.frame: the traversal kernels' least time on the
card (rtbench/roofline.py: operations over 67 TFLOP/s against bytes over
3.35 TB/s, counted from the candidate lists the wrappers received) as a
share of the wrappers' own time, over the first frames of the window."""
from rtbench import roofline

SPANS = {"traversal.closest": "tracer_torch.render.tiled:trace_tiles_split",
         "traversal.anyhit": "tracer_torch.render.tiled:any_hit_tiles_graded"}
KEEP = tuple(SPANS)


def read(t):
    closest, anyhit = t.kept("traversal.closest"), t.kept("traversal.anyhit")
    if not closest or not anyhit:
        return None
    bound = 0.0
    for _, (o_t, _d, accel, words, counts), (bt, *_rest) in closest:
        bound += roofline.closest_split_ms(words, counts, bt, o_t.shape[1], accel.cluster_size)
    for _, (_o, _d, tmax, accel, words, counts), (occ, *_rest) in anyhit:
        bound += roofline.anyhit_ms(words, counts, occ, tmax, accel.cluster_size)
    units = {u for u, _, _ in closest} | {u for u, _, _ in anyhit}
    ms = t.units_ms(SPANS, units)
    return 100.0 * bound / ms if ms > 0 else None
