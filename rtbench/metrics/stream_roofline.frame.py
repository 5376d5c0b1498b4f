"""stream_roofline.frame: the stream kernels' least time on the card
(rtbench/roofline.py: operations over 67 TFLOP/s against bytes over 3.35
TB/s, counted from the candidate lists the wrappers received) as a share
of the wrappers' own time, over the first frames of the window. The
any-hit pass is counted at the t_max its kernel is handed: the wrapper
gives rays with d == 0 (points not lit) t_max 0, so they need no test."""
import torch

from rtbench import roofline

SPANS = {"kernels.stream_closest": "tracer_torch.kernels.stream:trace_tiles_streamed",
         "kernels.stream_anyhit": "tracer_torch.kernels.stream:any_hit_tiles_streamed"}
KEEP = tuple(SPANS)


def read(t):
    closest, anyhit = t.kept("kernels.stream_closest"), t.kept("kernels.stream_anyhit")
    if not closest or not anyhit:
        return None
    bound = 0.0
    for _, (o_t, _d, accel, words, counts), (bt, _gid) in closest:
        bound += roofline.closest_split_ms(words, counts, bt, o_t.shape[1], accel.cluster_size)
    for _, (_o, d_t, tmax, accel, words, counts), occ in anyhit:
        tmax = torch.where((d_t != 0.0).any(-1), tmax, 0.0)
        bound += roofline.anyhit_ms(words, counts, occ, tmax, accel.cluster_size)
    units = {u for u, _, _ in closest} | {u for u, _, _ in anyhit}
    ms = t.units_ms(SPANS, units)
    return 100.0 * bound / ms if ms > 0 else None
