"""device_idle_pct.frame: 100 x (1 - the union of device activity / the
wall time) over the profiled slice of frames (torch.profiler)."""


def read(t):
    p = t.profile
    if not p or p["busy_ms"] <= 0.0 or p["wall_ms"] <= 0.0:
        return None
    return 100.0 * (1.0 - p["busy_ms"] / p["wall_ms"])
