"""cull_spills.frame: the culls a frame whose words torch.sort ordered (the
program's counter "cull_spills"): on the card a pass whose fullest tile held
more words than a block of the cull kernels sorts in shared memory, 0 for a
pass sorted in the kernels; every pass of the plain cull, which runs on the
CPU.

A unit's mean over the units (frames or steps) that the program's recorder
(tracer_torch.utils.metrics.span_totals) kept while the profiled slice
ran; None where it kept none or the program has no such counter."""
SPANS = {}


def read(t):
    try:
        from tracer_torch.utils.metrics import span_totals
    except ImportError:
        return None
    tot = span_totals("frame")
    if not tot or "cull_spills" not in tot["counters"]:
        return None
    return tot["counters"]["cull_spills"] / tot["units"]
