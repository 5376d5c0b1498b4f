"""The reader of the culls' spills (the program's counter "cull_spills")
reads nothing where nothing was recorded, where the program has no
recorder or no such counter (as before the cull kernels), every pass from a
CPU run (the plain cull sorts each pass with torch.sort), and a unit's mean
from the recorder's totals."""
from test_rtbench_program_spans import bunny, empty_recorder  # noqa: F401
from torch.profiler import ProfilerActivity, profile

from rtbench import harness

NAME = "cull_spills.frame"


def frames(bunny, n: int):
    """n frames under the profiler."""
    from tracer_torch import api

    cfg, scene, camera = bunny
    render = api.make_render_fn(scene, cfg, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            render(scene, camera, with_aux=True)


def test_the_reader_reads_nothing_where_nothing_was_recorded():
    assert harness.load_metric(NAME).read(None) is None


def test_a_cpu_run_reads_every_pass(bunny):
    """Two frames of one bounce and one light: a primary and a shadow cull
    each."""
    frames(bunny, 2)
    assert harness.load_metric(NAME).read(None) == 2.0


def test_a_program_without_the_counter_or_the_recorder_reads_nothing(bunny, monkeypatch):
    from tracer_torch.bvh import cull
    from tracer_torch.utils import metrics

    monkeypatch.setattr(cull, "count", lambda *a: None)
    frames(bunny, 1)
    assert metrics.span_totals("frame")["units"] == 1
    assert harness.load_metric(NAME).read(None) is None
    monkeypatch.delattr(metrics, "span_totals")
    assert harness.load_metric(NAME).read(None) is None


def test_the_reader_reads_a_units_mean():
    """Three frames whose passes counted 1 + 0, 0 + 0 and 1 + 1 spills."""
    from tracer_torch.utils import metrics

    with profile(activities=[ProfilerActivity.CPU]):
        for passes in ((1, 0), (0, 0), (1, 1)):
            with metrics.span("frame"):
                for n in passes:
                    metrics.count("cull_spills", n)
    assert metrics.span_totals("frame")["counters"]["cull_spills"] == 3
    assert harness.load_metric(NAME).read(None) == 1.0
