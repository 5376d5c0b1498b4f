"""The readers of the program's own spans and counters read numbers from a
CPU run of the program's recorder (tracer_torch.utils.metrics), and
nothing where it recorded nothing or where the program has no recorder."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtbench import harness

FRAME = ["cull_stage1_ms.frame", "cull_stage2_ms.frame", "rows_gather_ms.frame",
         "shading_ms.frame", "readbacks.frame", "readback_wait_ms.frame"]
GRAD = ["accel_build_ms.grad", "autograd_ms.grad", "adam_ms.grad", "readbacks.grad"]


@pytest.fixture(scope="module")
def bunny():
    """A 5,122-triangle bunny (3 superclusters, so both cull stages run),
    16x16, 1 bounce, 1 light, tiled tier."""
    from tracer_torch import api
    from tracer_torch.utils.config import load_config

    cfg = load_config("bunny-grad", height=16, width=16, scene_arg=4, use_pallas=True)
    scene, camera = api.get_scene(cfg, "cpu")
    return cfg, scene, camera


@pytest.fixture(autouse=True)
def empty_recorder():
    from tracer_torch.utils import metrics

    metrics.reset()
    yield
    metrics.reset()


def run_units(bunny, n: int):
    """n frames and n grad steps under the profiler."""
    from tracer_torch import api

    cfg, scene, camera = bunny
    render = api.make_render_fn(scene, cfg, "cpu")
    params = api.grad_params(scene, camera, ("verts",))
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    step = api.make_grad_step_fn(cfg, scene, camera, "auto", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            render(scene, camera, with_aux=True)
            step(scene, camera, torch.zeros(16, 16, 3), params, opt)


@pytest.mark.parametrize("name", FRAME + GRAD)
def test_a_reader_reads_a_cpu_run(bunny, name):
    run_units(bunny, 2)
    v = harness.load_metric(name).read(None)
    assert isinstance(v, float) and v > 0
    if name.startswith("readbacks."):
        assert v == 10.0


@pytest.mark.parametrize("name", FRAME + GRAD)
def test_a_reader_reads_nothing_where_nothing_was_recorded(name):
    assert harness.load_metric(name).read(None) is None


def test_a_program_without_the_recorder_gives_nothing(bunny, monkeypatch):
    from tracer_torch.utils import metrics

    run_units(bunny, 1)
    assert metrics.span_totals("frame")["units"] == 1
    monkeypatch.delattr(metrics, "span_totals")
    for name in FRAME + GRAD:
        assert harness.load_metric(name).read(None) is None


def test_the_means_are_per_unit(bunny):
    run_units(bunny, 1)
    one = {n: harness.load_metric(n).read(None) for n in ("readbacks.frame", "readbacks.grad")}
    run_units(bunny, 2)
    assert {n: harness.load_metric(n).read(None) for n in one} == one
    from tracer_torch.utils import metrics

    assert metrics.span_totals("grad.step")["units"] == 3
