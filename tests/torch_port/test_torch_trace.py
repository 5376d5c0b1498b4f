"""The program's spans and read-back counters (tracer_torch.utils.metrics):
off without a profiler; under torch.profiler, every span of a tiled frame
and of a tiled grad step with its parent, one unit id a root, the
read-backs at their sites in their order, and a record_function range of
each span inside its root's range; images, losses and updates bit-equal on
and off; readback's values; the record cap. The tiled tier on the CPU (the
kernels' plain versions): a 5,122-triangle bunny, 3 superclusters, 1
bounce, 1 light."""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tracer_torch import api
from tracer_torch.utils import metrics
from tracer_torch.utils.config import load_config

# The frame's spans and each one's parent, in the tiled tier with more than
# one supercluster.
FRAME_SPANS = {
    "render.rays": "ROOT", "cull.stage1": "ROOT", "readback.cull.s": "cull.stage1",
    "cull.stage2": "ROOT", "readback.cull.k": "cull.stage2", "readback.cull.need": "ROOT",
    "readback.closest.regions": "ROOT", "render.rows": "ROOT", "render.surface": "ROOT",
    "render.lights": "ROOT", "readback.anyhit.regions": "ROOT", "render.shade": "ROOT",
    "render.untile": "ROOT", "readback.render.overflow": "ROOT",
    "readback.render.live_rays": "ROOT"}
GRAD_SPANS = {"grad.zero": "grad.step", "grad.params": "grad.step",
              "grad.accel": "grad.step", "grad.loss": "grad.step",
              "grad.backward": "grad.step", "grad.rows_sum": "grad.backward",
              "grad.adam": "grad.step"}
# The read-backs of one bounce and one light, in order: the closest-hit
# pass's cull and wrapper, the shadow pass's, the frame's end.
READBACKS = ["cull.s", "cull.k", "cull.need", "closest.regions",
             "cull.s", "cull.k", "cull.need", "anyhit.regions",
             "render.overflow", "render.live_rays"]


@pytest.fixture(scope="module")
def bunny():
    cfg = load_config("bunny-grad", height=16, width=16, scene_arg=4, use_pallas=True)
    scene, camera = api.get_scene(cfg, "cpu")
    assert cfg.max_bounces == 1 and scene.lights.count == 1
    assert api.use_tiled_grad(scene, cfg, "auto")
    from tracer_torch.bvh.cluster import build_scene_accel

    assert build_scene_accel(scene).super_lo.shape[0] > 1
    return cfg, scene, camera


@pytest.fixture(autouse=True)
def empty_recorder():
    metrics.reset()
    yield
    metrics.reset()


def frame(bunny):
    cfg, scene, camera = bunny
    return api.make_render_fn(scene, cfg, "cpu")(scene, camera, with_aux=True)


def grad_step(bunny):
    """One tiled grad step from fresh parameters -> (loss, params after)."""
    cfg, scene, camera = bunny
    params = api.grad_params(scene, camera, ("verts", "albedo", "cam_pos"))
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    step = api.make_grad_step_fn(cfg, scene, camera, "auto", device="cpu")
    loss, params, _, _ = step(scene, camera, torch.full((16, 16, 3), 0.2), params, opt)
    return loss, {k: v.detach() for k, v in params.items()}


def profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof.events()


def check_spans(events, root: str, want: dict):
    """The records: the root and exactly the spans of `want` with their
    parents, all in the root's one unit; the profiler: a range of each
    span's name inside the root's range."""
    recs = metrics.span_records()
    parents = {r.name: {q.parent for q in recs if q.name == r.name} for r in recs}
    assert parents == {root: {None}, **{k: {v.replace("ROOT", root)} for k, v in want.items()}}
    units = {r.unit for r in recs}
    assert len(units) == 1 and None not in units
    ranges = {}
    for e in events:
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    (r0, r1), = ranges[root]
    for name in want:
        assert ranges.get(name), f"no profiler range named {name}"
        assert all(r0 <= a and b <= r1 for a, b in ranges[name]), name
    return recs


def test_off_without_a_profiler(bunny):
    assert not torch.autograd._profiler_enabled()
    frame(bunny)
    grad_step(bunny)
    metrics.count("readbacks")
    assert metrics.span_records() == []
    assert metrics.span_totals("frame") == {} and metrics.span_totals("grad.step") == {}


def test_a_frame_records_every_span(bunny):
    _, events = profiled(frame, bunny)
    recs = check_spans(events, "frame", FRAME_SPANS)
    assert [r.name.removeprefix("readback.") for r in recs
            if r.name.startswith("readback.")] == READBACKS
    tot = metrics.span_totals("frame")
    assert tot["units"] == 1 and tot["counters"] == {"readbacks": len(READBACKS),
                                                     "cull_spills": 2}
    assert tot["spans"]["cull.stage1"]["calls"] == tot["spans"]["cull.stage2"]["calls"] == 2
    assert all(s["stream_ms"] == s["host_ms"] >= 0 for s in tot["spans"].values())
    assert tot["dropped"] == 0 and metrics.span_totals("grad.step") == {}


def gathered_rows(bunny) -> tuple[int, int, int]:
    """(rays, slots, incidences): the entries of the tiled step's per-ray
    shade gather (the tiles' rays), of each per-slot gather of
    build_clusters (the padded slots) and of make_vertex_normal_fn's gather
    (vertices x the largest vertex degree)."""
    from tracer_torch.bvh.cluster import build_scene_accel
    from tracer_torch.kernels.traversal import generate_rays_tiled

    cfg, scene, camera = bunny
    o_t, _, _ = generate_rays_tiled(camera, cfg.height, cfg.width, 64)
    degree = int(torch.bincount(scene.tris.reshape(-1).long()).max())
    return (o_t.shape[0] * o_t.shape[1], build_scene_accel(scene).shade.shape[0],
            scene.verts.shape[0] * degree)


def test_a_grad_step_records_every_span(bunny):
    _, events = profiled(grad_step, bunny)
    want = dict(GRAD_SPANS, **{k: v.replace("ROOT", "grad.step") for k, v in FRAME_SPANS.items()})
    recs = check_spans(events, "grad.step", want)
    assert [r.name.removeprefix("readback.") for r in recs
            if r.name.startswith("readback.")] == READBACKS
    tot = metrics.span_totals("grad.step")
    # The row sums: the shade rows a ray; of each slot its 3 corners'
    # vertices, their 3 normals (verts) and its albedo (albedo); the face
    # normals of each vertex's incidences (verts).
    rays, slots, incidences = gathered_rows(bunny)
    assert tot["units"] == 1 and tot["counters"] == {
        "readbacks": len(READBACKS), "rows_summed": rays + 7 * slots + incidences,
        "cull_spills": 2}
    assert tot["spans"]["grad.rows_sum"]["calls"] == 5
    assert metrics.span_totals("frame") == {}


def test_a_backward_on_another_thread_lands_in_the_step(bunny, monkeypatch):
    """On a card autograd runs the backward on a thread of its own (with the
    profiler's thread-local state); the recorder's units and open spans are
    the process's, so the row sums' spans and counts land under the main
    thread's "grad.backward" in its "grad.step" unit. Here a plain thread,
    which torch gives no profiler state, stands in with the check forced on."""
    import threading

    cfg, scene, camera = bunny
    params = api.grad_params(scene, camera, ("verts", "albedo"))
    loss, _ = api.image_loss(*api._apply_grad_params(scene, camera, params), torch.zeros(16, 16, 3),
                             cfg, tiled=True)
    monkeypatch.setattr(metrics, "_on", lambda: True)
    with metrics.span("grad.step"), metrics.span("grad.backward"):
        worker = threading.Thread(target=loss.backward)
        worker.start()
        worker.join()
    recs = [r for r in metrics.span_records() if r.name == "grad.rows_sum"]
    assert len(recs) == 4 and {(r.parent, r.unit) for r in recs} == {("grad.backward", 0)}
    rays, slots, _ = gathered_rows(bunny)
    assert metrics.span_totals("grad.step")["counters"] == {"rows_summed": rays + 7 * slots}


def test_units_and_counters_of_several_roots(bunny):
    cfg, scene, camera = bunny
    run = api.make_render_fn(scene, cfg, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("outside"):
            metrics.count("readbacks", 5)
        run(scene, camera)
        run(scene, camera)
    recs = metrics.span_records()
    assert recs[0].name == "outside" and recs[0].unit is None
    assert len({r.unit for r in recs[1:]}) == 2
    tot = metrics.span_totals("frame")
    assert tot["units"] == 2 and tot["counters"] == {"readbacks": 2 * len(READBACKS),
                                                     "cull_spills": 4}
    assert "outside" not in tot["spans"] and tot["spans"]["frame"]["calls"] == 2


def test_bit_equal_on_and_off(bunny):
    img, aux = frame(bunny)
    (img_on, aux_on), _ = profiled(frame, bunny)
    assert torch.equal(img, img_on) and aux == aux_on
    loss, params = grad_step(bunny)
    (loss_on, params_on), _ = profiled(grad_step, bunny)
    assert torch.equal(loss, loss_on)
    for k in params:
        assert torch.equal(params[k], params_on[k]), k
    assert metrics.span_totals("grad.step")["units"] == 1


@pytest.mark.parametrize("on", [False, True])
def test_readback_returns_what_the_read_returned(on):
    ints = torch.tensor([3, 0, 7], dtype=torch.int32)
    cases = [(ints.max(), int(ints.max())), (ints.max(), ints.max().item()),
             (torch.tensor(2.5), 2.5), (ints, [3, 0, 7]),
             (torch.zeros((), dtype=torch.int64), 0)]
    with profile(activities=[ProfilerActivity.CPU]) if on else contextlib.nullcontext():
        with metrics.span("frame"):
            for x, want in cases:
                got = metrics.readback(x, "test")
                assert got == want and type(got) is type(want)
    tot = metrics.span_totals("frame")
    assert (tot["counters"]["readbacks"] if on else tot) == (len(cases) if on else {})


def test_the_record_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(metrics, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("frame"):
            for i in range(4):
                with metrics.span(f"part{i}"):
                    pass
        with metrics.span("frame"):
            metrics.count("readbacks")
    assert [r.name for r in metrics.span_records()] == ["frame", "part0", "part1"]
    tot = metrics.span_totals("frame")
    assert tot["dropped"] == 3 and tot["units"] == 1 and tot["counters"] == {}
    metrics.reset()
    assert metrics.span_records() == [] and metrics.span_totals("frame") == {}
