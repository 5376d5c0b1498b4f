"""The pod-1m deployment's path, the streamed tier through api.make_render_fn
(make_streamed_tracers_aux -> cull_clusters_sorted2 -> trace_tiles_streamed
/ any_hit_tiles_streamed -> render_wavefront_aux), on the CPU where the
stream kernels' plain versions run: a 3,924-triangle columned hall (3 x 2
columns, blobs of subdivision 3: 31 clusters in 2 superclusters, so both
cull stages run) routed to the streamed tier by lowering
api.TILED_MAX_CLUSTERS, with both of the hall's lights and the blobs' 0.25
mirror. Its frames against rtbench/reference.py (plain PyTorch brute
force, no code shared with the program) at 1 and 2 bounces from seeded
cameras; the pod-1m sizes' routing without building the scene; and the
spans, counter and read-backs a profiled streamed frame records."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtbench import reference
from tracer_torch import api
from tracer_torch.bvh.cluster import CLUSTER_SIZE, build_scene_accel
from tracer_torch.core.camera import Camera
from tracer_torch.kernels import stream
from tracer_torch.scene import procedural
from tracer_torch.utils import metrics
from tracer_torch.utils.config import PRESETS, RenderConfig, load_config

H, W = 24, 32
# The reference's golden-image threshold: a pixel whose largest channel is
# off by more than this is a bad pixel (rtbench/checks.py GATE_ABS).
GATE_ABS = 2e-3
# The frame's spans and each one's parent: per pass the cull's two stages
# and its reads, then the wrapper; recover_hit after the closest-hit pass;
# the shading between the passes; the overflow read once at the end.
FRAME_SPANS = {
    "cull.stage1": "frame", "readback.cull.s": "cull.stage1", "cull.stage2": "frame",
    "readback.cull.k": "cull.stage2", "readback.cull.need": "frame",
    "stream.closest": "frame", "stream.recover": "frame", "stream.anyhit": "frame",
    "wavefront.surface": "frame", "wavefront.lights": "frame", "wavefront.shade": "frame",
    "readback.wavefront.overflow": "frame"}
# One bounce, two lights: three passes' S, k and need, then the overflow.
READBACKS = ["cull.s", "cull.k", "cull.need"] * 3 + ["wavefront.overflow"]


@pytest.fixture(scope="module")
def hall():
    scene, cam = procedural.columned_hall(cols_x=3, cols_z=2, blob_subdiv=3, device="cpu")
    accel = build_scene_accel(scene)
    assert scene.lights.count == 2 and accel.num_clusters == 31
    assert accel.super_lo.shape[0] == 2
    return scene, cam


@pytest.fixture
def streamed(monkeypatch):
    monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", 2)
    metrics.reset()
    yield
    metrics.reset()


def seeded_camera(seed: int) -> dict:
    """An eye between the columns (x near 1 or 2, z near 1; the columns sit at
    cell centres with half-width 0.12, the blobs under height 0.73), looking
    2 ahead in a seeded horizontal direction, a little down."""
    rng = np.random.default_rng(seed)
    eye = np.array([rng.choice([1.0, 2.0]) + rng.uniform(-0.2, 0.2), rng.uniform(1.2, 2.2),
                    1.0 + rng.uniform(-0.2, 0.2)])
    a = rng.uniform(0, 2 * np.pi)
    look = eye + np.array([2.0 * np.cos(a), -rng.uniform(0.3, 1.0), 2.0 * np.sin(a)])
    return dict(position=tuple(np.float32(eye)), look_at=tuple(np.float32(look)), fov_y_deg=55.0)


def render_cfg(bounces: int) -> RenderConfig:
    return RenderConfig(scene="hall", height=H, width=W, max_bounces=bounces,
                        use_bvh=True, use_pallas=True)


def reference_image(scene, cam: dict, bounces: int) -> torch.Tensor:
    m = scene.materials
    ref_scene = {"verts": scene.verts, "tris": scene.tris, "mat_id": scene.mat_id,
                 "normals": scene.normals, "albedo": m.albedo, "emission": m.emission,
                 "mirror": m.mirror, "specular": m.specular, "shininess": m.shininess,
                 "light_pos": scene.lights.position, "light_int": scene.lights.intensity}
    ref_cam = {"position": torch.tensor(cam["position"]), "look_at": torch.tensor(cam["look_at"]),
               "fov_y_deg": cam["fov_y_deg"]}
    return reference.render_image(ref_scene, ref_cam, H, W, bounces)


@pytest.mark.parametrize("bounces", [1, 2])
@pytest.mark.parametrize("seed", [19, 1901])
def test_the_streamed_frame_matches_the_reference(hall, streamed, bounces, seed):
    """Every pixel within GATE_ABS of the reference, at most one pixel
    aside: the program traces a shadow from the surface toward the light and
    the reference from the light to the surface, so a ray that grazes an
    edge may fall either way."""
    scene, _ = hall
    cfg = render_cfg(bounces)
    assert api.use_streamed_tier(scene, cfg)
    cam = seeded_camera(seed)
    img, aux = api.make_render_fn(scene, cfg, "cpu")(scene, Camera.make(**cam, device="cpu"), with_aux=True)
    assert aux["overflow"] == 0 and isinstance(aux["overflow"], int)
    assert set(aux) == {"overflow", "need_trace_k", "need_occ_k", "need_s"}
    ref = reference_image(scene, cam, bounces)
    assert float(ref.max()) > 0.05, "the frame must be lit"
    bad = int(((img - ref).abs().amax(-1) > GATE_ABS).sum())
    assert bad <= 1, bad


def test_the_second_bounce_is_seen(hall, streamed):
    """The blobs' mirror makes the 2-bounce frame differ from the 1-bounce
    one where a blob is in view, in the program as in the reference."""
    scene, _ = hall
    cam = dict(position=(2.0, 1.2, 1.0), look_at=(1.5, 0.35, 1.5), fov_y_deg=55.0)
    imgs = [api.make_render_fn(scene, render_cfg(b), "cpu")(scene, Camera.make(**cam, device="cpu"))
            for b in (1, 2)]
    refs = [reference_image(scene, cam, b) for b in (1, 2)]
    moved = (imgs[1] - imgs[0]).abs().amax(-1) > GATE_ABS
    assert int(moved.sum()) > 10
    assert torch.equal(moved, (refs[1] - refs[0]).abs().amax(-1) > GATE_ABS)


def test_the_pod1m_sizes_route_to_the_streamed_tier():
    """The preset's hall at scale 1 (24 x 16 columns, blobs of subdivision 5:
    6 shell quads, 384 columns of 12 triangles, 192 blobs of 20,480) has
    3,936,780 triangles, 30,757 clusters: past TILED_MAX_CLUSTERS. Counted,
    not built."""
    cfg = load_config("pod-1m", max_bounces=1)
    assert PRESETS["pod-1m"].scene == "hall" and cfg.scene_arg == 1
    cols_x, cols_z, subdiv = 12 * (1 + cfg.scene_arg), 8 * (1 + cfg.scene_arg), 5
    n_tris = 6 * 2 + cols_x * cols_z * 12 + (cols_x * cols_z + 1) // 2 * 20 * 4 ** subdiv
    assert n_tris == 3_936_780 and -(-n_tris // CLUSTER_SIZE) == 30_757

    class Sized:
        num_tris = n_tris

    assert api.use_streamed_tier(Sized, cfg)
    assert not api.use_streamed_tier(Sized, load_config("pod-1m", use_pallas=False))


def test_a_profiled_streamed_frame_records_its_spans(hall, streamed, monkeypatch):
    scene, _ = hall
    cam = seeded_camera(19)
    words = []
    for name in ("trace_tiles_streamed", "any_hit_tiles_streamed"):
        orig = getattr(stream, name)

        def keep(*args, _orig=orig):
            words.append(args[-2].numel())
            return _orig(*args)

        monkeypatch.setattr(stream, name, keep)
    run = api.make_render_fn(scene, render_cfg(1), "cpu")
    camera = Camera.make(**cam, device="cpu")
    img, aux = run(scene, camera, with_aux=True)
    assert metrics.span_records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img_on, aux_on = run(scene, camera, with_aux=True)
    assert torch.equal(img, img_on) and aux == aux_on
    recs = metrics.span_records()
    parents = {r.name: {q.parent for q in recs if q.name == r.name} for r in recs}
    assert parents == {"frame": {None}, **{k: {v} for k, v in FRAME_SPANS.items()}}
    assert [r.name.removeprefix("readback.") for r in recs
            if r.name.startswith("readback.")] == READBACKS
    tot = metrics.span_totals("frame")
    assert len(words) == 6 and words[:3] == words[3:]
    assert tot["units"] == 1 and tot["counters"] == {"readbacks": len(READBACKS),
                                                     "stream_words": sum(words[3:]),
                                                     "cull_spills": 3}
    calls = {k: v["calls"] for k, v in tot["spans"].items()}
    assert calls["stream.closest"] == calls["stream.recover"] == 1
    assert calls["stream.anyhit"] == calls["wavefront.lights"] == 2
    assert calls["cull.stage1"] == calls["cull.stage2"] == 3
    names = {e.name for e in prof.events()}
    assert set(FRAME_SPANS) <= names
