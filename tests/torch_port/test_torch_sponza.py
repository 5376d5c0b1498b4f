"""The sponza1080 deployment's path, the tiled tier through
api.make_render_fn (cull_clusters_sorted2 -> trace_tiles_split /
any_hit_tiles_graded -> render_tiled) at three bounces and two lights, on
the CPU where the kernels' plain versions run: a 3,924-triangle columned
hall (3 x 2 columns, blobs of subdivision 3, the blobs a 0.25 mirror: 31
clusters in 2 superclusters, so both cull stages run). Its frames against
rtbench/reference.py (plain PyTorch brute force, no code shared with the
program) from seeded cameras that look at a blob; the counter
"bounce_words" and the span "render.bounce" of the bounces after the
primary pass, and what a one-bounce frame records of them (nothing); the
preset's routing without building its scene."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtbench import reference
from tracer_torch import api
from tracer_torch.bvh.cluster import CLUSTER_SIZE, build_scene_accel
from tracer_torch.core.camera import Camera
from tracer_torch.render import tiled
from tracer_torch.scene import procedural
from tracer_torch.utils import metrics
from tracer_torch.utils.config import PRESETS, RenderConfig

H, W = 24, 32
# The reference's golden-image threshold: a pixel whose largest channel is
# off by more than this is a bad pixel (rtbench/checks.py GATE_ABS).
GATE_ABS = 2e-3
# The blobs' centres (x, z) in the 3 x 2 hall: every second column's cell.
BLOBS = ((0.5, 0.5), (2.5, 0.5), (1.5, 1.5))
SEEDS = (1, 7, 12)
# Read-backs of one pass: the cull's S, k and need, then the wrapper's
# regions; a frame's passes are each bounce's closest-hit pass and its two
# shadow passes, then the overflow and the live rays.
CLOSEST = ["cull.s", "cull.k", "cull.need", "closest.regions"]
SHADOW = ["cull.s", "cull.k", "cull.need", "anyhit.regions"]
READBACKS = (CLOSEST + SHADOW * 2) * 3 + ["render.overflow", "render.live_rays"]
# The spans under "render.bounce" in a frame where every pass finds
# candidates: the passes' culls and the shading between them.
BOUNCE_CHILDREN = {"cull.stage1", "cull.stage2", "readback.cull.need",
                   "readback.closest.regions", "render.rows", "render.surface",
                   "render.lights", "readback.anyhit.regions", "render.shade"}


@pytest.fixture(scope="module")
def hall():
    scene, _ = procedural.columned_hall(cols_x=3, cols_z=2, blob_subdiv=3, device="cpu")
    accel = build_scene_accel(scene)
    assert scene.lights.count == 2 and accel.num_clusters == 31
    assert accel.super_lo.shape[0] == 2
    assert float(scene.materials.mirror.max()) == 0.25
    return scene


@pytest.fixture
def recorder():
    metrics.reset()
    yield
    metrics.reset()


def render_cfg(bounces: int) -> RenderConfig:
    return RenderConfig(scene="hall", height=H, width=W, max_bounces=bounces,
                        use_bvh=True, use_pallas=True)


def seeded_camera(seed: int) -> dict:
    """An eye inside the hall 0.6-1.0 from a seeded blob, 0.6-1.2 high,
    looking at the blob's centre (height 0.35) give or take 0.1."""
    rng = np.random.default_rng(seed)
    bx, bz = BLOBS[rng.integers(len(BLOBS))]
    while True:
        a, r = rng.uniform(0, 2 * np.pi), rng.uniform(0.6, 1.0)
        eye = np.array([bx + r * np.cos(a), rng.uniform(0.6, 1.2), bz + r * np.sin(a)])
        if 0.1 < eye[0] < 2.9 and 0.1 < eye[2] < 1.9:
            break
    look = np.array([bx, 0.35, bz]) + rng.uniform(-0.1, 0.1, 3)
    return dict(position=tuple(np.float32(eye)), look_at=tuple(np.float32(look)), fov_y_deg=55.0)


def reference_image(scene, cam: dict, bounces: int) -> torch.Tensor:
    m = scene.materials
    ref_scene = {"verts": scene.verts, "tris": scene.tris, "mat_id": scene.mat_id,
                 "normals": scene.normals, "albedo": m.albedo, "emission": m.emission,
                 "mirror": m.mirror, "specular": m.specular, "shininess": m.shininess,
                 "light_pos": scene.lights.position, "light_int": scene.lights.intensity}
    ref_cam = {"position": torch.tensor(cam["position"]), "look_at": torch.tensor(cam["look_at"]),
               "fov_y_deg": cam["fov_y_deg"]}
    return reference.render_image(ref_scene, ref_cam, H, W, bounces)


def counted(monkeypatch) -> list:
    """The (name, n) of every counter raise render_tiled makes, in order."""
    calls = []
    orig = tiled.count

    def keep(name, n=1):
        calls.append((name, n))
        orig(name, n)

    monkeypatch.setattr(tiled, "count", keep)
    return calls


def test_three_bounce_frames_match_the_reference(hall, recorder, monkeypatch):
    """Every pixel within GATE_ABS of the reference; the blobs' mirror is in
    view and changes the frame; on at least one camera both later bounces'
    closest-hit passes hand their kernel lists that hold candidates (k past
    the 8 of an empty pass)."""
    calls = counted(monkeypatch)
    run = api.make_render_fn(hall, render_cfg(3), "cpu")
    n_tiles = H * W // 64
    both = []
    for seed in SEEDS:
        cam = seeded_camera(seed)
        calls.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            img, aux = run(hall, Camera.make(**cam, device="cpu"), with_aux=True)
        assert aux["overflow"] == 0 and isinstance(aux["overflow"], int)
        ref = reference_image(hall, cam, 3)
        assert float(ref.max()) > 0.05, "the frame must be lit"
        assert int(((img - ref).abs().amax(-1) > GATE_ABS).sum()) == 0, seed
        one = reference_image(hall, cam, 1)
        assert int(((ref - one).abs().amax(-1) > GATE_ABS).sum()) > 0, seed
        # Two later bounces, three passes each: the closest-hit pass first.
        assert [c[0] for c in calls] == ["bounce_words"] * 6
        words = [n for _, n in calls]
        assert all(n % n_tiles == 0 and n >= 8 * n_tiles for n in words)
        both.append(words[0] > 8 * n_tiles and words[3] > 8 * n_tiles)
        assert metrics.span_totals("frame")["counters"]["bounce_words"] == sum(words)
        metrics.reset()
    assert any(both)


def test_a_profiled_frame_records_each_bounce(hall, recorder):
    """Under the profiler: one "render.bounce" span for each bounce after
    the first, a child of the frame, holding that bounce's passes and
    shading; the frame's read-backs, nine passes' and the two final ones, in
    order; the image the same as with the recorder off."""
    run = api.make_render_fn(hall, render_cfg(3), "cpu")
    camera = Camera.make(**seeded_camera(12), device="cpu")
    img = run(hall, camera)
    assert metrics.span_records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img_on = run(hall, camera)
    assert torch.equal(img, img_on)
    recs = metrics.span_records()
    bounces = [r for r in recs if r.name == "render.bounce"]
    assert len(bounces) == 2 and {r.parent for r in bounces} == {"frame"}
    under = {r.name for r in recs if r.parent == "render.bounce"}
    assert under == BOUNCE_CHILDREN
    assert {r.parent for r in recs if r.name == "render.rays"} == {"frame"}
    assert {r.parent for r in recs if r.name == "render.untile"} == {"frame"}
    assert [r.name.removeprefix("readback.") for r in recs
            if r.name.startswith("readback.")] == READBACKS
    tot = metrics.span_totals("frame")
    assert tot["spans"]["render.bounce"]["calls"] == 2
    assert tot["counters"]["readbacks"] == len(READBACKS)
    assert tot["counters"]["bounce_words"] > 0 and tot["counters"]["cull_spills"] == 9
    (f0, f1), = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name == "frame"]
    ranges = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name == "render.bounce"]
    assert len(ranges) == 2 and all(f0 <= a and b <= f1 for a, b in ranges)


def test_a_one_bounce_frame_records_no_bounce(hall, recorder):
    run = api.make_render_fn(hall, render_cfg(1), "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        run(hall, Camera.make(**seeded_camera(12), device="cpu"))
    recs = metrics.span_records()
    assert recs and not [r for r in recs if r.name == "render.bounce"]
    tot = metrics.span_totals("frame")
    assert "bounce_words" not in tot["counters"]
    assert tot["counters"]["readbacks"] == 3 * 4 + 2


def test_the_sponza1080_preset_routes_to_the_tiled_tier():
    """The preset's hall at scale 0 (12 x 8 columns, blobs of subdivision
    4: 6 shell quads, 96 columns of 12 triangles, 48 blobs of 5,120) has
    246,924 triangles, 1,930 clusters: within TILED_MAX_CLUSTERS, at 1080p,
    3 bounces. Counted, not built."""
    cfg = PRESETS["sponza1080"]
    assert (cfg.scene, cfg.scene_arg, cfg.height, cfg.width, cfg.max_bounces) == (
        "hall", 0, 1080, 1920, 3)
    assert cfg.use_bvh and cfg.use_pallas and cfg.smooth_shading
    cols_x, cols_z, subdiv = 12, 8, 4
    n_tris = 6 * 2 + cols_x * cols_z * 12 + (cols_x * cols_z + 1) // 2 * 20 * 4 ** subdiv
    assert n_tris == 246_924 and -(-n_tris // CLUSTER_SIZE) == 1930

    class Sized:
        num_tris = n_tris

    assert not api.use_streamed_tier(Sized, cfg)
    assert -(-n_tris // CLUSTER_SIZE) <= api.TILED_MAX_CLUSTERS
