"""The sponza1080 deployment and its cell sponza1080.look: the frozen hall
against the program's generator at the configuration's size, the look path
inside the hall, and a tiny copy of the cell on the CPU (a 3,924-triangle
hall, 31 clusters in 2 superclusters, the tiled tier's plain versions) at
the cell's 3 bounces and 2 lights: correct, traced and untraced, with every
reader of the cell reading. On the card, at the cell's size: the program
is correct, and the two controls fail the cell's numbers."""
import copy
import json
import math
import time

import numpy as np
import pytest

from rtbench import generate, harness, scenes
from tiny import tiny_cell as tiny_tiled

CELL = "sponza1080.look"
SEED = 2**31 + 2525
TINY_SCENE = {"kind": "hall", "cols_x": 3, "cols_z": 2, "blob_subdiv": 3}
NEW_READERS = ("bounce_ms.frame", "bounce_words.frame")
CONTROL_SEEDS = (2**31 + 251, 2**31 + 252, 2**31 + 253)


@pytest.fixture(scope="module")
def config():
    return json.loads((harness.HERE / "configs" / "sponza1080.json").read_text())


@pytest.fixture(scope="module")
def hall(config):
    return scenes.make(config["scene"])


def test_the_frozen_hall_equals_the_programs(config, hall):
    from tracer_torch.scene import procedural

    p = dict(config["scene"])
    p.pop("kind")
    s, cam = procedural.columned_hall(**p, device="cpu")
    m = s.materials
    pairs = {"verts": s.verts, "tris": s.tris, "mat_id": s.mat_id, "normals": s.normals,
             "albedo": m.albedo, "emission": m.emission, "mirror": m.mirror,
             "specular": m.specular, "shininess": m.shininess,
             "light_pos": s.lights.position, "light_int": s.lights.intensity}
    for k, t in pairs.items():
        assert np.array_equal(getattr(hall, k), t.numpy()), k
    assert hall.camera == cam
    assert (len(hall.tris), len(hall.light_pos)) == (config["triangles"], config["lights"])
    assert config["triangles"] == 246_924 and float(hall.mirror.max()) == 0.25


def test_the_config_is_the_preset_and_routes_to_the_tiled_tier(config, hall):
    import types

    from tracer_torch import api
    from tracer_torch.bvh.cluster import CLUSTER_SIZE
    from tracer_torch.utils.config import PRESETS

    assert config["tier"] == "tiled"
    cfg = harness.render_config(harness.load_cell(CELL))
    assert cfg == PRESETS["sponza1080"]
    assert -(-len(hall.tris) // CLUSTER_SIZE) == 1930 <= api.TILED_MAX_CLUSTERS
    assert not api.use_streamed_tier(types.SimpleNamespace(num_tris=len(hall.tris)), cfg)


def test_every_look_camera_stays_clear_of_the_columns_and_blobs(config, hall):
    cell = harness.load_cell(CELL)
    path = generate.camera_path(cell.traffic["camera"], hall.camera)
    assert len(path) == 120 and path[0]["fov_y_deg"] == 55.0
    # Blobs: the vertices of each accent-material blob, by connected block.
    accent = np.unique(hall.tris[hall.mat_id == 2])
    centres = hall.verts[accent].reshape(-1, len(accent) // 48, 3)
    lo, hi = centres.min(1), centres.max(1)
    cols_x, cols_z = config["scene"]["cols_x"], config["scene"]["cols_z"]
    for c in path:
        e = np.asarray(c["position"], np.float64)
        assert 0 < e[0] < cols_x and 0 < e[1] < 4.0 and 0 < e[2] < cols_z
        # Distance to the nearest column box, in x and z.
        gap = max(abs(e[0] - (math.floor(e[0]) + 0.5)), abs(e[2] - (math.floor(e[2]) + 0.5)))
        assert gap - 0.12 >= 0.3
        assert not ((lo <= e) & (e <= hi)).all(1).any()
        t = np.asarray(c["look_at"], np.float64)
        assert math.isclose(math.hypot(*(t - e)[[0, 2]]), 5.0, rel_tol=1e-5)
        assert t[1] == np.float32(1.4)
    head = np.asarray(path[0]["look_at"]) - np.asarray(path[0]["position"])
    assert abs(head[0]) < 1e-5 and head[2] < 0      # the preset looks down -z


def tiny_cell(height: int = 24, width: int = 40) -> harness.Cell:
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["scene"] = TINY_SCENE
    cell.config["triangles"] = len(scenes.make(TINY_SCENE).tris)
    cell.config["render"] = dict(cell.config["render"], height=height, width=width)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["camera"].update(eye=[1.5, 1.0, 1.0], look_distance=2.0, look_height=0.4)
    return cell


@pytest.fixture
def recorder():
    from tracer_torch.utils import metrics

    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(recorder, trace):
    cell = tiny_cell()
    assert cell.config["render"]["max_bounces"] == 3
    res = harness.run_cell(cell, SEED, 1.0, trace, "cpu", time.time())
    assert res["correct"], res["checks"]
    assert res["checks"]["overflow"]["value"] == 0
    if not trace:
        assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
        return
    # The device's idle share reads a card's profile: none on the CPU.
    assert set(res["metrics"]) == set(cell.per_layer) - {"device_idle_pct.frame"}
    m = res["metrics"]
    for name in NEW_READERS:
        assert m[name] > 0, name
    # Nine passes' S, need and regions, and each pass's k where its cull
    # found a supercluster (always in the primary passes); the overflow and
    # the live rays.
    assert 3 * 4 + 6 * 3 + 2 <= m["readbacks.frame"] <= 9 * 4 + 2
    assert m["traversal_roofline.frame"] > 0


def test_the_new_readers_read_nothing_in_a_one_bounce_cell(recorder):
    cell = tiny_tiled("bench100k.orbit")
    cell.per_layer = dict(cell.per_layer, **{n: harness.load_metric(n) for n in NEW_READERS})
    res = harness.run_cell(cell, SEED, 0.5, True, "cpu", time.time())
    assert res["correct"], res["checks"]
    assert not set(NEW_READERS) & set(res["metrics"])
    assert res["metrics"]["shading_ms.frame"] > 0


def _one_bounce_control(res, device) -> float:
    """The program at max_bounces 1 on the window's sampled frames, against
    the 3-bounce reference on the same pixels -> bad_pixel_share."""
    import torch

    from rtbench import checks, harness as h
    from tracer_torch import api
    from tracer_torch.core.camera import Camera

    ex = res["extras"]
    rcfg = ex["rcfg"].replace(max_bounces=1)
    cell = h.load_cell(CELL)
    scene = h.program_scene(h.scene_arrays(cell), device)
    render = api.make_render_fn(scene, rcfg, device)
    prog = [render(scene, Camera.make(**s["camera"], device=device))[s["ys"], s["xs"]]
            for s in ex["samples"]]
    return checks.bad_pixel_share(torch.cat(prog).float(),
                                  torch.cat([s["ref"] for s in ex["samples"]]))


@pytest.mark.card
def test_the_controls_fail_at_the_cells_size():
    """On the card, at the cell's own size: the program is correct; the
    control (the reference with TF32 products in the program's place) and
    the program at one bounce instead of three each fail the cell's
    numbers, on three seeds. (test_rtbench_card.py sends a loop other than
    "frames" to the grad readings; this loop's extras are the frames
    loop's, so the frames control applies.)"""
    import torch

    from rtbench import calibrate, checks

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(CELL)
    dev = torch.device("cuda")
    for seed in CONTROL_SEEDS:
        # 10 s: at least 32 frames, so that every 16th from the seed's
        # offset keeps two for the check.
        res = harness.run_cell(cell, seed, 10.0, False, "cuda", time.time())
        assert res["correct"], res["checks"]
        values = dict(calibrate.frame_control(res, dev), overflow=0)
        ok, judged = checks.judge(values, cell.limits)
        assert not ok, judged
        share = _one_bounce_control(res, dev)
        assert share > cell.limits["bad_pixel_share"], share
