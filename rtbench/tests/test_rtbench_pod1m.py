"""The pod-1m deployment and its cell pod-1m.pan: the frozen hall against
the program's generator at the configuration's size, the pan path inside
the hall, and a tiny copy of the cell on the CPU (a 3,924-triangle hall,
31 clusters in 2 superclusters, routed to the streamed tier by lowering
api.TILED_MAX_CLUSTERS, where the stream kernels' plain versions run):
correct, traced and untraced, with every reader of the cell reading."""
import copy
import json
import math
import time

import numpy as np
import pytest

from rtbench import generate, harness, scenes

CELL = "pod-1m.pan"
SEED = 2**31 + 4242
TINY_SCENE = {"kind": "hall", "cols_x": 3, "cols_z": 2, "blob_subdiv": 3}
NEW_READERS = ("stream_ms.frame", "stream_roofline.frame", "wavefront_shading_ms.frame",
               "stream_words.frame")


@pytest.fixture(scope="module")
def config():
    return json.loads((harness.HERE / "configs" / "pod-1m.json").read_text())


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


def test_the_config_routes_to_the_streamed_tier(config, hall):
    import types

    from tracer_torch import api

    assert config["tier"] == "streamed"
    cfg = harness.render_config(harness.load_cell(CELL))
    assert api.use_streamed_tier(types.SimpleNamespace(num_tris=len(hall.tris)), cfg)


def test_every_pan_camera_stays_clear_of_the_columns_and_blobs(config, hall):
    cell = harness.load_cell(CELL)
    path = generate.camera_path(cell.traffic["camera"], hall.camera)
    assert len(path) == 120 and path[0]["fov_y_deg"] == 55.0
    # Blobs: the vertices of each accent-material blob, by connected block.
    accent = np.unique(hall.tris[hall.mat_id == 2])
    centres = hall.verts[accent].reshape(-1, len(accent) // 192, 3)
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
        assert math.isclose(math.hypot(*(t - e)[[0, 2]]), 8.0, rel_tol=1e-5) and t[1] == np.float32(1.4)
    head = np.asarray(path[0]["look_at"]) - np.asarray(path[0]["position"])
    assert abs(head[0]) < 1e-5 and head[2] < 0      # the preset looks down -z


def tiny_cell(height: int = 24, width: int = 40) -> harness.Cell:
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["scene"] = TINY_SCENE
    cell.config["triangles"] = len(scenes.make(TINY_SCENE).tris)
    cell.config["render"] = dict(cell.config["render"], height=height, width=width)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["camera"].update(eye=[1.5, 1.7, 1.0], look_distance=2.0)
    return cell


@pytest.fixture
def streamed(monkeypatch):
    from tracer_torch import api
    from tracer_torch.utils import metrics

    monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", 2)
    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(streamed, trace):
    cell = tiny_cell()
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
    assert m["readbacks.frame"] == 10.0     # three passes' S, k, need; the overflow
    assert m["stream_roofline.frame"] > 0


def test_the_tier_is_checked(streamed, monkeypatch):
    from tracer_torch import api

    monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", 2048)
    with pytest.raises(ValueError, match="routes to the tiled tier"):
        harness.run_cell(tiny_cell(), SEED, 0.1, False, "cpu", time.time())


@pytest.mark.card
def test_the_control_fails_at_the_cells_size():
    """On the card, at the cell's own size: the program is correct and the
    control (the reference with TF32 products in the program's place) fails
    the cell's numbers, on three seeds. (test_rtbench_card.py sends a loop
    other than "frames" to the grad readings; this loop's extras are the
    frames loop's, so the frames control applies.)"""
    import torch

    from rtbench import calibrate, checks

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(CELL)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        # 4 s: about 30 frames, so that every 16th from the seed's offset
        # keeps one for the check.
        res = harness.run_cell(cell, seed, 4.0, False, "cuda", time.time())
        assert res["correct"], res["checks"]
        values = dict(calibrate.frame_control(res, torch.device("cuda")), overflow=0)
        ok, judged = checks.judge(values, cell.limits)
        assert not ok, judged
