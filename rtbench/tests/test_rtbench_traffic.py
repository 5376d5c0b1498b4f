"""The traffic generator: camera paths and the fit's perturbation, from the
seed; the frozen scene copy against the program's own generators."""
import json
import math

import numpy as np
import pytest

from rtbench import generate, harness, scenes

TRAFFIC = {n: json.loads((harness.HERE / "traffic" / f"{n}.json").read_text())
           for n in ("orbit", "near", "fit")}
SEED = 2**31 + 987654321


@pytest.mark.parametrize("config,traffic", [("bench100k", "orbit"), ("bunny512", "orbit"),
                                            ("bench100k", "near")])
def test_paths_are_periodic_and_seeded(config, traffic):
    preset = scenes.make(harness.load_cell(f"{config}.{traffic}").config["scene"]).camera
    path = generate.camera_path(TRAFFIC[traffic]["camera"], preset)
    assert len(path) == 120
    assert path == generate.camera_path(TRAFFIC[traffic]["camera"], preset)
    assert generate.start_index(SEED, 120) == generate.start_index(SEED, 120)
    starts = {generate.start_index(SEED + k, 120) for k in range(20)}
    assert len(starts) > 5 and all(0 <= s < 120 for s in starts)
    views = {tuple(c["position"]) for c in path}
    assert len(views) == 120


def test_orbit_circles_the_preset_look_at():
    preset = scenes.make({"kind": "bench"}).camera
    path = generate.camera_path(TRAFFIC["orbit"]["camera"], preset)
    assert np.allclose(path[0]["position"], preset["position"], atol=1e-6)
    for c in path:
        x, y, z = c["position"]
        assert math.isclose(math.hypot(x, z), 5.5, rel_tol=1e-6)
        assert math.isclose(y, 2.6, rel_tol=1e-6)
        assert np.allclose(c["look_at"], (0.0, 0.6, 0.0)) and c["fov_y_deg"] == 50.0
    bunny = generate.camera_path(TRAFFIC["orbit"]["camera"], scenes.make({"kind": "bunny"}).camera)
    assert all(math.isclose(math.hypot(c["position"][0], c["position"][2]), 2.6, rel_tol=1e-6)
               and np.allclose(c["look_at"], (0.0, 0.65, 0.0)) for c in bunny)


def test_near_looks_outward_at_the_ring():
    path = generate.camera_path(TRAFFIC["near"]["camera"], scenes.make({"kind": "bench"}).camera)
    for c in path:
        e, t = np.asarray(c["position"]), np.asarray(c["look_at"])
        assert np.allclose([math.hypot(e[0], e[2]), e[1]], [1.2, 0.9], rtol=1e-6)
        assert np.allclose([math.hypot(t[0], t[2]), t[1]], [2.2, 0.5], rtol=1e-6)
        assert np.dot(e[[0, 2]], t[[0, 2]]) > 0


def test_perturbation_is_seeded_and_bounded():
    a = scenes.make({"kind": "bunny", "subdiv": 3})
    spec = TRAFFIC["fit"]["target"]
    p, q = generate.perturbed(a, spec, SEED), generate.perturbed(a, spec, SEED)
    assert all(np.array_equal(p[k], q[k]) for k in p)
    r = generate.perturbed(a, spec, SEED + 1)
    assert not np.array_equal(p["verts"], r["verts"])
    moved = np.linalg.norm(p["verts"] - a.verts, axis=1)
    amp = spec["vert_amplitude"]
    assert 0.3 * amp < moved.max() <= amp * 1.0001
    ratio = p["albedo"] / a.albedo
    assert ratio.min() >= 0.8 and ratio.max() <= 1.2
    assert math.isclose(np.linalg.norm(p["cam_pos"] - np.asarray(a.camera["position"])), 0.05,
                        rel_tol=1e-5)


@pytest.mark.parametrize("spec,make", [
    ({"kind": "bench", "num_blobs": 5, "subdiv": 5}, lambda p: p.bench_scene(device="cpu")),
    ({"kind": "bunny", "subdiv": 6}, lambda p: p.bunny_scene(subdiv=6, device="cpu")),
])
def test_frozen_scenes_equal_the_programs(spec, make):
    from tracer_torch.scene import procedural

    a = scenes.make(spec)
    s, cam = make(procedural)
    m = s.materials
    pairs = {"verts": s.verts, "tris": s.tris, "mat_id": s.mat_id, "normals": s.normals,
             "albedo": m.albedo, "emission": m.emission, "mirror": m.mirror,
             "specular": m.specular, "shininess": m.shininess,
             "light_pos": s.lights.position, "light_int": s.lights.intensity}
    for k, t in pairs.items():
        assert np.array_equal(getattr(a, k), t.numpy()), k
    assert a.camera == cam


def test_configs_state_their_scenes():
    for name in ("bench100k", "bunny512"):
        cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
        a = scenes.make(cfg["scene"])
        assert len(a.tris) == cfg["triangles"] and len(a.light_pos) == cfg["lights"]
