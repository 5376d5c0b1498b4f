"""tracer_torch's frames against the oracles, on the CPU (the counterpart
of tests/golden/test_cornell.py, test_phong.py and test_golden_cpp.py):
the reference's numpy oracle (tracer.refcpu.oracle.cpu_render) and the
fp64 C++ oracle of cpp/oracle.cpp through the port's own binding
(tracer_torch.refcpu.cpp), neither of which shares code with the port's
renderer. Gates are the reference tests' own: the Cornell box 1.5% of
pixels off by more than 2e-3 and p98 below 1e-4; the rest the golden gate
(parity_util.golden_check: 1.5% and p98 2e-3). The C++ cases skip where
g++ cannot build the oracle; the full-size goldens run on the card
(chip_smoke.py phase 19)."""
import dataclasses

import numpy as np
import pytest
import torch

from tracer.core.camera import Camera as JCamera
from tracer.refcpu import cpp as j_cpp
from tracer.refcpu.oracle import cpu_render
from tracer.render import whitted as jw
from tracer.scene import procedural as jproc
from tracer_torch import api
from tracer_torch.bridge import camera_from_arrays, scene_from_arrays
from tracer_torch.bvh.cluster import build_scene_accel
from tracer_torch.core.camera import Camera, generate_rays
from tracer_torch.refcpu import cpp as cpp_oracle
from tracer_torch.refcpu import oracle as t_oracle
from tracer_torch.render.tiled import render_tiled
from tracer_torch.render.whitted import WhittedConfig, make_brute_tracers, render_image
from tracer_torch.render.whitted import render_wavefront
from tracer_torch.scene.types import Lights, Materials, Scene
from tracer_torch.utils.config import load_config

from parity_util import golden_check, leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small CPU ops: one intra-op thread, the caller's setting
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def need_cpp():
    if not cpp_oracle.available():
        pytest.skip(f"the C++ oracle did not build (g++): {cpp_oracle._load()[1]}")


@pytest.mark.parametrize("smooth", [False, True])
def test_cornell_matches_cpu_oracle(smooth):
    """tests/golden/test_cornell.py's gate: fewer than 1.5% of pixels off by
    more than 2e-3 (rays on the quads' diagonals may pick either triangle),
    p98 below 1e-4."""
    cfg = load_config("cornell256", height=48, width=48, smooth_shading=smooth)
    img = api.render(cfg, device="cpu")
    scene, camera = api.get_scene(cfg, "cpu")
    ref = cpu_render(scene, camera, 48, 48, max_bounces=cfg.max_bounces, smooth_shading=smooth)
    err = np.abs(img - ref).max(axis=-1)
    assert (err > 2e-3).mean() < 0.015, f"{(err > 2e-3).mean():.2%} pixels off"
    assert np.percentile(err, 98) < 1e-4, f"p98 err {np.percentile(err, 98):.2e}"


def test_oracle_copy_is_the_reference_oracle():
    """tracer_torch.refcpu.oracle, the copy chip_smoke.py uses, renders what
    the reference's does, bit for bit, from tensors or arrays."""
    cfg = load_config("cornell256", height=12, width=16, smooth_shading=True)
    scene, camera = api.get_scene(cfg, "cpu")
    np.testing.assert_array_equal(t_oracle.cpu_render(scene, camera, 12, 16),
                                  cpu_render(scene, camera, 12, 16))


def test_cornell_left_right_wall_colors():
    img = api.render("cornell256", height=64, width=64, device="cpu")
    left, right = img[32, 4], img[32, 59]
    assert left[0] > left[1] and left[0] > left[2], f"left wall not red: {left}"
    assert right[1] > right[0] and right[1] > right[2], f"right wall not green: {right}"
    assert np.isfinite(img).all() and img.max() > 0.05


def spec_scene():
    """tests/golden/test_phong.py's scene: a glossy floor and a matte back
    wall, the light on the camera's mirror direction about the floor."""
    verts = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2],
                      [-2, 0, -2], [-2, 2, -2], [2, 2, -2], [2, 0, -2]], np.float32)
    tris = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    mats = Materials.make(albedo=[[0.3, 0.3, 0.35], [0.6, 0.55, 0.5]], specular=[0.8, 0.0],
                          shininess=[24.0, 32.0], device="cpu")
    lights = Lights.make(position=[[0.0, 0.6, -0.9]], intensity=[[4.0, 4.0, 4.0]],
                         device="cpu")
    scene = Scene.make(verts, tris, np.array([0, 0, 1, 1], np.int32), mats, lights,
                       device="cpu")
    cam = Camera.make(position=(0.0, 1.0, 2.8), look_at=(0.0, 0.4, 0.0), fov_y_deg=50.0,
                      device="cpu")
    return scene, cam


PH = 96
PHONG = WhittedConfig(max_bounces=1, smooth_shading=False)


@pytest.fixture(scope="module")
def phong():
    scene, cam = spec_scene()
    brute = render_wavefront(scene, generate_rays(cam, PH, PH), PHONG,
                             *make_brute_tracers(scene)).numpy()
    tiled, aux = render_tiled(scene, build_scene_accel(scene), cam, PH, PH, PHONG,
                              with_aux=True)
    assert aux["overflow"] == 0
    ref = cpu_render(scene, cam, PH, PH, max_bounces=1, smooth_shading=False)
    return scene, cam, {"brute": brute, "tiled": tiled.numpy(), "numpy oracle": ref}


def test_phong_highlight_present(phong):
    """The specular lobe adds a highlight the Lambert-only frame lacks."""
    scene, cam, imgs = phong
    lam = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, specular=torch.zeros_like(scene.materials.specular)))
    img_l = render_wavefront(lam, generate_rays(cam, PH, PH), PHONG,
                             *make_brute_tracers(lam)).numpy()
    assert (imgs["brute"] - img_l).max() > 0.3


@pytest.mark.parametrize("tier", ["brute", "tiled"])
def test_phong_matches_numpy_oracle(phong, tier):
    _, _, imgs = phong
    golden_check(imgs[tier], imgs["numpy oracle"])


@pytest.mark.parametrize("tier", ["brute", "tiled"])
def test_phong_matches_cpp_oracle(phong, tier):
    """Also: the port's binding renders what the reference's binding does
    (the same source, built without -march=native: to 1e-6)."""
    need_cpp()
    scene, cam, imgs = phong
    ref = cpp_oracle.cpp_render(scene, cam, PH, PH, max_bounces=1, smooth_shading=False)
    golden_check(imgs[tier], ref)
    if j_cpp.available():
        np.testing.assert_allclose(ref, j_cpp.cpp_render(scene, cam, PH, PH, max_bounces=1,
                                                         smooth_shading=False),
                                   rtol=1e-6, atol=1e-7)


def test_render_image_matches_reference():
    """render_image (brute by default, and over given tracers) against the
    reference's render_image on one Cornell box, 32x32, both shadings."""
    j_scene, cam = jproc.cornell_box()
    j_cam = JCamera.make(**cam)
    scene = scene_from_arrays(leaves(j_scene), "cpu")
    camera = camera_from_arrays(leaves(j_cam), "cpu")
    for smooth in (False, True):
        cfg_j = jw.WhittedConfig(max_bounces=1, smooth_shading=smooth)
        want = np.asarray(jw.render_image(j_scene, j_cam, 32, 32, cfg_j))
        cfg = WhittedConfig(max_bounces=1, smooth_shading=smooth)
        got = render_image(scene, camera, 32, 32, cfg)
        assert got.shape == (32, 32, 3) and got.device.type == "cpu"
        assert got.numpy().max() > 0.05
        golden_check(got.numpy(), want)
        given = render_image(scene, camera, 32, 32, cfg, *make_brute_tracers(scene))
        assert torch.equal(given, got)


def test_bunny256_tiled_matches_cpp_oracle():
    """bunny512's scene at 256x256 through make_render_fn's tiled tier (the
    traversal2 kernels' plain versions) against the C++ oracle; the bunny
    must cast a visible shadow for this to mean anything."""
    need_cpp()
    cfg = load_config("bunny512", height=256, width=256)
    scene, camera = api.get_scene(cfg, "cpu")
    img, aux = api.make_render_fn(scene, cfg, "cpu")(scene, camera, with_aux=True)
    assert aux["overflow"] == 0
    ref = cpp_oracle.cpp_render(scene, camera, 256, 256, max_bounces=cfg.max_bounces,
                                smooth_shading=cfg.smooth_shading)
    assert img.numpy().max() > 0.05
    golden_check(img.numpy(), ref)
