"""The comparison that decides `correct` fails what it must: the control
(the reference, computed with TF32 products, put in the program's place)
and each fault a cell can have, planted under the timed path of a whole
run at a tiny size on the CPU. The harness's look for a card is skipped:
run_cell is driven directly."""
import time

import numpy as np
import pytest
import torch

from rtbench import calibrate, checks, harness, plugins, reference
from tiny import tiny_cell

SEED = 2**31 + 77


def reference_frame(tf32: bool, scale: float = 1.0):
    """A stand-in for api.render_tiled: the reference's frame of the same
    scene and camera."""

    def frame(scene, accel, camera, height, width, cfg, tr=64, with_aux=False):
        m = scene.materials
        ref_scene = {"verts": scene.verts, "tris": scene.tris, "mat_id": scene.mat_id,
                     "normals": scene.normals, "albedo": m.albedo, "emission": m.emission,
                     "mirror": m.mirror, "specular": m.specular, "shininess": m.shininess,
                     "light_pos": scene.lights.position, "light_int": scene.lights.intensity}
        deg = float(camera.fov_y) / float(np.float32(np.pi / 180))
        cam = {"position": camera.position, "look_at": camera.look_at, "fov_y_deg": deg}
        img = reference.render_image(ref_scene, cam, height, width, cfg.max_bounces, tf32) * scale
        return (img, {"overflow": 0}) if with_aux else img

    return frame


def run(cell):
    return harness.run_cell(cell, SEED, 1.5, False, "cpu", time.time())


def test_a_sound_frame_run_passes_and_the_stand_in_is_sound(monkeypatch):
    from tracer_torch import api

    cell = tiny_cell("bench100k.orbit")
    assert run(cell)["correct"]
    monkeypatch.setattr(api, "render_tiled", reference_frame(tf32=False))
    assert run(cell)["correct"]


@pytest.mark.parametrize("config", ["bench100k", "bunny512"])
def test_frame_control_fails(monkeypatch, config):
    from tracer_torch import api

    cell = tiny_cell(f"{config}.orbit", 48, 64)
    monkeypatch.setattr(api, "render_tiled", reference_frame(tf32=True))
    res = run(cell)
    assert not res["correct"]
    c = res["checks"]["bad_pixel_share"]
    assert c["value"] > c["limit"]


def test_frame_answer_altered_fails(monkeypatch):
    from tracer_torch import api

    cell = tiny_cell("bench100k.orbit")
    monkeypatch.setattr(api, "render_tiled", reference_frame(tf32=False, scale=1.01))
    assert not run(cell)["correct"]


def test_frame_overflow_fails(monkeypatch):
    from tracer_torch import api

    orig = api.render_tiled

    def dropping(*args, **kwargs):
        img, aux = orig(*args, **kwargs)
        return img, dict(aux, overflow=1)

    monkeypatch.setattr(api, "render_tiled", dropping)
    res = run(tiny_cell("bench100k.orbit"))
    assert not res["correct"] and res["checks"]["overflow"]["value"] > 0


def test_fit_control_fails():
    cell = tiny_cell("bunny512.fit")
    res = run(cell)
    assert res["correct"]
    ex = res["extras"]
    values = dict(calibrate.grad_readings(res, torch.device("cpu"))["control"], overflow=0)
    ok, _ = checks.judge(values, cell.limits)
    assert not ok


def test_fit_state_unchanged_fails(monkeypatch):
    from tracer_torch import api

    make = api.make_grad_step_fn

    def frozen_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def frozen(scene, camera, target, params, opt):
            saved = {k: v.detach().clone() for k, v in params.items()}
            out = step(scene, camera, target, params, opt)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            return out

        return frozen

    monkeypatch.setattr(api, "make_grad_step_fn", frozen_make)
    res = run(tiny_cell("bunny512.fit"))
    assert not res["correct"] and res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_fit_half_batch_fails(monkeypatch):
    from tracer_torch import api
    from tracer_torch.bvh.cluster import build_scene_accel
    from tracer_torch.render.whitted import WhittedConfig

    def half_loss(scene, camera, target, cfg, tiled, tracers=None):
        img, aux = api.render_tiled(scene, build_scene_accel(scene), camera, cfg.height,
                                    cfg.width, WhittedConfig(cfg.max_bounces, cfg.smooth_shading),
                                    with_aux=True)
        return calibrate.half_mse(img, target), aux["overflow"]

    monkeypatch.setattr(api, "image_loss", half_loss)
    assert not run(tiny_cell("bunny512.fit"))["correct"]


def test_fit_answer_altered_fails(monkeypatch):
    from tracer_torch import api

    orig = api.render_tiled

    def brighter(*args, **kwargs):
        img, aux = orig(*args, **kwargs)
        return img * 1.01, aux

    monkeypatch.setattr(api, "render_tiled", brighter)
    assert not run(tiny_cell("bunny512.fit"))["correct"]


def late_fault(kind: str):
    """make_grad_step_fn whose steps go wrong only after the first steps
    that warm the program up: from then on the step returns its state
    unchanged, or its image is altered where it is produced, by 10 % (one
    of 1 % reads 6e-4 to 0.04 against late_loss_gap's 0.03 at this size,
    with the window's length: the first steps' numbers catch that one)."""
    from tracer_torch import api

    make, render = api.make_grad_step_fn, api.render_tiled
    first = plugins.load("loops", "grad", harness.ROOT).FIRST_STEPS
    calls = {"n": 0}

    def brighter(*args, **kwargs):
        img, aux = render(*args, **kwargs)
        return (img * 1.1 if calls["n"] > first else img), aux

    def faulty_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(scene, camera, target, params, opt):
            calls["n"] += 1
            if kind != "state_unchanged" or calls["n"] <= first:
                return step(scene, camera, target, params, opt)
            saved = {k: v.detach().clone() for k, v in params.items()}
            out = step(scene, camera, target, params, opt)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            return out

        return faulty

    return faulty_make, brighter


@pytest.mark.parametrize("kind", ["state_unchanged", "answer_altered"])
def test_fit_fault_after_the_first_steps_fails(monkeypatch, kind):
    """A fault that shows only once the window runs passes the first steps'
    numbers and fails the step after the window."""
    from tracer_torch import api

    faulty_make, brighter = late_fault(kind)
    monkeypatch.setattr(api, "make_grad_step_fn", faulty_make)
    monkeypatch.setattr(api, "render_tiled", brighter)
    res = run(tiny_cell("bunny512.fit"))
    judged = res["checks"]
    assert not res["correct"]
    assert all(judged[k]["value"] <= judged[k]["limit"]
               for k in ("first_loss_gap", "grad_gap", "change_gap"))
    late = [k for k in judged if k.startswith("late_") and judged[k]["value"] > judged[k]["limit"]]
    assert late and (kind != "state_unchanged" or judged["late_change_gap"]["value"] == 1.0)
