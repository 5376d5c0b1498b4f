"""The plain reference against the program on the CPU at a tiny size (the
program's kernels run their plain versions there), and the harness driven
through whole runs of each cell's loop."""
import time

import pytest
import torch

from rtbench import harness, reference
from tiny import tiny_cell


@pytest.mark.parametrize("config", ["bench100k", "bunny512"])
def test_reference_frame_agrees_with_the_program(config):
    from tracer_torch import api
    from tracer_torch.core.camera import Camera

    cell = tiny_cell(f"{config}.orbit", 40, 56)
    arrays = harness.scene_arrays(cell)
    scene = harness.program_scene(arrays, "cpu")
    rcfg = harness.render_config(cell)
    img, aux = api.make_render_fn(scene, rcfg, "cpu")(scene, Camera.make(**arrays.camera,
                                                                         device="cpu"),
                                                      with_aux=True)
    ref = reference.render_image(harness.reference_scene(arrays, "cpu"),
                                 harness.reference_camera(arrays.camera, "cpu"),
                                 rcfg.height, rcfg.width, rcfg.max_bounces)
    assert aux["overflow"] == 0 and float(ref.max()) > 0.05
    assert float((img - ref).abs().max()) < 1e-4


def test_reference_pixels_are_the_frames_pixels():
    cell = tiny_cell("bunny512.orbit", 24, 40)
    arrays = harness.scene_arrays(cell)
    scene = harness.reference_scene(arrays, "cpu")
    cam = harness.reference_camera(arrays.camera, "cpu")
    img = reference.render_image(scene, cam, 24, 40, 1)
    ys, xs = torch.tensor([0, 23, 11, 5]), torch.tensor([0, 39, 20, 33])
    assert torch.equal(reference.render_pixels(scene, cam, 24, 40, ys, xs, 1), img[ys, xs])


def test_mirror_bounce_and_two_lights():
    """The reference's Whitted terms a later configuration may need: a
    mirror bounce and a second light, against the program's tiled tier."""
    import dataclasses

    import numpy as np
    from tracer_torch import api
    from tracer_torch.core.camera import Camera

    cell = tiny_cell("bench100k.orbit", 32, 48)
    a = harness.scene_arrays(cell)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    a = dataclasses.replace(a, mirror=f32([0.0, 0.0, 0.6]),
                            light_pos=f32(a.light_pos.repeat(2, 0) * [[1, 1, 1], [-1, 1, 0.5]]),
                            light_int=f32(a.light_int.repeat(2, 0) * 0.6))
    scene = harness.program_scene(a, "cpu")
    rcfg = harness.render_config(cell).replace(max_bounces=2)
    img = api.make_render_fn(scene, rcfg, "cpu")(scene, Camera.make(**a.camera, device="cpu"))
    ref = reference.render_image(harness.reference_scene(a, "cpu"),
                                 harness.reference_camera(a.camera, "cpu"), 32, 48, 2)
    assert float((img - ref).abs().amax(-1).gt(2e-3).float().mean()) < 0.01


@pytest.mark.parametrize("name", ["bench100k.orbit", "bunny512.fit"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_run_is_correct(name, trace):
    cell = tiny_cell(name)
    res = harness.run_cell(cell, 2**31 + 5, 1.5, trace, "cpu", time.time())
    assert res["correct"], res["checks"]
    assert cell.traffic["loop"] == "grad" or \
        res["attempted"] >= harness.find_loop(cell).SAMPLE_STRIDE
    if trace:
        assert set(res["metrics"]) <= set(cell.per_layer)
        for v in res["metrics"].values():
            assert v == v and v != 0.0          # measured, never a stand-in 0
    else:
        assert set(res["metrics"]) == set(cell.end_to_end)
        assert all(v > 0 for v in res["metrics"].values())
