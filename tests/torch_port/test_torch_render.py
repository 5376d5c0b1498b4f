"""The whole tracer_torch slice vs the JAX package on the CPU: the port's
render_tiled (its own scene, accel, cull and plain kernel versions) against
the reference's render_tiled with interpret-mode Pallas kernels and caps
wide enough to be exact, through the golden image gate."""
import jax
import numpy as np
import pytest

from tracer.bvh import build_scene_accel as j_build_accel
from tracer.core.camera import Camera as JCamera
from tracer.render.tiled import render_tiled as j_render_tiled
from tracer.render.whitted import WhittedConfig as JWhittedConfig
from tracer.scene import procedural as jproc
from tracer_torch.api import benchmark, get_scene, make_render_fn
from tracer_torch.bvh.cluster import build_scene_accel
from tracer_torch.core.camera import Camera
from tracer_torch.render.tiled import render_tiled
from tracer_torch.render.whitted import WhittedConfig
from tracer_torch.scene import procedural as tproc
from tracer_torch.utils.config import load_config

from parity_util import golden_check

WIDE = 1 << 20  # caps the reference clamps to the cluster counts: no truncation

CASES = {
    # name: (scene builder, H, W, bounces)
    "bunny3": (lambda m, **kw: m.bunny_scene(3, **kw), 64, 64, 1),
    # Mirror blobs: covers bounce rays and dead-ray (d = 0) masking; 2 lights.
    "hall": (lambda m, **kw: m.columned_hall(cols_x=4, cols_z=3, blob_subdiv=3, **kw),
             64, 64, 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_tiled_matches_reference(name):
    build, h, w, bounces = CASES[name]
    j_scene, cam = build(jproc)
    t_scene, _ = build(tproc, device="cpu")
    j_render = jax.jit(lambda scene, accel, camera: j_render_tiled(
        scene, accel, camera, h, w, JWhittedConfig(max_bounces=bounces),
        interpret=True, with_aux=True, k_closest=WIDE, k_cap=WIDE, s_cap=WIDE))
    j_img, j_aux = j_render(j_scene, jax.jit(j_build_accel)(j_scene), JCamera.make(**cam))
    img, aux = render_tiled(t_scene, build_scene_accel(t_scene),
                            Camera.make(**cam, device="cpu"), h, w,
                            WhittedConfig(max_bounces=bounces), with_aux=True)
    assert int(j_aux["overflow"]) == 0 and aux["overflow"] == 0
    assert aux["live_rays"] == int(j_aux["live_rays"])
    # Tile partition needs (the reference's caps path reports no k/s needs).
    for key in ("need_split", "need_zero", "need_sh_b1", "need_sh_zero"):
        assert aux[key] == int(j_aux[key]), key
    img = img.numpy()
    assert img.max() > 0.05, "the frame must be lit"
    golden_check(img, np.asarray(j_img))


def test_api_render_fn_and_benchmark_keys():
    """make_render_fn builds the accel once per scene object; benchmark
    returns the reference's keys (timed on the CPU here, so its numbers
    describe the CPU and name it)."""
    cfg = load_config("bunny512", height=32, width=32, scene_arg=3)
    scene, camera = get_scene(cfg, "cpu")
    run = make_render_fn(scene, cfg, "cpu")
    img, aux = run(scene, camera, with_aux=True)
    accel = run.state["accel"]
    np.testing.assert_array_equal(run(scene, camera).numpy(), img.numpy())
    assert run.state["accel"] is accel
    assert img.shape == (32, 32, 3) and aux["overflow"] == 0
    res = benchmark(cfg, iters=1, warmup=1, device="cpu")
    assert {"ms_per_frame", "rays_per_s", "primary_rays_per_s", "live_rays_per_s",
            "num_tris", "overflow", "image"} <= set(res)
    assert res["device"] == "cpu" and res["overflow"] == 0
    assert res["num_tris"] == scene.num_tris
    np.testing.assert_array_equal(res["image"], img.numpy())


@pytest.mark.parametrize("override", [{"dtype": "bfloat16"}, {"profile": True}])
def test_make_render_fn_refuses_what_it_cannot_honour(override):
    """A config field the port does not implement raises instead of being
    ignored: the port renders in float32 and has no profile option."""
    cfg = load_config("bench100k", **override)
    scene, _ = get_scene(load_config("cornell256"), "cpu")
    with pytest.raises(ValueError, match="float32"):
        make_render_fn(scene, cfg, "cpu")
