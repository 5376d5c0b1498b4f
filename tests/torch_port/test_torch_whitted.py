"""tracer_torch's wavefront Whitted integrator (render/whitted.py) and the
routing of api.make_render_fn and api.build_tracers, vs the JAX package on
the CPU (interpret-mode Pallas kernels), through the golden image gate; and
the API's ensure_exact / live_rays_per_s contracts."""

import jax
import numpy as np
import pytest

import tracer.api as japi
from tracer.bvh.cluster import build_clusters
from tracer.core.camera import Camera as JCamera
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.kernels import stream as jstream
from tracer.render import whitted as jw
from tracer.scene import procedural as jproc
from tracer.utils.config import load_config as j_load_config
from tracer_torch import api
from tracer_torch.bridge import accel_from_arrays, scene_from_arrays
from tracer_torch.core.camera import Camera, generate_rays
from tracer_torch.kernels import stream as ts
from tracer_torch.kernels import traversal2 as tt2
from tracer_torch.render import whitted as tw
from tracer_torch.utils.config import RenderConfig, load_config

from parity_util import golden_check, leaves

STREAMED_AUX = {"overflow", "need_trace_k", "need_occ_k", "need_s"}


def test_render_wavefront_aux_matches_reference():
    """A small columned hall (mirror blobs, 2 lights) at 32x32 with 2
    bounces through the streamed tracers, one JAX accel (cluster_size=32)
    on both sides: the images pass the golden gate, and no pixel is off by
    1e-4 (the largest error was 8.9e-8 when this was written)."""
    j_scene, cam = jproc.columned_hall(cols_x=2, cols_z=2, blob_subdiv=2)
    assert j_scene.lights.count == 2 and float(j_scene.materials.mirror.max()) > 0
    accel = jax.jit(build_clusters, static_argnums=2)(j_scene.verts, j_scene.tris, 32)
    n_cl, n_sc = accel.num_clusters, accel.super_lo.shape[0]
    cfg = jw.WhittedConfig(max_bounces=2)

    @jax.jit
    def j_render(scene, accel, camera):
        tracers = jstream.make_streamed_tracers_aux(scene, accel, k_cap=n_cl, s_cap=n_sc,
                                                    interpret=True)
        return jw.render_wavefront_aux(scene, j_generate_rays(camera, 32, 32), cfg, *tracers)

    j_img, j_aux = j_render(j_scene, accel, JCamera.make(**cam))
    t_scene = scene_from_arrays(leaves(j_scene), "cpu")
    tracers = ts.make_streamed_tracers_aux(t_scene, accel_from_arrays(leaves(accel), "cpu"))
    img, aux = tw.render_wavefront_aux(
        t_scene, generate_rays(Camera.make(**cam, device="cpu"), 32, 32),
        tw.WhittedConfig(max_bounces=2), *tracers)
    assert set(aux) == STREAMED_AUX
    assert aux["overflow"] == 0 and int(j_aux["overflow"]) == 0
    assert aux["need_trace_k"] > 0 and aux["need_occ_k"] > 0
    img = img.numpy()
    assert img.max() > 0.05, "the frame must be lit"
    golden_check(img, np.asarray(j_img))
    assert np.abs(img - np.asarray(j_img)).max() < 1e-4


def test_brute_wavefront_matches_reference():
    """render_wavefront over the brute-force tracers (flat shading) on the
    Cornell box, against the reference's."""
    j_scene, cam = jproc.cornell_box()
    cfg = jw.WhittedConfig(max_bounces=1, smooth_shading=False)
    j_img = jax.jit(lambda s, c: jw.render_wavefront(
        s, j_generate_rays(c, 32, 32), cfg, *jw.make_brute_tracers(s)))(j_scene,
                                                                       JCamera.make(**cam))
    t_scene = scene_from_arrays(leaves(j_scene), "cpu")
    img = tw.render_wavefront(t_scene, generate_rays(Camera.make(**cam, device="cpu"), 32, 32),
                              tw.WhittedConfig(max_bounces=1, smooth_shading=False),
                              *tw.make_brute_tracers(t_scene)).numpy()
    assert img.max() > 0.05
    golden_check(img, np.asarray(j_img))


def _bunny_cfg(**kw):
    return {"height": 32, "width": 32, "scene_arg": 3, "use_pallas": True, **kw}


def test_make_render_fn_routes_to_streamed_tier(monkeypatch, tmp_path):
    """Over the cluster threshold (monkeypatched to 2), a use_pallas config
    renders through the streamed tier, and matches the reference's streamed
    render fn (forced to interpret mode past its own threshold of 2)."""
    monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", 2)
    monkeypatch.setattr(japi, "_FORCE_STREAMED_INTERPRET", True)
    monkeypatch.setattr(japi, "_VMEM_RESIDENT_CLUSTERS", 2)
    monkeypatch.setenv("TRACER_CAPS_CACHE", str(tmp_path / "caps.json"))
    cfg = load_config("bunny-grad", **_bunny_cfg())
    scene, camera = api.get_scene(cfg, "cpu")
    assert api.use_streamed_tier(scene, cfg)
    before = dict(tt2.LAUNCHES)
    img, aux = api.make_render_fn(scene, cfg, "cpu")(scene, camera, with_aux=True)
    assert set(aux) == STREAMED_AUX and aux["overflow"] == 0
    assert tt2.LAUNCHES == before, "CPU tensors launch no kernel"
    j_cfg = j_load_config("bunny-grad", **_bunny_cfg())
    j_scene, j_cam = japi.get_scene(j_cfg)
    j_img, j_aux = japi.make_render_fn(j_scene, j_cfg)(j_scene, j_cam, with_aux=True)
    assert int(j_aux["overflow"]) == 0
    golden_check(img.numpy(), np.asarray(j_img))


@pytest.mark.parametrize("override", [{}, {"use_pallas": False}, {"use_bvh": False}])
def test_make_render_fn_keeps_tiled_tier(monkeypatch, override):
    """A use_bvh + use_pallas config at or under the threshold keeps the
    tiled tier (its aux counts live rays). Without use_pallas, or without
    use_bvh, a config renders through the wavefront integrator over
    build_tracers, whatever the threshold: aux is {"overflow": 0}."""
    if override:
        monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", 2)
    cfg = load_config("bunny-grad", **{**_bunny_cfg(), **override})
    scene, camera = api.get_scene(cfg, "cpu")
    assert not api.use_streamed_tier(scene, cfg)
    img, aux = api.make_render_fn(scene, cfg, "cpu")(scene, camera, with_aux=True)
    assert img.shape == (32, 32, 3) and float(img.max()) > 0.05
    if override:
        assert aux == {"overflow": 0}
    else:
        assert {"overflow", "live_rays", "need_split"} <= set(aux) and aux["overflow"] == 0


@pytest.mark.parametrize("preset", ["cornell256", "bunny-grad"])
def test_make_render_fn_wavefront_matches_reference(preset):
    """The presets that are not use_bvh + use_pallas (brute force for
    cornell256, the plain cluster tier for bunny-grad) at 32x32 against the
    JAX package's make_render_fn, which takes the same path off the TPU:
    the golden gate (edge ties on the Cornell box's axis-aligned walls flip
    11 of its 1,024 pixels, none on the bunny), and a median error under
    1e-6 (it was 3e-8 and 0 when this was written)."""
    cfg = load_config(preset, height=32, width=32)
    scene, camera = api.get_scene(cfg, "cpu")
    before = dict(tt2.LAUNCHES)
    img, aux = api.make_render_fn(scene, cfg, "cpu")(scene, camera, with_aux=True)
    assert aux == {"overflow": 0} and tt2.LAUNCHES == before
    j_cfg = j_load_config(preset, height=32, width=32)
    j_scene, j_cam = japi.get_scene(j_cfg)
    j_img, j_aux = japi.make_render_fn(j_scene, j_cfg)(j_scene, j_cam, with_aux=True)
    assert int(j_aux["overflow"]) == 0
    img = img.numpy()
    assert img.max() > 0.05, "the frame must be lit"
    golden_check(img, np.asarray(j_img))
    err = np.abs(img - np.asarray(j_img)).max(-1)
    assert np.median(err) < 1e-6


@pytest.mark.parametrize("override, threshold, factory", [
    ({"use_bvh": False, "use_pallas": False}, 2048, "make_brute_tracers"),
    ({"use_bvh": True, "use_pallas": False}, 2, "make_accel_tracers"),
    ({"use_bvh": True, "use_pallas": True}, 2048, "make_sorted_tracers"),
    ({"use_bvh": True, "use_pallas": True}, 2, "make_streamed_tracers"),
], ids=["brute", "accel", "sorted", "streamed"])
def test_build_tracers_picks_the_factory(monkeypatch, override, threshold, factory):
    """The four config classes of tracer/api.py:build_tracers, told apart by
    the factory whose closures come back; each pair traces the scene."""
    monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", threshold)
    cfg = load_config("bunny-grad", height=16, width=16, **override)
    scene, camera = api.get_scene(cfg, "cpu")
    trace_fn, occlude_fn = api.build_tracers(scene, cfg)
    assert trace_fn.__qualname__.startswith(factory + ".")
    assert occlude_fn.__qualname__.startswith(factory + ".")
    rays = generate_rays(camera, 16, 16)
    hit = trace_fn(rays)
    want = tw.make_brute_tracers(scene)[0](rays)
    np.testing.assert_array_equal(hit.tri.numpy(), want.tri.numpy())
    assert hit.valid.any()


@pytest.mark.parametrize("threshold", [2, api.TILED_MAX_CLUSTERS], ids=["streamed", "tiled"])
def test_ensure_exact_is_accepted(monkeypatch, threshold):
    """run(..., ensure_exact=True) on both tiers: every frame is exact by
    construction, so it returns the frame it would without the flag."""
    monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", threshold)
    cfg = load_config("bunny-grad", **_bunny_cfg(height=16, width=16))
    scene, camera = api.get_scene(cfg, "cpu")
    run = api.make_render_fn(scene, cfg, "cpu")
    img, aux = run(scene, camera, with_aux=True, ensure_exact=True)
    assert aux["overflow"] == 0
    np.testing.assert_array_equal(img.numpy(), run(scene, camera).numpy())


def test_benchmark_streamed_has_no_live_rays(monkeypatch):
    """The streamed tier counts no live rays: benchmark reports
    live_rays_per_s None, as the reference's benchmark does for it."""
    monkeypatch.setattr(api, "TILED_MAX_CLUSTERS", 2)
    res = api.benchmark("bunny-grad", iters=1, warmup=1, device="cpu",
                        **_bunny_cfg(height=16, width=16))
    assert res["live_rays_per_s"] is None
    assert res["overflow"] == 0 and res["rays_per_s"] > 0 and res["device"] == "cpu"


def test_docstrings_state_the_routing():
    for doc in (RenderConfig.__doc__, api.make_render_fn.__doc__):
        doc = " ".join(doc.split())
        assert "TILED_MAX_CLUSTERS" in doc and "streamed tier" in doc
        assert "tiled tier" in doc and "wavefront integrator" in doc
        assert "build_tracers" in doc and "brute force" in doc
