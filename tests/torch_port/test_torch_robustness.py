"""Degenerate geometry through tracer_torch's tiers (the counterpart of
tests/unit/test_robustness.py): a zero-area triangle, a sliver and an exact
duplicate face beside a plane must give no NaN or Inf pixel in the brute,
tiled and streamed tiers (the plain versions of their kernels here), and
each tier's frame must agree with the port's brute-force frame and with the
reference's: fewer than 1% of values off by more than rtol 1e-4 + atol
1e-4, the reference test's own gate, and the golden gate."""
import numpy as np
import pytest
import torch

from tests.unit.test_robustness import degenerate_scene  # noqa: F401 (a fixture)
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.render import whitted as jw
from tracer_torch.bridge import camera_from_arrays, scene_from_arrays
from tracer_torch.bvh.cluster import build_clusters, build_scene_accel
from tracer_torch.core.camera import generate_rays
from tracer_torch.kernels.stream import make_streamed_tracers
from tracer_torch.render.tiled import render_tiled
from tracer_torch.render.whitted import WhittedConfig, make_brute_tracers, render_wavefront

from parity_util import golden_check, leaves

WCFG = WhittedConfig(max_bounces=2, smooth_shading=False)
# The frame size of each tier in tests/unit/test_robustness.py.
SIZES = {"brute": 32, "tiled": 32, "streamed": 24}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(degenerate_scene):  # noqa: F811
    j_scene, j_cam = degenerate_scene
    return j_scene, j_cam, scene_from_arrays(leaves(j_scene), "cpu"), \
        camera_from_arrays(leaves(j_cam), "cpu")


def _frame(tier, scene, cam, size):
    if tier == "tiled":
        img, aux = render_tiled(scene, build_scene_accel(scene), cam, size, size, WCFG,
                                with_aux=True)
        assert aux["overflow"] == 0
        return img.numpy()
    if tier == "streamed":
        # Clusters of 4, as the reference test builds them, so the scene
        # spans more than one cluster.
        tracers = make_streamed_tracers(scene, build_clusters(scene.verts, scene.tris, 4,
                                                              scene=scene))
    else:
        tracers = make_brute_tracers(scene)
    return render_wavefront(scene, generate_rays(cam, size, size), WCFG, *tracers).numpy()


def _agree(img, ref):
    mismatch = np.mean(~np.isclose(img, ref, rtol=1e-4, atol=1e-4))
    assert mismatch < 1e-2, f"{mismatch:.3%} of values differ"
    golden_check(img, ref)


@pytest.mark.parametrize("tier", sorted(SIZES))
def test_degenerate_tier_matches_brute(scenes, tier):
    j_scene, j_cam, scene, cam = scenes
    size = SIZES[tier]
    img = _frame(tier, scene, cam, size)
    assert np.isfinite(img).all(), "non-finite pixels"
    assert img.max() > 0.01, "black frame"
    _agree(img, _frame("brute", scene, cam, size))
    ref = jw.render_wavefront(j_scene, j_generate_rays(j_cam, size, size),
                              jw.WhittedConfig(max_bounces=2, smooth_shading=False),
                              *jw.make_brute_tracers(j_scene))
    _agree(img, np.asarray(ref))
