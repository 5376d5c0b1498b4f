"""tracer_torch.core.camera's jittered and banded rays against the JAX
package's (tracer.core.camera), on one camera fed to both through
tracer_torch.bridge. Directions are held to 2^-22 (XLA's CPU rsqrt is not
1/sqrt: parity_util.assert_unit_close); origins exactly. Within the port,
a band is bit-equal to those rows of the full frame, and generate_rays
without jitter is bit-equal to the pixel-centre arithmetic it had before
it took a jitter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.core.camera import Camera as JCamera
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.core.camera import generate_rays_band as j_generate_rays_band
from tracer_torch.bridge import camera_from_arrays
from tracer_torch.core.camera import generate_rays, generate_rays_band
from tracer_torch.core.types import normalize

from parity_util import assert_unit_close, leaves

H, W = 24, 40


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cams():
    jcam = JCamera.make(position=(0.3, 1.1, 4.0), look_at=(0.1, 0.2, 0.0), fov_y_deg=50.0)
    return jcam, camera_from_arrays(leaves(jcam), "cpu")


def _jitter(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (h, w, 2)).astype(np.float32)


def test_jittered_rays_match_reference(cams):
    jcam, cam = cams
    jit = _jitter(H, W)
    want = j_generate_rays(jcam, H, W, jitter=jnp.asarray(jit))
    got = generate_rays(cam, H, W, jitter=torch.from_numpy(jit))
    assert_unit_close(want.d, got.d)
    np.testing.assert_array_equal(got.o.numpy(), np.asarray(want.o))


@pytest.mark.parametrize("y0, band_h, jittered", [(0, 5, False), (7, 9, False), (16, 8, True)])
def test_band_matches_reference(cams, y0, band_h, jittered):
    """The band keeps the full image's NDC divisors: it is a window into
    the H x W frame, on both sides."""
    jcam, cam = cams
    jit = _jitter(band_h, W, seed=y0) if jittered else None
    want = j_generate_rays_band(jcam, H, W, y0, band_h,
                                None if jit is None else jnp.asarray(jit))
    got = generate_rays_band(cam, H, W, y0, band_h,
                             None if jit is None else torch.from_numpy(jit))
    assert got.d.shape == (band_h, W, 3)
    assert_unit_close(want.d, got.d)
    np.testing.assert_array_equal(got.o.numpy(), np.asarray(want.o))


def test_band_is_rows_of_the_frame(cams):
    """Bit-equal to the full frame's rows, with and without jitter."""
    _, cam = cams
    full = generate_rays(cam, H, W)
    jit = torch.from_numpy(_jitter(H, W, seed=3))
    full_j = generate_rays(cam, H, W, jitter=jit)
    for y0, band_h in ((0, H), (3, 5), (H - 1, 1)):
        band = generate_rays_band(cam, H, W, y0, band_h)
        assert torch.equal(band.d, full.d[y0:y0 + band_h])
        assert torch.equal(band.o, full.o[y0:y0 + band_h])
        band_j = generate_rays_band(cam, H, W, y0, band_h, jit[y0:y0 + band_h])
        assert torch.equal(band_j.d, full_j.d[y0:y0 + band_h])


def test_unjittered_rays_unchanged(cams):
    """generate_rays(jitter=None) is bit-equal to the pixel-centre
    arithmetic of the port before jitter and bands, so no frame moves."""
    _, cam = cams
    right, up, fwd = cam.basis()
    tan_half = torch.tan(cam.fov_y * 0.5)
    yy = torch.arange(H, dtype=torch.float32)[:, None]
    xx = torch.arange(W, dtype=torch.float32)[None, :]
    ndc_x = ((xx + 0.5) / W * 2.0 - 1.0) * (W / H) * tan_half
    ndc_y = (1.0 - (yy + 0.5) / H * 2.0) * tan_half
    d = normalize(ndc_x[..., None] * right + ndc_y[..., None] * up + fwd.expand(H, W, 3))
    got = generate_rays(cam, H, W)
    assert torch.equal(got.d, d)
    assert torch.equal(got.o, cam.position.expand(H, W, 3))


def test_jitter_shifts_rays(cams):
    """tests/unit/test_camera.py's check: a jitter of 0.75 moves the rays."""
    _, cam = cams
    r0 = generate_rays(cam, 8, 8)
    r1 = generate_rays(cam, 8, 8, jitter=torch.full((8, 8, 2), 0.75))
    assert not np.allclose(r0.d.numpy(), r1.d.numpy())
    r2 = generate_rays(cam, 8, 8, jitter=torch.full((8, 8, 2), 0.5))
    assert torch.equal(r2.d, r0.d)
