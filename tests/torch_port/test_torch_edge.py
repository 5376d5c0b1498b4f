"""tracer_torch.diff.edge (the brute-force edge-aware tier) against the JAX
package's on the CPU, on tests/grad/test_edge.py's translating-occluder
scene (an occluder outside the frustum casts a shadow into view) seen from
its CAM at 32x32. CAM looks straight down at the middle of the quads, so
pixel centres fall exactly on their diagonals, where the directions' last
bit (XLA's CPU rsqrt is not 1/sqrt) decides a hit: the comparisons of
gradients look at a point 0.0123 and 0.0071 off the middle (CAM_OFF), and
_pair_margins is fed the reference's own rays.

The reference's pair tests run eagerly (jitted, XLA contracts products into
FMAs and flips hit tests on shared edges); its renders from CAM_OFF run
jitted (there they agree with the eager ones to 1e-6). Tolerances: t_plane and margins rtol 1e-5
+ atol 5e-5 (FMA contraction); hit masks exact; images rtol 1e-5 + atol
1e-6; gradients rtol 2e-3 of their largest entry, each nonzero."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.grad.test_edge import CAM, CFG, occluder_scene
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.diff import edge as jedge
from tracer_torch.bridge import camera_from_arrays, scene_from_arrays
from tracer_torch.core.camera import generate_rays
from tracer_torch.core.types import Ray
from tracer_torch.diff import edge
from tracer_torch.render.whitted import WhittedConfig, make_brute_tracers, render_wavefront

from parity_util import leaves

H = W = 32
WCFG = WhittedConfig(max_bounces=CFG.max_bounces, smooth_shading=CFG.smooth_shading)
TUV = dict(rtol=1e-5, atol=5e-5)
CAM_OFF = dataclasses.replace(CAM, look_at=CAM.look_at + jnp.array([0.0123, 0.0, 0.0071]))


@pytest.fixture(scope="module")
def occ():
    j_scene = occluder_scene(0.0)
    return dict(j_scene=j_scene, scene=scene_from_arrays(leaves(j_scene), "cpu"),
                camera=camera_from_arrays(leaves(CAM), "cpu"),
                camera_off=camera_from_arrays(leaves(CAM_OFF), "cpu"))


def gate_grads(got: dict, want: dict):
    """Each gradient nonzero in both packages, rtol 2e-3 of the largest."""
    for key, b in want.items():
        a = got[key]
        assert np.abs(b).max() > 0, f"{key}: reference gradient is zero"
        assert np.abs(a).max() > 0, f"{key}: port gradient is zero"
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * np.abs(b).max(), err_msg=key)


def j_render_grads(j_scene, render, keys=("verts", "albedo", "cam_pos")):
    """The reference's image through render(scene, rays) from CAM_OFF, and
    the gradients of its mean w.r.t. the scene's vertices, its albedo table
    and the camera position, in one jitted call."""
    def image(verts, albedo, cam_pos):
        s = dataclasses.replace(j_scene, verts=verts, materials=dataclasses.replace(
            j_scene.materials, albedo=albedo))
        cam = dataclasses.replace(CAM_OFF, position=cam_pos)
        return render(s, j_generate_rays(cam, H, W))

    def both(*args):
        return image(*args), jax.grad(lambda *a: jnp.mean(image(*a)), argnums=(0, 1, 2))(*args)

    args = (j_scene.verts, jnp.asarray(j_scene.materials.albedo), CAM_OFF.position)
    img, grads = jax.jit(both)(*args)
    return np.asarray(img), {k: np.asarray(g) for k, g in zip(keys, grads)}


def t_render_grads(scene, camera, render, keys=("verts", "albedo", "cam_pos")):
    """The port's counterpart of j_render_grads -> (image, gradients)."""
    p = [x.detach().clone().requires_grad_(True)
         for x in (scene.verts, scene.materials.albedo, camera.position)]
    s = dataclasses.replace(scene, verts=p[0],
                            materials=dataclasses.replace(scene.materials, albedo=p[1]))
    img = render(s, generate_rays(dataclasses.replace(camera, position=p[2]), H, W))
    grads = torch.autograd.grad(img.mean(), p)
    return img.detach().numpy(), {k: g.numpy() for k, g in zip(keys, grads)}


def gate_render(got, want, hard):
    """The image to rtol 1e-5 + atol 1e-6 of the reference's and of the
    port's hard render (the straight-through value), the loss (the image
    mean) to rtol 1e-5, each gradient by gate_grads."""
    (img, grads), (j_img, j_grads) = got, want
    np.testing.assert_allclose(img, j_img, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img, hard, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img.mean(dtype=np.float64), j_img.mean(dtype=np.float64),
                               rtol=1e-5)
    lit = float(np.mean(hard[..., 0] > 0.05))
    assert 0.1 < lit < 0.97, "the occluder's shadow must be in view"
    gate_grads(grads, j_grads)


def test_edge_heights_and_pair_margins(occ):
    """edge_heights and _pair_margins' (hit, margin, t_plane) on the
    camera's rays against every triangle."""
    j_scene, scene = occ["j_scene"], occ["scene"]
    np.testing.assert_allclose(edge.edge_heights(scene.verts, scene.tris).numpy(),
                               np.asarray(jedge.edge_heights(j_scene.verts, j_scene.tris)),
                               rtol=1e-6)
    j_rays = j_generate_rays(CAM, H, W)
    want = jedge._pair_margins(j_rays, j_scene.verts, j_scene.tris, 1e-4, 1e30)
    rays = Ray(o=torch.as_tensor(np.array(j_rays.o)), d=torch.as_tensor(np.array(j_rays.d)))
    got = edge._pair_margins(rays, scene.verts, scene.tris, 1e-4, 1e30)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].any()
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TUV)


def test_soft_any_hit_and_coverage(occ):
    """soft_any_hit (per-ray t_max) and soft_coverage: the hard values, and
    the gradients of their sums w.r.t. the vertices, against the
    reference's, on rays from the receiver toward the light."""
    j_scene, scene = occ["j_scene"], occ["scene"]
    rng = np.random.default_rng(1)
    o = np.concatenate([rng.uniform(-1.2, 1.2, (256, 1)), np.full((256, 1), 1e-3),
                        rng.uniform(-1.2, 1.2, (256, 1))], 1).astype(np.float32)
    to_l = np.array([2.4, 1.2, 0.0], np.float32) - o
    dist = np.linalg.norm(to_l, axis=-1)
    d = to_l / dist[:, None]

    def j_parts(verts):
        r = jedge.Ray(o=jnp.asarray(o), d=jnp.asarray(d))
        return (jedge.soft_any_hit(r, verts, j_scene.tris, jnp.asarray(dist), 0.01),
                jedge.soft_coverage(r, verts, j_scene.tris, 0.01))

    verts = scene.verts.detach().clone().requires_grad_(True)
    r = Ray(o=torch.as_tensor(o), d=torch.as_tensor(d))
    got = (edge.soft_any_hit(r, verts, scene.tris, torch.as_tensor(dist), 0.01),
           edge.soft_coverage(r, verts, scene.tris, 0.01))
    want = j_parts(j_scene.verts)
    for i, name in enumerate(("any_hit", "coverage")):
        np.testing.assert_array_equal(got[i].detach().numpy(), np.asarray(want[i]), err_msg=name)
        (g,) = torch.autograd.grad(got[i].sum(), verts, retain_graph=True)
        jg = np.asarray(jax.grad(lambda v: j_parts(v)[i].sum())(j_scene.verts))
        gate_grads({name: g.numpy()}, {name: jg})
    assert 0 < float(got[0].detach().sum()) < 256


def test_render_diff_matches_reference(occ):
    """render_diff from CAM_OFF: its image equals the reference's and the
    port's hard brute-force render; the gradients of its mean w.r.t. the
    vertices, the albedo table and the camera position match the
    reference's."""
    scene = occ["scene"]
    render = lambda s, r: edge.render_diff(s, r, WCFG)  # noqa: E731
    with torch.no_grad():
        hard = render_wavefront(scene, generate_rays(occ["camera_off"], H, W), WCFG,
                                *make_brute_tracers(scene)).numpy()
    gate_render(t_render_grads(scene, occ["camera_off"], render),
                j_render_grads(occ["j_scene"], lambda s, r: jedge.render_diff(s, r, CFG)), hard)


def _occluder_loss(scene, camera, dx, render, size: int = 64):
    """The image mean at size x size with the occluder moved by dx along x
    (the reference's finite-difference tests run at 64x64)."""
    verts = scene.verts + torch.zeros_like(scene.verts).index_fill(0, torch.arange(4, 8), 1.0) \
        * torch.stack([dx, torch.zeros(()), torch.zeros(())])
    s = dataclasses.replace(scene, verts=verts)
    return render(s, generate_rays(camera, size, size)).mean()


def test_naive_zero_edge_aware_not(occ):
    """The occluder's x offset moves the image only through the shadow
    test: plain autograd through the brute-force render gives exactly 0,
    render_diff a gradient of the finite difference's sign and within 50 %
    of it (tests/grad/test_edge.py's gates, at its 64x64)."""
    scene, camera = occ["scene"], occ["camera"]
    hard = lambda s, r: render_wavefront(s, r, WCFG, *make_brute_tracers(s))  # noqa: E731
    grads = {}
    for name, render in (("naive", hard), ("edge", lambda s, r: edge.render_diff(s, r, WCFG))):
        dx = torch.zeros((), requires_grad=True)
        (grads[name],) = torch.autograd.grad(_occluder_loss(scene, camera, dx, render), dx)
    assert float(grads["naive"]) == 0.0
    h = 0.04
    with torch.no_grad():
        fd = (float(_occluder_loss(scene, camera, torch.tensor(h), hard))
              - float(_occluder_loss(scene, camera, torch.tensor(-h), hard))) / (2 * h)
    g = float(grads["edge"])
    assert abs(fd) > 1e-5 and np.sign(g) == np.sign(fd)
    assert abs(g - fd) <= 0.5 * abs(fd), f"edge grad {g} vs FD {fd}"
