"""tracer_torch's packed intersection and replayed nearest hit against the
JAX package on the CPU: core.intersect.intersect_packed and
nearest_hit(tri_ids), and diff.vjp.intersect_nearest (forward, and the
gradients of its replay backward against the reference's custom VJP and
against the port's own dense autograd), on the cornell box's 8x8 primary
rays, as tests/grad/test_custom_vjp.py.

The reference runs eagerly, not under jax.jit: jitted, XLA contracts the
products into FMAs and flips 4 of the 2,176 (ray, triangle) hit tests on
the box's shared edges (u = -1.2e-8 where the port and the eager reference
compute 0). Tolerances: t, u, v rtol 1e-5 + atol 5e-5; hit masks and
triangle ids exact; gradients
rtol 2e-3 of their largest entry against the reference, rtol 2e-4 + atol
1e-5 against the port's dense path (the reference's own gate between its
replay and dense paths)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.api import get_scene as j_get_scene
from tracer.core import intersect as jci
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.core.types import T_FAR
from tracer.diff.vjp import intersect_nearest as j_intersect_nearest
from tracer.utils.config import load_config as j_load_config
from tracer_torch.bridge import scene_from_arrays
from tracer_torch.core import intersect as ci
from tracer_torch.core.types import Ray
from tracer_torch.diff.vjp import IntersectNearest, intersect_nearest, make_replay_tracers
from tracer_torch.render.whitted import make_brute_tracers

from parity_util import leaves

TUV = dict(rtol=1e-5, atol=5e-5)


@pytest.fixture(scope="module")
def box():
    """The cornell box (34 triangles) and its 8x8 primary rays, (64, 3), in
    both packages; every ray that misses the box is turned away from it."""
    j_scene, j_cam = j_get_scene(j_load_config("cornell256", height=8, width=8))
    rays = j_generate_rays(j_cam, 8, 8)
    o = np.array(rays.o).reshape(-1, 3)
    d = np.array(rays.d).reshape(-1, 3)
    d[:4] = -d[:4]  # a few rays leave the box through the open front: misses
    return dict(j_scene=j_scene, scene=scene_from_arrays(leaves(j_scene), "cpu"), o=o, d=d)


def _j_loss(fn):
    """The scalar loss of tests/grad/test_custom_vjp.py over fn's (t, uv)."""
    def loss(verts, o, d, tris):
        t, uv = fn(o, d, verts, tris)
        m = (t < T_FAR).astype(jnp.float32)
        return jnp.sum(m * jnp.minimum(t, 1e3)) + jnp.sum(uv ** 2)
    return loss


def _t_loss(t, uv):
    m = (t < T_FAR).float()
    return (m * torch.clamp_max(t, 1e3)).sum() + (uv ** 2).sum()


def _homog(o, d):
    ones = np.ones((o.shape[0], 1), np.float32)
    return np.concatenate([o, ones], -1), np.concatenate([d, 0 * ones], -1)


def test_intersect_packed_matches_reference(box):
    """(t, u, v, hit) of every ray against every triangle, scalar t_max and
    a per-ray (R, 1) t_max."""
    o4, d4 = _homog(box["o"], box["d"])
    maps_j = jci.triangle_affine_maps(box["j_scene"].verts, box["j_scene"].tris)
    maps = ci.triangle_affine_maps(box["scene"].verts, box["scene"].tris)
    t_max = np.linspace(0.5, 6.0, o4.shape[0], dtype=np.float32)[:, None]
    for tm_j, tm in ((T_FAR, T_FAR), (jnp.asarray(t_max), torch.as_tensor(t_max))):
        want = jci.intersect_packed(o4, d4, maps_j, 1e-4, tm_j)
        got = ci.intersect_packed(torch.as_tensor(o4), torch.as_tensor(d4), maps, 1e-4, tm)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert got[3].any() and not got[3].all()
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TUV)


def test_nearest_hit_tri_ids(box):
    """nearest_hit with and without a column -> triangle id map: the ids are
    those of the reference, -1 on a miss."""
    o4, d4 = _homog(box["o"], box["d"])
    maps = ci.triangle_affine_maps(box["scene"].verts, box["scene"].tris)
    t, u, v, _ = ci.intersect_packed(torch.as_tensor(o4), torch.as_tensor(d4), maps)
    ids = np.random.default_rng(0).permutation(t.shape[1]).astype(np.int32) + 100
    for tri_ids in (None, ids):
        want = jci.nearest_hit(jnp.asarray(t.numpy()), jnp.asarray(u.numpy()),
                               jnp.asarray(v.numpy()),
                               None if tri_ids is None else jnp.asarray(tri_ids))
        got = ci.nearest_hit(t, u, v, None if tri_ids is None else torch.as_tensor(tri_ids))
        assert got.tri.dtype == torch.int32
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
        np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
        assert (got.tri == -1).sum() == 4


def test_intersect_nearest_forward(box):
    """t, tri, uv against the reference's intersect_nearest."""
    s = box["scene"]
    t, tri, uv = intersect_nearest(torch.as_tensor(box["o"]), torch.as_tensor(box["d"]),
                                   s.verts, s.tris)
    jt, jtri, juv = j_intersect_nearest(box["o"], box["d"], box["j_scene"].verts,
                                                 box["j_scene"].tris)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **TUV)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), **TUV)


def _port_grads(box, fn):
    """Gradients of the test loss w.r.t. (verts, o, d) through fn(o, d,
    verts, tris) -> (t, uv)."""
    s = box["scene"]
    xs = [x.detach().clone().requires_grad_(True)
          for x in (s.verts, torch.as_tensor(box["o"]), torch.as_tensor(box["d"]))]
    t, uv = fn(xs[1], xs[2], xs[0], s.tris)
    return [g.numpy() for g in torch.autograd.grad(_t_loss(t, uv), xs)]


def _replay(o, d, verts, tris):
    t, _tri, uv = intersect_nearest(o, d, verts, tris)
    return t, uv


def _dense(o, d, verts, tris):
    hit = ci.intersect_brute(Ray(o=o, d=d), verts, tris)
    return hit.t, hit.uv


@pytest.mark.parametrize("name, argnum", [("verts", 0), ("o", 1), ("d", 2)])
def test_replay_grads_match_reference(box, name, argnum):
    """The replay backward against the reference's custom VJP (jax.grad of
    the same loss), each gradient nonzero."""
    loss = _j_loss(lambda o, d, v, t: j_intersect_nearest(o, d, v, t)[::2])
    want = np.asarray(jax.grad(loss, argnum)(box["j_scene"].verts, box["o"], box["d"],
                                                      box["j_scene"].tris))
    got = _port_grads(box, _replay)[argnum]
    assert np.abs(want).max() > 0 and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * np.abs(want).max(),
                               err_msg=name)


def test_replay_grads_match_dense(box):
    """The replay backward against autograd straight through the port's
    dense intersect_brute (tests/grad/test_custom_vjp.py's gate); the rays
    that miss get exactly zero gradient."""
    replay, dense = _port_grads(box, _replay), _port_grads(box, _dense)
    for name, a, b in zip(("verts", "o", "d"), replay, dense):
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5, err_msg=name)
    assert not replay[1][:4].any() and not replay[2][:4].any()


def test_replay_backward_scatters(box, monkeypatch):
    """The backward replays one triangle a ray and adds the vertex
    gradients by index_add_ (three calls, one a corner, over the rays that
    hit only); the graph holds no gather of the vertex table."""
    s = box["scene"]
    verts = s.verts.detach().clone().requires_grad_(True)
    t, tri, uv = intersect_nearest(torch.as_tensor(box["o"]), torch.as_tensor(box["d"]),
                                   verts, s.tris)
    assert type(t.grad_fn).__name__ == IntersectNearest.__name__ + "Backward"
    assert not tri.requires_grad
    calls = []
    real = torch.Tensor.index_add_

    def spy(self, dim, index, source, **kw):
        calls.append(int(index.numel()))
        return real(self, dim, index, source, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    _t_loss(t, uv).backward()
    assert calls == [int((tri >= 0).sum())] * 3


def test_replay_tracers_render(box):
    """render_wavefront over make_replay_tracers: the brute-force tracers'
    image, and the same vertex gradients as the dense path."""
    from tracer_torch.api import get_scene
    from tracer_torch.core.camera import generate_rays
    from tracer_torch.render.whitted import WhittedConfig, render_wavefront
    from tracer_torch.utils.config import load_config

    scene, cam = get_scene(load_config("cornell256"), "cpu")
    rays = generate_rays(cam, 16, 16)
    wcfg = WhittedConfig(max_bounces=1, smooth_shading=False)
    out = []
    for tracers in (make_replay_tracers, make_brute_tracers):
        verts = scene.verts.detach().clone().requires_grad_(True)
        s = dataclasses.replace(scene, verts=verts)
        img = render_wavefront(s, rays, wcfg, *tracers(s))
        (g,) = torch.autograd.grad(img.mean(), verts)
        out.append((img.detach().numpy(), g.numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert np.abs(out[1][1]).max() > 0
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=2e-4,
                               atol=1e-5 * np.abs(out[1][1]).max())
