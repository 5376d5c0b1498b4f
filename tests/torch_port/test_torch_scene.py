"""tracer_torch scenes, camera and ray tiling vs the JAX package (CPU).

Procedural scenes, Camera.make and the tiling permutations are held
bit-exact. Ray directions pass through `normalize`, whose rsqrt XLA's CPU
backend evaluates with its own approximation (not 1/sqrt): they are held to
2 units in the last place of 1.0, and the rest to exactness (origins, the
tiling permutations, the port's own tiled/untiled identity)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.core.camera import Camera as JCamera, generate_rays as j_generate_rays
from tracer.kernels import traversal as jtrav
from tracer.scene import procedural as jproc
from tracer_torch.core.camera import Camera, generate_rays
from tracer_torch.kernels import traversal as ttrav
from tracer_torch.scene import procedural as tproc

from parity_util import assert_unit_close, leaves

SCENES = {
    "cornell": lambda m, **kw: m.cornell_box(**kw),
    "bunny3": lambda m, **kw: m.bunny_scene(3, **kw),
    "hall": lambda m, **kw: m.columned_hall(cols_x=4, cols_z=3, blob_subdiv=3, **kw),
    "bench": lambda m, **kw: m.bench_scene(**kw),
    "soup400": lambda m, **kw: (m.random_tri_soup(400, **kw), None),
}


def _assert_leaves_equal(want: dict, got, path=""):
    for name, w in want.items():
        g = getattr(got, name)
        if isinstance(w, dict):
            _assert_leaves_equal(w, g, f"{path}{name}.")
            continue
        g = g.cpu().numpy()
        assert g.dtype == w.dtype, f"{path}{name}: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{path}{name}")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_procedural_scene_exact(name):
    j_scene, j_cam = SCENES[name](jproc)
    t_scene, t_cam = SCENES[name](tproc, device="cpu")
    _assert_leaves_equal(leaves(j_scene), t_scene)
    assert t_scene.num_tris == j_scene.num_tris
    assert t_scene.lights.count == j_scene.lights.count
    assert t_cam == j_cam


CAMS = [dict(position=(0.0, 1.1, 2.6), look_at=(0.0, 0.65, 0.0), fov_y_deg=42.0),
        dict(position=(0.0, 2.6, 5.5), look_at=(0.0, 0.6, 0.0), fov_y_deg=50.0)]


@pytest.mark.parametrize("cam", CAMS)
def test_camera_and_rays(cam):
    jc = JCamera.make(**cam)
    tc = Camera.make(**cam, device="cpu")
    _assert_leaves_equal(leaves(jc), tc)
    for a, b in zip(jc.basis(), tc.basis()):
        assert_unit_close(a, b.numpy())
    for h, w in ((64, 64), (40, 48)):
        jr = j_generate_rays(jc, h, w)
        tr = generate_rays(tc, h, w)
        np.testing.assert_array_equal(tr.o.numpy(), np.asarray(jr.o))
        assert_unit_close(jr.d, tr.d.numpy())


@pytest.mark.parametrize("hw", [(64, 64), (40, 48), (30, 50)])
def test_generate_rays_tiled(hw):
    """Tiled primary rays: the port's index-math fold equals its own
    generate_rays + tile_rays bit for bit, and agrees with the JAX tiling."""
    h, w = hw
    cam = CAMS[0]
    tc = Camera.make(**cam, device="cpu")
    o_t, d_t, tiling = ttrav.generate_rays_tiled(tc, h, w, 64)
    rays = generate_rays(tc, h, w)
    o_ref, d_ref, tiling_ref = ttrav.tile_rays(rays.o, rays.d, 64)
    assert tiling == tiling_ref
    np.testing.assert_array_equal(o_t.numpy(), o_ref.numpy())
    np.testing.assert_array_equal(d_t.numpy(), d_ref.numpy())
    jo, jd, jtiling = jtrav.generate_rays_tiled(JCamera.make(**cam), h, w, 64)
    assert tuple(jtiling) == tuple(tiling)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(jo))
    assert_unit_close(jd, d_t.numpy())
    np.testing.assert_array_equal(ttrav.untile(d_t, tiling).numpy(), rays.d.numpy())


@pytest.mark.parametrize("shape,tr", [((64, 64), 64), ((30, 50), 64), ((16, 32), 256),
                                      ((100,), 64)])
def test_tile_untile_exact(shape, tr):
    rng = np.random.default_rng(5)
    o = rng.standard_normal(shape + (3,)).astype(np.float32)
    d = rng.standard_normal(shape + (3,)).astype(np.float32)
    jo, jd, jt = jtrav.tile_rays(jnp.asarray(o), jnp.asarray(d), tr)
    to, td, tt = ttrav.tile_rays(torch.from_numpy(o), torch.from_numpy(d), tr)
    assert tuple(jt) == tuple(tt)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    x = rng.standard_normal(tuple(to.shape[:2]) + (5,)).astype(np.float32)
    np.testing.assert_array_equal(ttrav.untile(torch.from_numpy(x), tt).numpy(),
                                  np.asarray(jtrav.untile(jnp.asarray(x), jt)))
    np.testing.assert_array_equal(ttrav.untile(to, tt).numpy(), o)


def test_bridge_round_trip():
    """scene_from_arrays / camera_from_arrays on the JAX objects' leaves
    give the port's own scene and camera."""
    from tracer_torch.bridge import camera_from_arrays, scene_from_arrays

    j_scene, cam = jproc.bunny_scene(3)
    t_scene, _ = tproc.bunny_scene(3, device="cpu")
    bridged = scene_from_arrays(leaves(j_scene), "cpu")
    _assert_leaves_equal(leaves(j_scene), bridged)
    for name in ("verts", "tris", "mat_id", "normals"):
        assert torch.equal(getattr(bridged, name), getattr(t_scene, name))
    j_cam = JCamera.make(**cam)
    t_cam = camera_from_arrays(leaves(j_cam), "cpu")
    own = Camera.make(**cam, device="cpu")
    for name in ("position", "look_at", "up", "fov_y"):
        assert torch.equal(getattr(t_cam, name), getattr(own, name))
