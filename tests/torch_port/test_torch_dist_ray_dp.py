"""tracer_torch.dist.ray_dp against tracer.dist.ray_dp on the CPU, in one
world of 4 gloo ranks (dist_workers.ray_dp_world), the reference on the
first 4 of the 8 virtual devices, the same scene and camera arrays (the
camera 0.0123 and 0.0071 off its point, so that no pixel centre lies on a
projected edge):

  * make_sharded_render_fn on the cornell box at 32x32 with 2 bounces, and
    at a height of 30 that 4 ranks do not divide (the reference's GSPMD
    path takes it too): under tests/dist/gates.py:dist_check, every rank's
    image equal;
  * shard_rays: each rank's band of the full frame's rays (origins exact,
    directions to 2 ulp of 1.0: XLA's CPU rsqrt);
  * make_sharded_accel_render_fn over bunny-grad's config (the plain
    cluster tier) on the same scene: dist_check;
  * make_sharded_grad_fn against a seeded target: loss to rtol 1e-5, the
    vertex gradient to rtol 2e-3 + atol 2e-6 of its largest entry (the grad
    gate), the same on every rank;
  * dryrun at world 4, which reaches the sharded-geometry branch."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.dist.gates import dist_check
from tracer.api import get_scene as j_get_scene
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.dist import ray_dp as jray_dp
from tracer.dist.mesh import make_render_mesh as j_make_render_mesh
from tracer.utils.config import load_config as j_load_config
from tracer_torch.dist.mesh import spawn_world
from tracer_torch.dist.ray_dp import band_rows
from tracer_torch.utils.config import load_config

import dist_workers
from parity_util import assert_unit_close, leaves

N = 4
FIELDS = dict(height=32, width=32, max_bounces=2)
J_CFG, CFG = j_load_config("cornell256", **FIELDS), load_config("cornell256", **FIELDS)
J_ODD, ODD = J_CFG.replace(height=30), CFG.replace(height=30)
J_ACCEL, ACCEL = j_load_config("bunny-grad", **FIELDS), load_config("bunny-grad", **FIELDS)
OFF = jnp.array([0.0123, 0.0, 0.0071])


@pytest.fixture(scope="module")
def inputs():
    scene, camera = j_get_scene(J_CFG)
    camera = dataclasses.replace(camera, look_at=camera.look_at + OFF)
    cam_off = dataclasses.replace(camera, look_at=camera.look_at + OFF)
    target = np.random.default_rng(0).uniform(0.0, 0.5, (CFG.height, CFG.width, 3))
    return scene, camera, cam_off, target.astype(np.float32)


REFS = ("brute", "odd", "accel", "grad")


def _reference(which, inputs):
    """The reference's sharded render of the case on the first N virtual
    devices, or ("grad") its sharded grad step's (loss, vertex gradient)."""
    scene, camera, cam_off, target = inputs
    mesh = j_make_render_mesh(jax.devices()[:N], data=N, geom=1)
    if which == "grad":
        loss, grads = jray_dp.make_sharded_grad_fn(scene, J_CFG, mesh)(scene, cam_off,
                                                                      jnp.asarray(target))
        return float(loss), np.asarray(grads)
    if which == "accel":
        fn = jray_dp.make_sharded_accel_render_fn(scene, J_ACCEL, mesh)
    else:
        fn = jray_dp.make_sharded_render_fn(scene, J_ODD if which == "odd" else J_CFG, mesh)
    return np.asarray(fn(scene, camera))


@pytest.fixture(scope="module")
def both(inputs):
    """(every rank's results of dist_workers.ray_dp_world, {case: the
    reference's}). The ranks run while the reference computes its cases."""
    scene, camera, cam_off, target = inputs
    with ThreadPoolExecutor(1) as ranks, ThreadPoolExecutor(len(REFS)) as refs:
        got = ranks.submit(spawn_world, dist_workers.ray_dp_world, N, leaves(scene),
                           leaves(camera), leaves(cam_off), target, CFG, ODD, ACCEL,
                           device="cpu")
        want = dict(zip(REFS, refs.map(partial(_reference, inputs=inputs), REFS)))
        return got.result(), want


@pytest.fixture(scope="module")
def world(both):
    return both[0]


@pytest.fixture(scope="module")
def refs(both):
    return both[1]


def _same_on_every_rank(world, key):
    for res in world[1:]:
        np.testing.assert_array_equal(res[key], world[0][key])
    return world[0][key]


@pytest.mark.parametrize("which", ["brute", "odd", "accel"])
def test_sharded_render_matches_reference(which, world, refs):
    want = refs[which]
    got = _same_on_every_rank(world, which)
    assert got.shape == want.shape and want.max() > 0.05
    dist_check(got, want)


def test_shard_rays_gives_each_rank_its_band(world, inputs):
    _, camera, _, _ = inputs
    rays = j_generate_rays(camera, ODD.height, ODD.width)
    for rank, res in enumerate(world):
        y0, rows = band_rows(ODD.height, N, rank)
        assert rows == (8 if rank < 2 else 7)
        o, d = res["band"]
        np.testing.assert_array_equal(o, np.asarray(rays.o)[y0:y0 + rows])
        assert_unit_close(np.asarray(rays.d)[y0:y0 + rows], d)


def test_sharded_grad_matches_reference(world, refs):
    loss, want = refs["grad"]
    got_loss = _same_on_every_rank(world, "loss")
    got = _same_on_every_rank(world, "grads")
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-6 * np.abs(want).max())


def test_dryrun_reaches_the_ring_branch(world):
    for res in world:
        assert [k.get("use_ring") for k in res["dryrun_ring"]] == [True, False, True]
        assert res["dryrun_ring"][2]["use_accel"] is True
