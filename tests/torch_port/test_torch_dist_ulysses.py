"""tracer_torch.dist.ulysses against tracer.dist.ulysses on the CPU.

Single process: the Morton key of a point set and the dead rays' key,
exactly. Four gloo ranks (one world, dist_workers.ulysses_world): the
exchange of seeded rows with unique 30-bit keys gives each rank exactly the
rows the reference's shard_map gives its device (the first 4 of the 8
virtual devices), and restore(reshard(x)) maps per-row results back to the
caller's rows (the identity); each rank's key spread shrinks; and the
resharded-bounce render (bunny-grad's config, the plain cluster tier, on
the cornell box at 32x32 with 3 bounces) is under the tightest
tests/dist/gates.py:dist_check of the band render, with one exchange each
way a bounce after the first, and under dist_check of the reference's
re-sharded frame on the same mesh shape."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.dist.gates import dist_check
from tracer.api import get_scene as j_get_scene
from tracer.dist import ulysses as julysses
from tracer.dist.ray_dp import make_sharded_accel_render_fn as j_make_sharded_accel_render_fn
from tracer.dist.mesh import DATA_AXIS, make_render_mesh as j_make_render_mesh
from tracer.utils.config import load_config as j_load_config
from tracer_torch.dist import ulysses
from tracer_torch.dist.mesh import spawn_world
from tracer_torch.utils.config import load_config

import dist_workers
from parity_util import leaves

N = 4
ROWS = N * 16 * N
BOUNCES = 3
CFG = load_config("bunny-grad", height=32, width=32, max_bounces=BOUNCES)
J_CFG = j_load_config("bunny-grad", height=32, width=32, max_bounces=BOUNCES)


def _inputs():
    rng = np.random.default_rng(0)
    key = rng.choice(1 << 30, ROWS, replace=False).astype(np.int64)
    a = rng.normal(size=ROWS).astype(np.float32)
    b = rng.integers(0, 1000, ROWS).astype(np.int32)
    spread = np.random.default_rng(1).integers(0, 1 << 30, N * 64).astype(np.int64)
    return key, a, b, spread


@pytest.fixture(scope="module")
def cornell():
    scene, camera = j_get_scene(j_load_config("cornell256", height=32, width=32))
    camera = dataclasses.replace(camera, look_at=camera.look_at + jnp.array([0.0123, 0.0, 0.0071]))
    return scene, camera


@pytest.fixture(scope="module")
def world(cornell):
    """(every rank's results of dist_workers.ulysses_world, the reference's
    re-sharded frame): the ranks run while the reference compiles."""
    scene, camera = cornell
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_world, dist_workers.ulysses_world, N, *_inputs(),
                            leaves(scene), leaves(camera), CFG, device="cpu")
        mesh = j_make_render_mesh(jax.devices()[:N], data=N, geom=1)
        want = np.asarray(j_make_sharded_accel_render_fn(scene, J_CFG, mesh,
                                                         reshard_bounces=True)(scene, camera))
        return ranks.result(), want


def test_morton_key_matches():
    rng = np.random.default_rng(2)
    p = rng.uniform(-2.0, 3.0, (500, 3)).astype(np.float32)
    lo, hi = np.float32([-1.5, -2.0, -1.0]), np.float32([2.5, 2.0, 2.0])
    want = np.asarray(julysses._morton_key(jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi)))
    got = ulysses._morton_key(torch.as_tensor(p), torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert ulysses.DEAD_KEY == (1 << 30) - 1


def test_reshard_matches_reference_and_restores(world):
    key, a, b, _ = _inputs()
    mesh = j_make_render_mesh(jax.devices()[:N], data=N, geom=1)

    def body(key, a, b):
        (a2, b2), _ = julysses.reshard_by_key(key, [a, b], DATA_AXIS)
        return a2, b2

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(DATA_AXIS),) * 3,
                               out_specs=(P(DATA_AXIS),) * 2))
    a2, b2 = (np.asarray(x).reshape(N, -1) for x in fn(jnp.asarray(key.astype(np.uint32)),
                                                       jnp.asarray(a), jnp.asarray(b)))
    r = ROWS // N
    for rank, res in enumerate(world[0]):
        np.testing.assert_array_equal(res["a2"], a2[rank])
        np.testing.assert_array_equal(res["b2"], b2[rank])
        np.testing.assert_array_equal(res["ra"], a[rank * r:(rank + 1) * r] * np.float32(2.0))
        np.testing.assert_array_equal(res["rb"], b[rank * r:(rank + 1) * r] + 7)


def test_reshard_improves_locality(world):
    before, after = np.array([res["spread"] for res in world[0]], np.float64).T
    assert after.mean() < 0.5 * before.mean(), (before, after)


def test_resharded_bounce_render_matches_plain(world):
    ranks, _ = world
    for res in ranks:
        np.testing.assert_array_equal(res["resharded"], ranks[0]["resharded"])
        assert res["exchanges"] == 2 * (BOUNCES - 1)
    img_p, img_r = ranks[0]["plain"], ranks[0]["resharded"]
    assert img_r.shape == (CFG.height, CFG.width, 3) and img_p.max() > 0.05
    dist_check(img_r, img_p, frac_tol=1e-3, p98_tol=1e-6, rtol=1e-5, atol=1e-6)


def test_resharded_bounce_render_matches_reference(world):
    """The port's re-sharded frame against the reference's
    make_sharded_accel_render_fn(reshard_bounces=True) on the same mesh
    shape, each over its package's default tracers of the config."""
    ranks, want = world
    got = ranks[0]["resharded"]
    assert got.shape == want.shape and want.max() > 0.05
    dist_check(got, want)
