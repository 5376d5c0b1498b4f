"""tracer_torch.dist.grad_overlap against tracer.dist.grad_overlap on the
CPU, in one world of 4 gloo ranks (dist_workers.grad_overlap_world), the
reference on the first 4 of the 8 virtual devices, on the cornell box at
32x32 (1 bounce, the camera 0.0123 and 0.0071 off its point) against a
seeded target: the bucketed step (4 buckets), the unbucketed one, and the
bucketed one (2 buckets) over api.build_tracers of bunny-grad's config (the
plain cluster tier). Each is held to the reference's: loss to rtol 1e-5,
the vertex gradient to rtol 2e-3 + atol 2e-6 of its largest entry (the
grad gate), the same on every rank. Bucketed equals unbucketed (loss to
rtol 1e-6, gradient to rel-L2 1e-5, as tests/dist/test_grad_overlap.py
holds the reference), and neither is the data size times the other (the
double reduction the reference's comment records)."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.api import build_tracers as j_build_tracers, get_scene as j_get_scene
from tracer.dist import grad_overlap as jgo
from tracer.dist.mesh import make_render_mesh as j_make_render_mesh
from tracer.utils.config import load_config as j_load_config
from tracer_torch.dist.mesh import spawn_world
from tracer_torch.utils.config import load_config

import dist_workers
from parity_util import leaves

N = 4
FIELDS = dict(height=32, width=32, max_bounces=1)
J_CFG, CFG = j_load_config("cornell256", **FIELDS), load_config("cornell256", **FIELDS)
J_ACCEL, ACCEL = j_load_config("bunny-grad", **FIELDS), load_config("bunny-grad", **FIELDS)


@pytest.fixture(scope="module")
def inputs():
    scene, camera = j_get_scene(J_CFG)
    camera = dataclasses.replace(camera, look_at=camera.look_at + jnp.array([0.0123, 0.0, 0.0071]))
    target = np.random.default_rng(0).uniform(0.0, 0.5, (CFG.height, CFG.width, 3))
    return scene, camera, target.astype(np.float32)


NAMES = ("bucketed", "unbucketed", "accel")


def _reference(name, inputs):
    """The reference's grad step of the case on the first N virtual devices
    -> (loss, vertex gradient)."""
    scene, camera, target = inputs
    mesh = j_make_render_mesh(jax.devices()[:N], data=N, geom=1)
    if name == "bucketed":
        fn = jgo.make_overlapped_grad_fn(J_CFG, mesh, n_buckets=4)
    elif name == "unbucketed":
        fn = jgo.make_unbucketed_grad_fn(J_CFG, mesh)
    else:
        fn = jgo.make_overlapped_grad_fn(J_ACCEL, mesh, n_buckets=2,
                                         tracer_builder=partial(j_build_tracers, cfg=J_ACCEL))
    loss, grads = fn(scene, camera, jnp.asarray(target))
    return float(loss), np.asarray(grads)


@pytest.fixture(scope="module")
def both(inputs):
    """(every rank's results of dist_workers.grad_overlap_world, {case: the
    reference's (loss, gradient)}). The ranks run while the reference
    computes its cases."""
    scene, camera, target = inputs
    with ThreadPoolExecutor(1) as ranks, ThreadPoolExecutor(len(NAMES)) as refs:
        got = ranks.submit(spawn_world, dist_workers.grad_overlap_world, N, leaves(scene),
                           leaves(camera), target, CFG, ACCEL, device="cpu")
        want = dict(zip(NAMES, refs.map(partial(_reference, inputs=inputs), NAMES)))
        return got.result(), want


@pytest.fixture(scope="module")
def world(both):
    return both[0]


def _result(world, name):
    loss, grads = world[0][name]
    for res in world[1:]:
        assert res[name][0] == loss
        np.testing.assert_array_equal(res[name][1], grads)
    return loss, grads


@pytest.mark.parametrize("name", NAMES)
def test_grad_step_matches_reference(name, world, both):
    loss, want = both[1][name]
    got_loss, got = _result(world, name)
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-6 * np.abs(want).max())


def test_bucketed_matches_unbucketed(world):
    lb, gb = _result(world, "bucketed")
    lu, gu = _result(world, "unbucketed")
    np.testing.assert_allclose(lb, lu, rtol=1e-6)
    rel = np.linalg.norm(gb - gu) / np.linalg.norm(gu)
    assert rel < 1e-5, rel
    assert np.linalg.norm(gb - N * gu) > 0.5 * N * np.linalg.norm(gu)
