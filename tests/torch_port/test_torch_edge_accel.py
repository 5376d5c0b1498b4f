"""tracer_torch.diff.edge_accel (the edge-aware tier over a tile's nearest
candidate clusters) against the JAX package's on the CPU: _tile_candidates
and _candidate_margins on the subdiv-2 bunny in clusters of 4 (one accel,
built by the reference, fed to both through tracer_torch.bridge), and
render_diff_accel on tests/grad/test_edge.py's occluder scene in clusters
of 4 (two clusters), as tests/grad/test_accel_grads.py, at 32x32.

The reference's candidate tests run eagerly (jitted, XLA contracts products
into FMAs), its render jitted. Tolerances: candidate ids and validity
exact; t_plane and margins rtol 1e-5 + atol 5e-5; images rtol 1e-5 + atol
1e-6; losses rtol 1e-5; gradients rtol 2e-3 of their largest entry, each
nonzero. The renders are compared from test_torch_edge.py's CAM_OFF."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.grad.test_edge import CAM, CFG, occluder_scene
from tracer.bvh.cluster import build_clusters as j_build_clusters
from tracer.core.camera import Camera as JCamera
from tracer.diff import edge_accel as jea
from tracer.kernels.traversal import generate_rays_tiled as j_generate_rays_tiled
from tracer.scene.procedural import bunny_scene
from tracer_torch.bridge import accel_from_arrays, camera_from_arrays, scene_from_arrays
from tracer_torch.bvh.cluster import build_clusters
from tracer_torch.core.camera import generate_rays
from tracer_torch.diff import edge_accel as ea
from tracer_torch.kernels.traversal import make_accel_tracers
from tracer_torch.render.whitted import WhittedConfig, render_wavefront

from parity_util import leaves
from test_torch_edge import CAM_OFF, H, W, _occluder_loss, gate_render, j_render_grads, \
    t_render_grads

WCFG = WhittedConfig(max_bounces=CFG.max_bounces, smooth_shading=CFG.smooth_shading)
TUV = dict(rtol=1e-5, atol=5e-5)


@pytest.fixture(scope="module")
def bunny():
    """The subdiv-2 bunny in clusters of 4 (one accel for both packages) and
    its 32x32 primary rays in 8x8 tiles, with a per-ray t_max."""
    j_scene, cam = bunny_scene(2)
    j_accel = j_build_clusters(j_scene.verts, j_scene.tris, 4, scene=j_scene)
    o, d, _ = j_generate_rays_tiled(JCamera.make(**cam), 32, 32, 64)
    tmax = np.random.default_rng(2).uniform(1.0, 6.0, o.shape[:2]).astype(np.float32)
    return dict(j_accel=j_accel, accel=accel_from_arrays(leaves(j_accel), "cpu"),
                o=np.array(o), d=np.array(d), tmax=tmax)


@pytest.mark.parametrize("k_edge", [2, 12, 80])
@pytest.mark.parametrize("per_ray", [False, True])
def test_tile_candidates(bunny, k_edge, per_ray):
    """The first k_edge sorted candidates of each tile: ids and validity
    exactly the reference's, for a k_edge under the port's cull width, one
    past it on some tiles (padded with invalid words), and one past the
    reference's own cut (64 of 80 clusters)."""
    tm = bunny["tmax"] if per_ray else np.float32(1e30)
    want = jea._tile_candidates(bunny["j_accel"], bunny["o"], bunny["d"], jnp.asarray(tm),
                                k_edge)
    got = ea._tile_candidates(bunny["accel"], torch.as_tensor(bunny["o"]),
                              torch.as_tensor(bunny["d"]), torch.as_tensor(tm), k_edge)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[1].any() and not got[1].all()


def test_candidate_margins(bunny):
    """margin, t_plane and validity against the candidates' triangles."""
    o, d = bunny["o"], bunny["d"]
    ids, valid = jea._tile_candidates(bunny["j_accel"], o, d, jnp.float32(1e30), 3)
    want = jea._candidate_margins(bunny["j_accel"], o, d, ids, valid, 1e-4)
    got = ea._candidate_margins(bunny["accel"], torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(np.array(ids)), torch.as_tensor(np.array(valid)),
                                1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any()
    m = np.asarray(want[2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], **TUV)


@pytest.fixture(scope="module")
def occ():
    j_scene = occluder_scene(0.0)
    return dict(j_scene=j_scene, scene=scene_from_arrays(leaves(j_scene), "cpu"),
                camera=camera_from_arrays(leaves(CAM), "cpu"),
                camera_off=camera_from_arrays(leaves(CAM_OFF), "cpu"))


def _hard(scene, rays):
    """The hard plain-cluster render in clusters of 4."""
    accel = build_clusters(scene.verts, scene.tris, 4, scene=scene)
    return render_wavefront(scene, rays, WCFG, *make_accel_tracers(scene, accel))


def _edge(scene, rays):
    return ea.render_diff_accel(scene, rays, WCFG, edge_eps=0.01, k_edge=2, cluster_size=4)


def test_render_diff_accel_matches_reference(occ):
    """render_diff_accel from CAM_OFF: its image equals the reference's and
    the port's hard render through the plain cluster tracers; the gradients
    of its mean w.r.t. the vertices, the albedo table and the camera
    position match the reference's."""
    with torch.no_grad():
        hard = _hard(occ["scene"], generate_rays(occ["camera_off"], H, W)).numpy()
    want = j_render_grads(occ["j_scene"], lambda s, r: jea.render_diff_accel(
        s, r, CFG, edge_eps=0.01, k_edge=2, cluster_size=4))
    gate_render(t_render_grads(occ["scene"], occ["camera_off"], _edge), want, hard)


def test_naive_zero_edge_aware_not(occ):
    """The occluder's x offset: plain autograd through the cluster tier
    gives exactly 0, render_diff_accel a gradient within 10 % of the
    finite difference (tests/grad/test_accel_grads.py's gate, at its
    64x64)."""
    scene, camera = occ["scene"], occ["camera"]
    grads = {}
    for name, render in (("naive", _hard), ("edge", _edge)):
        dx = torch.zeros((), requires_grad=True)
        (grads[name],) = torch.autograd.grad(_occluder_loss(scene, camera, dx, render), dx)
    assert float(grads["naive"]) == 0.0
    h = 0.04
    with torch.no_grad():
        fd = (float(_occluder_loss(scene, camera, torch.tensor(h), _hard))
              - float(_occluder_loss(scene, camera, torch.tensor(-h), _hard))) / (2 * h)
    g = float(grads["edge"])
    assert abs(fd) > 1e-5 and np.sign(g) == np.sign(fd)
    assert abs(g - fd) <= 0.1 * abs(fd), f"edge-accel grad {g} vs FD {fd}"
