"""tracer_torch accel build and cull vs the JAX package (CPU).

Discrete structures are held exact: Morton codes and order, tri_ids, the
cluster and supercluster AABBs, and the cull's candidate words and counts
(against the reference's bf16_fetch=False mode, whose fp32 AABB fetch is
the port's index gather). The affine maps and shade rows are float
arithmetic over 3-term sums: allclose at rtol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh import cluster as jcluster, cull as jcull, morton as jmorton
from tracer.core import intersect as jintersect
from tracer.core.camera import Camera as JCamera
from tracer.core.types import T_FAR
from tracer.kernels.traversal import generate_rays_tiled as j_generate_rays_tiled
from tracer.scene.procedural import bunny_scene as j_bunny
from tracer_torch.bvh import cluster as tcluster, cull as tcull, morton as tmorton
from tracer_torch.bridge import accel_from_arrays
from tracer_torch.core import intersect as tintersect
from tracer_torch.scene.procedural import bunny_scene as t_bunny

from parity_util import leaves


@pytest.fixture(scope="module")
def bunny():
    j_scene, cam = j_bunny(3)
    t_scene, _ = t_bunny(3, device="cpu")
    return j_scene, t_scene, cam


def test_morton_exact():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 1024, size=(4096, 3)).astype(np.uint32)
    want = np.asarray(jmorton.morton3d(jnp.asarray(q)))
    got = tmorton.morton3d(torch.from_numpy(q.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    p = rng.uniform(-2, 3, size=(4096, 3)).astype(np.float32)
    lo, hi = p.min(0), p.max(0)
    np.testing.assert_array_equal(
        tmorton.quantize_positions(*map(torch.from_numpy, (p, lo, hi))).numpy(),
        np.asarray(jmorton.quantize_positions(*map(jnp.asarray, (p, lo, hi)))).astype(np.int64))


def test_intersect_exact():
    """Affine maps and classic Moller-Trumbore on seeded rays/triangles,
    including degenerate triangles (zero maps, never a hit)."""
    rng = np.random.default_rng(3)
    verts = rng.standard_normal((300, 3)).astype(np.float32)
    tris = rng.integers(0, 300, size=(200, 3)).astype(np.int32)
    tris[:5, 1] = tris[:5, 0]  # degenerate
    want = np.asarray(jintersect.triangle_affine_maps(jnp.asarray(verts), jnp.asarray(tris)))
    got = tintersect.triangle_affine_maps(torch.from_numpy(verts), torch.from_numpy(tris))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:5, 1:] == 0).all()
    o = rng.standard_normal((200, 3)).astype(np.float32) * 3
    d = rng.standard_normal((200, 3)).astype(np.float32)
    v0, v1, v2 = (verts[tris[:, k]] for k in range(3))
    ref = jintersect.moller_trumbore(*map(jnp.asarray, (o, d, v0, v1, v2)))
    out = tintersect.moller_trumbore(*map(torch.from_numpy, (o, d, v0, v1, v2)))
    for r, g in zip(ref, out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 0 < out[3].sum() < 200


@pytest.mark.parametrize("cluster_size", [32, 128])
def test_build_clusters(bunny, cluster_size):
    j_scene, t_scene, _ = bunny
    want = leaves(jcluster.build_clusters(j_scene.verts, j_scene.tris, cluster_size,
                                          scene=j_scene))
    got = tcluster.build_clusters(t_scene.verts, t_scene.tris, cluster_size, scene=t_scene)
    for name in ("tri_ids", "cluster_lo", "cluster_hi", "super_lo", "super_hi"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    for name in ("tri_w", "shade"):
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name], rtol=1e-6,
                                   atol=0, err_msg=name)
    assert got.num_clusters == want["tri_w"].shape[0]
    assert got.cluster_size == cluster_size


def test_pack_candidates_negative_zero():
    """t_lo = -0.0 packs as +0.0 (the reference's max(t, 0.0)): the word
    stays non-negative, where torch's maximum would keep the sign bit."""
    t = np.array([-0.0, 0.0, -1.0, 0.5, 3e3], np.float32)
    cl = np.arange(5, dtype=np.int32)
    ok = np.array([True, True, True, True, False])
    want = np.asarray(jcull.pack_candidates(jnp.asarray(t), jnp.asarray(cl), jnp.asarray(ok)))
    got = tcull.pack_candidates(torch.from_numpy(t), torch.from_numpy(cl),
                                torch.from_numpy(ok)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()


def _rays(cam, h=64, w=64):
    o, d, _ = j_generate_rays_tiled(JCamera.make(**cam), h, w, 64)
    return np.asarray(o), np.asarray(d)


def _passes(cam):
    """Primary rays (scalar t_max) and light-origin segments to the primary
    rays' points at t = 2 (per-ray t_max)."""
    o, d = _rays(cam)
    light = np.array([1.8, 2.6, 1.4], np.float32)
    p = o + 2.0 * d
    so = np.broadcast_to(light, p.shape).copy()
    sd = p - light
    tm = (1.0 - 1e-4 / np.sqrt((sd * sd).sum(-1))).astype(np.float32)
    return [(o, d, T_FAR), (so, sd, tm)]


@pytest.mark.parametrize("cluster_size", [32, 128])
def test_cull_sorted2_exact(bunny, cluster_size):
    """The port's exact-width two-stage cull == the reference's dense cull
    and its two-stage cull (bf16_fetch=False, caps wide enough)."""
    j_scene, _, cam = bunny
    j_accel = jcluster.build_clusters(j_scene.verts, j_scene.tris, cluster_size,
                                      scene=j_scene)
    t_accel = accel_from_arrays(leaves(j_accel), "cpu")
    n_cl, n_sc = j_accel.num_clusters, j_accel.super_lo.shape[0]
    for o, d, tmax in _passes(cam):
        t_tmax = tmax if np.ndim(tmax) == 0 else torch.from_numpy(tmax)
        words, counts, excess, need = tcull.cull_clusters_sorted2(
            t_accel, torch.from_numpy(o.copy()), torch.from_numpy(d.copy()), t_tmax)
        words, counts = words.numpy(), counts.numpy()
        k = words.shape[1]
        assert int(excess) == 0
        assert k == max(8, -(-int(counts.max()) // 8) * 8)
        assert need[0] == counts.max()
        j_tmax = tmax if np.ndim(tmax) == 0 else jnp.asarray(tmax)
        for k_cap in sorted({n_cl, min(k, n_cl)}):
            jw, jc, jx, jneed = jcull.cull_clusters_sorted2(
                j_accel, jnp.asarray(o), jnp.asarray(d), j_tmax, k_cap, s_cap=n_sc,
                bf16_fetch=False)
            jw = np.asarray(jw)
            assert int(jx) == 0
            np.testing.assert_array_equal(counts, np.asarray(jc))
            kk = min(k, jw.shape[1])
            np.testing.assert_array_equal(words[:, :kk], jw[:, :kk])
            assert (words[:, kk:] == tcull.WORD_INVALID).all()
            assert (jw[:, kk:] == tcull.WORD_INVALID).all()
            if n_sc > 1 and k_cap < n_cl:  # the reference's two-stage path
                assert need[1] == int(jneed[1])
