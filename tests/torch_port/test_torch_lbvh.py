"""tracer_torch.bvh.lbvh against the JAX package's tracer.bvh.lbvh and the
port's brute force (the counterpart of tests/unit/test_lbvh.py).

The build is held equal to the reference's build_lbvh, run eagerly, field
for field (the topology, the leaf order and the fitted boxes) at 1, 7 and
257 triangles; its invariants at 1, 2, 7, 64 and 257. The
traversal walks the reference's own tree (tracer_torch.bridge.
flat_bvh_from_arrays) and is held to the reference's trace_rays_lbvh and
any_hit_lbvh: triangle and occlusion exact, t to rtol 1e-6 (XLA contracts
the reference's products into FMAs inside its while loop). Against the
port's brute force (the affine-map formulation, not Moller-Trumbore):
triangle and occlusion exact on these seeded rays, t to rtol 1e-6, uv to
1e-4 as the reference test; the Cornell frame off in under 0.5% of pixels,
the reference test's own gate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh import lbvh as jl
from tracer.core.types import Ray as JRay
from tracer.scene import random_tri_soup
from tracer_torch.api import get_scene
from tracer_torch.bridge import flat_bvh_from_arrays
from tracer_torch.bvh import lbvh
from tracer_torch.core.intersect import any_hit_brute, intersect_brute
from tracer_torch.core.types import Ray
from tracer_torch.render.whitted import WhittedConfig, render_image
from tracer_torch.utils.config import load_config

from parity_util import leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(n, seed):
    s = random_tri_soup(n, seed=seed)
    return s, torch.from_numpy(np.array(s.verts)), torch.from_numpy(np.array(s.tris))


def _rays(n, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (JRay(o=jnp.asarray(o), d=jnp.asarray(d)),
            Ray(o=torch.from_numpy(o), d=torch.from_numpy(d)), rng)


# Sizes whose build is also held to the reference's (each eager reference
# build compiles its ops anew, some 8 s under the test workers' load).
REF_SIZES = (1, 7, 257)


@pytest.mark.parametrize("n_tris", [1, 2, 7, 64, 257])
def test_build_matches_reference_and_invariants(n_tris):
    j_scene, verts, tris = _soup(n_tris, 3)
    bvh = lbvh.build_lbvh(verts, tris)
    if n_tris in REF_SIZES:
        want = leaves(jl.build_lbvh(j_scene.verts, j_scene.tris))
        for k, v in want.items():
            got = getattr(bvh, k).numpy()
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)
    assert bvh.num_leaves == n_tris and bvh.num_internal == max(n_tris - 1, 0)
    np.testing.assert_array_equal(np.sort(bvh.leaf_tri.numpy()), np.arange(n_tris))
    if n_tris < 2:
        return
    ni = bvh.num_internal
    left, right = bvh.left.numpy(), bvh.right.numpy()
    children = np.concatenate([left, right])
    assert children.min() >= 1 and children.max() <= 2 * n_tris - 2
    counts = np.bincount(children, minlength=2 * n_tris - 1)
    assert counts[0] == 0
    np.testing.assert_array_equal(counts[1:], 1)
    lo, hi = bvh.node_lo.numpy(), bvh.node_hi.numpy()
    for c in (left, right):
        assert np.all(lo[:ni] <= lo[c]) and np.all(hi[:ni] >= hi[c])
    assert np.isfinite(lo).all() and np.isfinite(hi).all()


def test_clz_is_exact_on_32_bits():
    """The frexp count of leading zeros at every bit length, 0 and 2^32 - 1
    (where a float32 log2 would round)."""
    x = torch.tensor([0, 1, 2, 3, 2**24 - 1, 2**24 + 1, 2**31 - 1, 2**31, 2**32 - 1])
    want = [32 - int(v).bit_length() for v in x.tolist()]
    assert lbvh._clz32(x).tolist() == want


@pytest.mark.parametrize("n_tris", [1, 5, 60, 300])
def test_closest_hit(n_tris):
    j_scene, verts, tris = _soup(n_tris, 11)
    j_ray, ray, _ = _rays(256, 17)
    stats = {}
    own = lbvh.trace_rays_lbvh(ray, lbvh.build_lbvh(verts, tris), verts, tris, stats=stats)
    assert stats["iterations"] % lbvh.CHECK_EVERY == 0
    assert 0 < stats["needed"] <= stats["iterations"] < stats["needed"] + lbvh.CHECK_EVERY
    if n_tris in (5, 300):
        # The reference's own tree and traversal (its while loop compiles
        # anew for each scene: two sizes).
        j_bvh = jl.build_lbvh(j_scene.verts, j_scene.tris)
        got = lbvh.trace_rays_lbvh(ray, flat_bvh_from_arrays(leaves(j_bvh), "cpu"), verts,
                                   tris)
        want = jl.trace_rays_lbvh(j_ray, j_bvh, j_scene.verts, j_scene.tris)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    brute = intersect_brute(ray, verts, tris)
    np.testing.assert_array_equal(own.tri.numpy(), brute.tri.numpy())
    np.testing.assert_allclose(own.t.numpy(), brute.t.numpy(), rtol=1e-6)
    both = (own.tri >= 0).numpy()
    np.testing.assert_allclose(own.uv.numpy()[both], brute.uv.numpy()[both], atol=1e-4)
    if n_tris >= 60:
        assert both.any(), "fixture must hit something"


def test_any_hit():
    j_scene, verts, tris = _soup(120, 5)
    j_ray, ray, rng = _rays(512, 23)
    t_max = rng.uniform(0.1, 4.0, (512,)).astype(np.float32)
    j_bvh = jl.build_lbvh(j_scene.verts, j_scene.tris)
    got = lbvh.any_hit_lbvh(ray, torch.from_numpy(t_max),
                            flat_bvh_from_arrays(leaves(j_bvh), "cpu"), verts, tris)
    want = jl.any_hit_lbvh(j_ray, jnp.asarray(t_max), j_bvh, j_scene.verts, j_scene.tris)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    brute = any_hit_brute(ray, verts, tris, t_max=torch.from_numpy(t_max))
    own = lbvh.any_hit_lbvh(ray, torch.from_numpy(t_max), lbvh.build_lbvh(verts, tris), verts,
                            tris)
    np.testing.assert_array_equal(own.numpy(), brute.numpy())
    assert 0.0 < own.numpy().mean() < 1.0


def test_cornell_image_matches_brute():
    cfg = load_config("cornell256", height=64, width=64)
    scene, cam = get_scene(cfg, "cpu")
    wcfg = WhittedConfig(max_bounces=1, smooth_shading=False)
    img_l = render_image(scene, cam, 64, 64, wcfg, *lbvh.make_lbvh_tracers(scene)).numpy()
    img_b = render_image(scene, cam, 64, 64, wcfg).numpy()
    close = np.isclose(img_l, img_b, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert 1.0 - close.mean() < 0.005, f"{(~close).sum()} differing pixels"
    assert img_l.max() > 0.05
