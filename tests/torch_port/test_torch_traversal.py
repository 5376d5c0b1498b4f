"""tracer_torch's work-list tier (bvh.cull.cull_clusters and
kernels/traversal.py) vs the JAX package on the CPU: the jnp tier and the
Pallas work-list kernels in interpret mode.

One accel, built by the JAX package at cluster_size=64, feeds both sides
through tracer_torch.bridge, and one cull's candidates feed both traversals.
Candidate lists, work lists, triangle ids and occlusion are held exact. The
best t is held to rtol 1e-6 and u, v to rtol 1e-5 + atol 5e-5: XLA contracts
the reference's products into FMAs, the port rounds each product (as its
CUDA kernels do, built with -fmad=false). u = so_u + t * sd_u cancels two
terms of the size of |o| / edge length (about 60 on the bunny's small
triangles, one ulp 4e-6), so a few ulps of them show in u: the largest
difference was 2.5e-5 on the bunny and under 1e-5 on the soup when this was
written."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh.cluster import build_clusters
from tracer.bvh.cull import cull_clusters as j_cull_clusters
from tracer.core.camera import Camera as JCamera
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.core.types import T_FAR
from tracer.kernels import traversal as jt
from tracer.scene.procedural import bunny_scene, random_tri_soup
from tracer_torch.bridge import accel_from_arrays, scene_from_arrays
from tracer_torch.bvh import cull as tcull
from tracer_torch.core.intersect import any_hit_brute, intersect_brute
from tracer_torch.core.types import Ray
from tracer_torch.kernels import traversal as tt
from tracer_torch.kernels._launch import LAUNCHES

from parity_util import leaves


def _soup():
    """400 random triangles and 512 random rays, 2 tiles of 256 (the fixture
    of tests/unit/test_pallas_kernels.py)."""
    scene = random_tri_soup(400, seed=0)
    rng = np.random.default_rng(1)
    o = rng.normal(size=(512, 3)).astype(np.float32) * 2
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o_t, d_t, _ = jt.tile_rays(jnp.asarray(o), jnp.asarray(d), 256)
    return scene, np.array(o_t), np.array(d_t)


def _bunny():
    """The subdiv-3 bunny and its 64x64 primary rays, 16 tiles of 16x16."""
    scene, cam = bunny_scene(3)
    rays = j_generate_rays(JCamera.make(**cam), 64, 64)
    o_t, d_t, tiling = jt.tile_rays(rays.o, rays.d, 256)
    assert tiling.tile_hw is not None
    return scene, np.array(o_t), np.array(d_t)


FIXTURES = {"bunny3": _bunny, "soup400": _soup}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def case(request):
    scene, o_t, d_t = FIXTURES[request.param]()
    accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 64)
    cand, counts, excess = j_cull_clusters(accel, jnp.asarray(o_t), jnp.asarray(d_t), T_FAR,
                                           accel.num_clusters)
    assert int(excess) == 0
    return {"scene": scene, "j_accel": accel, "accel": accel_from_arrays(leaves(accel), "cpu"),
            "o_t": o_t, "d_t": d_t, "cand": cand, "counts": counts}


def _t(x):
    return torch.from_numpy(np.array(x))


def _shadow_tmax(o_t):
    """A per-ray t_max that varies over the tile (1.5 .. 3.5)."""
    return (1.5 + 2.0 * np.linspace(0.0, 1.0, o_t.shape[1], dtype=np.float32)
            )[None].repeat(o_t.shape[0], 0)


@pytest.mark.parametrize("per_ray", [False, True], ids=["t_far", "per_ray_tmax"])
def test_cull_clusters_matches_reference(case, per_ray):
    """Candidates (ascending cluster id, padded by the last valid id) and
    counts equal the reference's; the port's lists are as wide as the
    longest one, the reference's as wide as its cap."""
    o_t, d_t = case["o_t"], case["d_t"]
    n_cl = case["accel"].num_clusters
    tm = _shadow_tmax(o_t) if per_ray else T_FAR
    j_cand, j_counts, _ = j_cull_clusters(case["j_accel"], jnp.asarray(o_t), jnp.asarray(d_t),
                                          jnp.asarray(tm) if per_ray else tm, n_cl)
    cand, counts, excess = tcull.cull_clusters(case["accel"], _t(o_t), _t(d_t),
                                               _t(tm) if per_ray else tm)
    k = max(1, int(np.asarray(j_counts).max()))
    assert cand.shape == (o_t.shape[0], k) and cand.dtype == torch.int32
    assert int(excess) == 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(j_cand)[:, :k])
    assert counts.numpy().max() > 1, "fixture must have candidates"


def test_cull_clusters_k_cap_matches_reference(case):
    """An explicit k_cap cuts the lists as the reference's static cap does,
    and reports the same excess."""
    o_t, d_t = case["o_t"], case["d_t"]
    j_cand, j_counts, j_excess = j_cull_clusters(case["j_accel"], jnp.asarray(o_t),
                                                 jnp.asarray(d_t), T_FAR, 3)
    cand, counts, excess = tcull.cull_clusters(case["accel"], _t(o_t), _t(d_t), T_FAR, k_cap=3)
    assert int(excess) == int(j_excess) > 0
    np.testing.assert_array_equal(cand.numpy(), np.asarray(j_cand))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


def test_frustum_feasible_is_the_entry_test():
    rng = np.random.default_rng(3)
    lo = _t(rng.uniform(-1, 0, (5, 1, 3)).astype(np.float32))
    hi = lo + 0.3
    box_lo = _t(rng.uniform(-2, 2, (1, 7, 3)).astype(np.float32))
    args = (lo, hi, lo * 0.5, hi * 0.5 + 0.5, box_lo, box_lo + 0.7, torch.tensor(5.0))
    np.testing.assert_array_equal(tcull.frustum_aabb_feasible(*args).numpy(),
                                  tcull.frustum_aabb_entry(*args)[0].numpy())


@pytest.mark.parametrize("cap", ["wide", "short"])
def test_build_worklist_matches_reference(case, cap):
    """Items equal the reference's at the same work_cap: a cap wider than
    the list pads it, a shorter one cuts it and reports the overflow."""
    cand, counts = case["cand"], case["counts"]
    total = int(np.maximum(np.asarray(counts), 1).sum())
    work_cap = total + 5 if cap == "wide" else total - 3
    want = jt.build_worklist(cand, counts, work_cap)
    got = tt.build_worklist(_t(cand), _t(counts), work_cap)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] is (cap == "short") and bool(want[3]) == got[3]


def test_build_worklist_default_is_exact(case):
    """work_cap None: exactly max(count, 1) items a tile in tile order, none
    dropped; the runs the kernels read (tile_runs) are its valid items and
    hold each tile's candidates."""
    cand, counts = _t(case["cand"]), _t(case["counts"])
    tile_of, cluster_of, valid, overflow = tt.build_worklist(cand, counts)
    eff = counts.clamp_min(1)
    assert overflow is False and tile_of.shape[0] == int(eff.sum())
    np.testing.assert_array_equal(torch.bincount(tile_of.long()).numpy(), eff.numpy())
    assert bool((tile_of[1:] >= tile_of[:-1]).all())
    offs, clusters = tt.tile_runs(cand, counts)
    np.testing.assert_array_equal((offs[1:] - offs[:-1]).numpy(), counts.numpy())
    np.testing.assert_array_equal(clusters.numpy(), cluster_of[valid.bool()].numpy())
    for t in range(cand.shape[0]):
        np.testing.assert_array_equal(clusters[offs[t]:offs[t + 1]].numpy(),
                                      cand[t, :counts[t]].numpy())


def _check_closest(got, want):
    bt, btri, bu, bv = (np.asarray(x) for x in want[:4])
    np.testing.assert_array_equal(got[1].numpy(), btri)
    np.testing.assert_allclose(got[0].numpy(), bt, rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), bu, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(got[3].numpy(), bv, rtol=1e-5, atol=5e-5)


def test_trace_tiles_plain_matches_jnp_and_pallas(case):
    o_t, d_t, cand, counts = (case[k] for k in ("o_t", "d_t", "cand", "counts"))
    got = tt.trace_tiles_plain(_t(o_t), _t(d_t), case["accel"], _t(cand), _t(counts))
    assert (got[1].numpy() >= 0).sum() >= 5, "fixture must hit something"
    ref = jax.jit(jt.trace_tiles_jnp)(jnp.asarray(o_t), jnp.asarray(d_t), case["j_accel"],
                                      cand, counts)
    _check_closest(got, ref)
    work_cap = o_t.shape[0] * case["accel"].num_clusters
    pal = jt.trace_tiles_pallas(jnp.asarray(o_t), jnp.asarray(d_t), case["j_accel"], cand,
                                counts, work_cap, interpret=True)
    assert not bool(pal[4])
    _check_closest(got, pal)


def test_trace_tiles_worklist_is_the_plain_version_on_cpu(case):
    """On CPU tensors trace_tiles_worklist runs the plain version over the
    runs of its list: bit-equal to trace_tiles_plain over the padded lists,
    and it launches nothing."""
    args = (_t(case["o_t"]), _t(case["d_t"]), case["accel"], _t(case["cand"]),
            _t(case["counts"]))
    before = dict(LAUNCHES)
    got = tt.trace_tiles_worklist(*args)
    assert len(got) == 4 and LAUNCHES == before
    for g, w in zip(got, tt.trace_tiles_plain(*args)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    tm = _t(_shadow_tmax(case["o_t"]))
    occ = tt.any_hit_tiles_worklist(args[0], args[1], tm, *args[2:])
    assert LAUNCHES == before
    np.testing.assert_array_equal(
        occ.numpy(), tt.any_hit_tiles_plain(args[0], args[1], tm, *args[2:]).numpy())


def test_any_hit_tiles_plain_matches_jnp_and_pallas(case):
    o_t, d_t = case["o_t"], case["d_t"]
    tm = _shadow_tmax(o_t)
    n_cl = case["accel"].num_clusters
    cand, counts, _ = j_cull_clusters(case["j_accel"], jnp.asarray(o_t), jnp.asarray(d_t),
                                      jnp.asarray(tm), n_cl)
    got = tt.any_hit_tiles_plain(_t(o_t), _t(d_t), _t(tm), case["accel"], _t(cand),
                                 _t(counts)).numpy()
    assert 0.0 < got.mean() < 1.0, "fixture must occlude some rays, not all"
    ref = jax.jit(jt.any_hit_tiles_jnp)(jnp.asarray(o_t), jnp.asarray(d_t), jnp.asarray(tm),
                                        case["j_accel"], cand, counts)
    np.testing.assert_array_equal(got, np.asarray(ref))
    occ, overflow = jt.any_hit_tiles_pallas(jnp.asarray(o_t), jnp.asarray(d_t),
                                            jnp.asarray(tm), case["j_accel"], cand, counts,
                                            o_t.shape[0] * n_cl, interpret=True)
    assert not bool(overflow)
    np.testing.assert_array_equal(got, np.asarray(occ))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "worklist"])
def test_make_accel_tracers_match_brute_force(case, use_pallas):
    """300 random rays (padded to 2 tiles of 256) through the tracers vs the
    port's brute force: the same triangle, or an equal t where two
    triangles tie; occlusion exact."""
    scene = scene_from_arrays(leaves(case["scene"]), "cpu")
    trace_fn, occlude_fn = tt.make_accel_tracers(scene, case["accel"], use_pallas=use_pallas)
    rng = np.random.default_rng(9)
    o = rng.normal(size=(300, 3)).astype(np.float32) * 2
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray(o=_t(o), d=_t(d))
    hit = trace_fn(ray)
    ref = intersect_brute(ray, scene.verts, scene.tris)
    same_tri = hit.tri.numpy() == ref.tri.numpy()
    same_t = np.isclose(hit.t.numpy(), ref.t.numpy(), rtol=1e-4, atol=1e-6)
    assert (same_tri | same_t).all() and same_tri.mean() > 0.99
    assert hit.uv.shape == (300, 2) and (hit.tri.numpy() >= 0).any()
    t_max = torch.full((300,), 3.0)
    np.testing.assert_array_equal(
        occlude_fn(ray, t_max).numpy(),
        any_hit_brute(ray, scene.verts, scene.tris, t_max=t_max).numpy())


def test_k_cap_overflow_warns(case):
    scene = scene_from_arrays(leaves(case["scene"]), "cpu")
    trace_fn, _ = tt.make_accel_tracers(scene, case["accel"], k_cap=1)
    ray = Ray(o=_t(case["o_t"]).reshape(-1, 3), d=_t(case["d_t"]).reshape(-1, 3))
    with pytest.warns(RuntimeWarning, match="candidate-cap overflow"):
        trace_fn(ray)


def test_trace_tiles_plain_gradient_matches_jax(case):
    """d/d tri_w of the sum of the hit distances through trace_tiles_plain
    vs jax.grad through trace_tiles_jnp: relative L2 under 1e-4 (it was
    under 1e-6 on both fixtures when this was written)."""
    o_t, d_t, cand, counts = (case[k] for k in ("o_t", "d_t", "cand", "counts"))
    j_accel = case["j_accel"]

    def j_loss(w):
        bt = jt.trace_tiles_jnp(jnp.asarray(o_t), jnp.asarray(d_t),
                                dataclasses.replace(j_accel, tri_w=w), cand, counts)[0]
        return jnp.sum(jnp.where(bt < T_FAR, bt, 0.0))

    want = np.asarray(jax.jit(jax.grad(j_loss))(j_accel.tri_w))
    w = case["accel"].tri_w.clone().requires_grad_(True)
    bt = tt.trace_tiles_plain(_t(o_t), _t(d_t), dataclasses.replace(case["accel"], tri_w=w),
                              _t(cand), _t(counts))[0]
    torch.where(bt < T_FAR, bt, 0.0).sum().backward()
    got = w.grad.numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-4, f"relative L2 {rel:.3g}"


def test_worklist_wrappers_dispatch_by_device(case):
    """CPU tensors run the plain versions and launch nothing; a tensor on
    any other non-CUDA device raises instead of falling back."""
    accel = case["accel"]
    o4, d4 = tt._homog(_t(case["o_t"]), _t(case["d_t"]))
    offs, clusters = tt.tile_runs(_t(case["cand"]), _t(case["counts"]))
    tm = torch.ones(o4.shape[:2])
    before = dict(LAUNCHES)
    tt.worklist_closest(o4, d4, accel.tri_w, accel.tri_ids, offs, clusters)
    tt.worklist_anyhit(o4, d4, tm, accel.tri_w, offs, clusters)
    assert LAUNCHES == before
    meta = lambda x: x.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tt.worklist_closest(*map(meta, (o4, d4, accel.tri_w, accel.tri_ids, offs, clusters)))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tt.worklist_anyhit(*map(meta, (o4, d4, tm, accel.tri_w, offs, clusters)))
