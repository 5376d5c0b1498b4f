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
import re
from pathlib import Path

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

from parity_util import leaves, segment_list


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
    k_cap = case["cand"].shape[1]
    tt.worklist_closest(o4, d4, accel.tri_w, accel.tri_ids, offs, clusters, k_cap)
    tt.worklist_anyhit(o4, d4, tm, accel.tri_w, offs, clusters, k_cap)
    assert LAUNCHES == before
    meta = lambda x: x.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tt.worklist_closest(*map(meta, (o4, d4, accel.tri_w, accel.tri_ids, offs, clusters)),
                            k_cap)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tt.worklist_anyhit(*map(meta, (o4, d4, tm, accel.tri_w, offs, clusters)), k_cap)


# ---------------------------------------------------------------------------
# The segmented kernels' arithmetic, on the CPU: what a block does with one
# segment is the plain version on that segment's items; how segments merge is
# the key's minimum (closest hit) or an OR (any-hit).
# ---------------------------------------------------------------------------

def _segment_runs(offs, clusters, seg, k_cap):
    """The segments of run_segments over the runs (offs, clusters), each as a
    run of its own -> (tile (S,), k0 (S,), seg_offs (S+1,), seg_clusters)."""
    counts = offs[1:] - offs[:-1]
    tile, k0 = map(torch.from_numpy, segment_list(*tt.run_segments(counts, seg, k_cap), seg))
    n = (counts[tile] - k0).clamp_max(seg)
    seg_offs = torch.cat([n.new_zeros(1), n.cumsum(0)]).int()
    within = torch.arange(int(n.sum())) - torch.repeat_interleave(seg_offs[:-1].long(), n)
    idx = torch.repeat_interleave(offs[tile].long() + k0, n) + within
    return tile, k0, seg_offs, clusters[idx]


def _closest_by_segments(o4, d4, w, ids, offs, clusters, seg, k_cap):
    """worklist_closest_plain on every segment, the winners packed into keys
    (the winner's place in its segment: the first item whose cluster holds
    its triangle id, and there the first lane with that id), the keys'
    minimum per ray, and the finishing pass."""
    c = ids.shape[1]
    tile, k0, s_offs, s_clusters = _segment_runs(offs, clusters, seg, k_cap)
    bt, btri, _, _ = tt.worklist_closest_plain(o4[tile], d4[tile], w, ids, s_offs, s_clusters)
    cand, n = tt._runs_to_slots(s_offs, s_clusters)
    match = ids[cand.long()][:, None] == btri[:, :, None, None]             # (S, TR, seg, C)
    match &= (torch.arange(cand.shape[1])[None] < n[:, None])[:, None, :, None]
    first = match.flatten(2).int().argmax(-1)
    keys = torch.where(bt < T_FAR, tt.pack_key(bt, k0[:, None] + first // c, first % c),
                       tt.KEY_MISS)
    merged = torch.full(o4.shape[:2], tt.KEY_MISS, dtype=torch.int64).scatter_reduce_(
        0, tile[:, None].expand_as(keys), keys, "amin")
    return tt.worklist_finish_plain(merged, o4, d4, w, ids, offs, clusters), tile


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.contiguous().view(torch.int32).numpy(),
                                      w.contiguous().view(torch.int32).numpy())


@pytest.mark.parametrize("seg", [tt.SEG_WL, 1])
def test_closest_by_segments_merges_to_the_whole_run(case, seg):
    """Closest hit over a run is the lexicographic minimum of (t bits, item,
    lane) over its segments, with u, v recomputed for the winner: t, tri, u,
    v bit for bit."""
    accel = case["accel"]
    o4, d4 = tt._homog(_t(case["o_t"]), _t(case["d_t"]))
    cand, counts = _t(case["cand"]), _t(case["counts"])
    offs, clusters = tt.tile_runs(cand, counts)
    whole = tt.worklist_closest_plain(o4, d4, accel.tri_w, accel.tri_ids, offs, clusters)
    got, tile = _closest_by_segments(o4, d4, accel.tri_w, accel.tri_ids, offs, clusters, seg,
                                     cand.shape[1])
    assert tile.shape[0] > o4.shape[0], "some tile must hold more than one segment"
    assert (whole[1] >= 0).sum() >= 5
    _assert_bit_equal(got, whole)


@pytest.mark.parametrize("seg", [tt.SEG_WL, 1])
def test_closest_by_segments_keeps_the_tie_rule(seg):
    """A hand-made tie: cluster 0 of the soup's accel appended again as the
    last cluster (ids + 20000) and walked first, so the same triangles stand
    at items 0 and 3 of every run (one segment of SEG_WL, two of 1), and in
    cluster 0 the triangle that is the closest hit of the most rays copied
    into the next lane under the id 10000. The earlier item and the lower
    lane win, segment by segment as over the whole run."""
    scene, o_t, d_t = _soup()
    j_accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 64)
    accel = accel_from_arrays(leaves(j_accel), "cpu")
    n_cl, c = accel.tri_ids.shape
    o4, d4 = tt._homog(_t(o_t), _t(d_t))
    n_tiles = o4.shape[0]
    w, ids = accel.tri_w.clone(), accel.tri_ids.clone()
    every = torch.arange(n_cl, dtype=torch.int32).repeat(n_tiles)
    first = tt.worklist_closest_plain(o4, d4, w, ids, (torch.arange(n_tiles + 1) * n_cl).int(),
                                      every)[1]
    wins = (first[..., None] == ids[0, :c - 1]).sum((0, 1))
    lane = int(wins.argmax())
    assert int(wins[lane]) > 0, "some ray's closest hit must lie in cluster 0"
    w[0, :, lane + 1::c] = w[0, :, lane::c]
    ids[0, lane + 1] = 10000
    w, ids = torch.cat([w, w[:1]]), torch.cat([ids, ids[:1] + 20000])
    run = torch.tensor([n_cl, 1, 2, 0] + list(range(3, n_cl)), dtype=torch.int32)
    offs = (torch.arange(n_tiles + 1) * run.shape[0]).int()
    clusters = run.repeat(n_tiles)
    whole = tt.worklist_closest_plain(o4, d4, w, ids, offs, clusters)
    assert (whole[1] == int(ids[0, lane]) + 20000).any()
    assert not (whole[1] % 20000 == 10000).any() and not (whole[1] == int(ids[0, lane])).any()
    got, _ = _closest_by_segments(o4, d4, w, ids, offs, clusters, seg, run.shape[0])
    _assert_bit_equal(got, whole)


@pytest.mark.parametrize("seg", [tt.SEG_WL, 1])
def test_anyhit_by_segments_ors_to_the_whole_run(case, seg):
    """Occlusion over a run is the OR of the occlusion over its segments."""
    accel = case["accel"]
    o4, d4 = tt._homog(_t(case["o_t"]), _t(case["d_t"]))
    cand, counts = _t(case["cand"]), _t(case["counts"])
    offs, clusters = tt.tile_runs(cand, counts)
    tm = _t(_shadow_tmax(case["o_t"]))
    whole = tt.worklist_anyhit_plain(o4, d4, tm, accel.tri_w, offs, clusters)
    tile, _, s_offs, s_clusters = _segment_runs(offs, clusters, seg, cand.shape[1])
    occ_seg = tt.worklist_anyhit_plain(o4[tile], d4[tile], tm[tile], accel.tri_w, s_offs,
                                       s_clusters)
    ored = torch.zeros(whole.shape, dtype=torch.int32).index_put_(
        (tile,), occ_seg.int(), accumulate=True) > 0
    assert 0.0 < whole.float().mean() < 1.0
    np.testing.assert_array_equal(ored.numpy(), whole.numpy())


@pytest.mark.parametrize("seg", [tt.SEG_WL, 1, 3])
def test_run_segments_over_worklist_counts(seg):
    """The segment table over runs as the work-list cull gives them: tiles
    without a candidate have no segment, a run as long as k_cap ends in a
    last, shorter rank when k_cap is no multiple of the segment, and the
    segments' runs hold every item of every run once, in run order."""
    counts = torch.tensor([0, 5, 11, 1, 0, 7, 11, 4], dtype=torch.int32)
    k_cap = 11
    offs = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    clusters = torch.arange(int(counts.sum()), dtype=torch.int32) + 100
    order, ends = tt.run_segments(counts, seg, k_cap)
    assert ends.shape == (-(-k_cap // seg),)
    assert int(ends[-1]) == int((-(-counts // seg)).sum())
    tile, k0, s_offs, s_clusters = _segment_runs(offs, clusters, seg, k_cap)
    assert not set(tile.tolist()) & {0, 4}
    n = s_offs[1:] - s_offs[:-1]
    assert bool((n >= 1).all()) and bool((n <= seg).all())
    last = k0 == (k_cap - 1) // seg * seg
    assert sorted(tile[last].tolist()) == [2, 6]
    assert bool((n[last] == k_cap - (k_cap - 1) // seg * seg).all())
    items = sorted((int(t), int(k) + i, int(s_clusters[int(a) + i]))
                   for t, k, a, m in zip(tile, k0, s_offs[:-1], n) for i in range(int(m)))
    want = [(t, i, int(clusters[int(offs[t]) + i])) for t in range(counts.shape[0])
            for i in range(int(counts[t]))]
    assert items == want


def test_closest_key_packing():
    """The key orders as (t, item, lane), round-trips at the limits of its
    fields, and the miss key decodes to (T_FAR, -1, 0, 0); past the limits
    check_key_fits raises."""
    item_max, lane_max = (1 << tt.KEY_ITEM_BITS) - 1, (1 << tt.KEY_LANE_BITS) - 1
    assert tt.KEY_ITEM_BITS == tcull.CLUSTER_BITS == 17 and tt.KEY_LANE_BITS == 15
    t = torch.tensor([1.0001e-4, 1.0001e-4, 1.0, 1.0, 1.0, 9.9e29], dtype=torch.float32)
    item = torch.tensor([0, item_max, 0, 0, item_max, item_max])
    lane = torch.tensor([lane_max, 0, 0, 1, lane_max, lane_max])
    keys = tt.pack_key(t, item, lane)
    assert keys.dtype == torch.int64 and bool((keys[1:] > keys[:-1]).all())
    assert bool((keys < tt.KEY_MISS).all()) and bool((keys > 0).all())
    t2, item2, lane2 = tt.unpack_key(keys)
    np.testing.assert_array_equal(t2.view(torch.int32).numpy(), t.view(torch.int32).numpy())
    np.testing.assert_array_equal(item2.numpy(), item.numpy())
    np.testing.assert_array_equal(lane2.numpy(), lane.numpy())

    miss = torch.full((2, 32), tt.KEY_MISS, dtype=torch.int64)
    assert float(tt.unpack_key(miss)[0][0, 0]) == np.float32(T_FAR)
    o4, d4 = tt._homog(torch.zeros(2, 32, 3), torch.ones(2, 32, 3))
    w, ids = torch.ones(3, 4, 3 * 8), torch.arange(24, dtype=torch.int32).reshape(3, 8)
    offs = torch.tensor([0, 2, 3], dtype=torch.int32)
    clusters = torch.tensor([0, 2, 1], dtype=torch.int32)
    for runs in ((offs, clusters), (torch.zeros(3, dtype=torch.int32), clusters[:0])):
        bt, btri, bu, bv = tt.worklist_finish_plain(miss, o4, d4, w, ids, *runs)
        assert bool((bt == T_FAR).all()) and bool((btri == -1).all())
        assert btri.dtype == torch.int32 and not bu.any() and not bv.any()

    tt.check_key_fits(1 << tt.KEY_LANE_BITS, 1 << tt.KEY_ITEM_BITS)
    with pytest.raises(ValueError, match="closest-hit key"):
        tt.check_key_fits((1 << tt.KEY_LANE_BITS) + 1, 8)
    with pytest.raises(ValueError, match="closest-hit key"):
        tt.check_key_fits(128, (1 << tt.KEY_ITEM_BITS) + 1)


def _built_cluster_sizes(src):
    """The cluster sizes csrc/traversal.cu's with_cluster_size dispatches to."""
    cases = re.findall(r"case (\d+): f\(std::integral_constant<int, (\d+)>\(\)\); return true;",
                       src)
    assert cases and all(a == b for a, b in cases)
    return tuple(int(a) for a, _ in cases)


def test_worklist_constants_pinned_to_the_kernels():
    """SEG_WL, CLUSTER_SIZES_WL and KEY_LANE_BITS are csrc/traversal.cu's
    kSegWL, the sizes with_cluster_size instantiates and kLaneBits, a block
    of the work-list kernels is TR threads, every segmented kernel claims
    through common.cuh's claim_segment at its own segment length, and
    KEY_MISS is kTFar's bits over all ones (the kernels cannot run here:
    their constants are read from the sources)."""
    csrc = Path(tt.__file__).parent / "csrc"
    src = (csrc / "traversal.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert ((int(consts["kSegWL"]), _built_cluster_sizes(src), int(consts["kLaneBits"]))
            == (tt.SEG_WL, tt.CLUSTER_SIZES_WL, tt.KEY_LANE_BITS))
    assert len(re.findall(r"kernel<decltype\(size\)::value><<<grid, tr, 0,", src)) == 2
    assert len(re.findall(r"with_cluster_size\(c, walk\)", src)) == 2
    assert len(re.findall(r"claim_segment<kSegWL>\(", src)) == 2
    for name in ("traversal2.cu", "stream.cu"):
        other = (csrc / name).read_text()
        assert "claim_segment<kSeg>(" in other and "claim_segment(" not in other
    far = re.search(r"constexpr float kTFar = (\S+)f;", (csrc / "common.cuh").read_text())
    far_bits = int(torch.tensor(float(far.group(1)), dtype=torch.float32).view(torch.int32))
    assert float(far.group(1)) == T_FAR and tt.KEY_MISS == (far_bits << 32) | 0xFFFFFFFF


@pytest.mark.parametrize("c", [4, 32, 64, 128, 48])
def test_worklist_cluster_sizes(c):
    """The work-list kernels are built for the cluster sizes the reference's
    tests build, 4, 32, 64 and 128 (read from csrc/traversal.cu): the
    wrappers' check passes those on to the device check (which CPU tensors
    fail) and raises for any other size, naming the set; nothing falls back
    to the plain version."""
    src = (Path(tt.__file__).parent / "csrc" / "traversal.cu").read_text()
    assert _built_cluster_sizes(src) == tt.CLUSTER_SIZES_WL == (4, 32, 64, 128)
    o4, d4 = tt._homog(torch.zeros(2, 32, 3), torch.ones(2, 32, 3))
    w = torch.zeros(3, 4, 3 * c)
    offs, clusters = torch.tensor([0, 1, 2], dtype=torch.int32), torch.tensor([0, 2], dtype=torch.int32)
    if c in tt.CLUSTER_SIZES_WL:
        with pytest.raises(RuntimeError, match="CUDA or CPU"):
            tt._check_worklist(o4, d4, w, offs, clusters)
    else:
        with pytest.raises(ValueError, match=re.escape(str(tt.CLUSTER_SIZES_WL))):
            tt._check_worklist(o4, d4, w, offs, clusters)
