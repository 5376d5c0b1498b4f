"""Edge-aware visibility gradients on the cluster accel (torch counterpart
of tracer/diff/edge_accel.py).

diff/edge.py computes the silhouette terms against every triangle, O(R x T).
This module restricts the smooth edge terms to the K nearest candidate
clusters of each ray tile (the front of the sorted cull's list), so the
cost is O(R x K x C) and follows the accel instead of the scene size. The
forward value stays the hard render (straight-through); only the backward
pass sees the truncation, which drops the silhouette terms of occluders past
the K-th candidate cluster.

The hard path runs on detached selection inputs (the cull sees no autograd
graph); gradients flow through the smooth margins, which are recomputed
from the accel's shade rows (v0, e1, e2 carry vertex gradients through
bvh.cluster.build_clusters).
"""
from __future__ import annotations

import torch

from tracer_torch.bvh.cluster import CLUSTER_SIZE, ClusterAccel, build_clusters
from tracer_torch.bvh.cull import CLUSTER_BITS, WORD_INVALID, _cut_words, cull_clusters_sorted
from tracer_torch.core.types import RAY_EPS, T_FAR, Ray, cross, take
from tracer_torch.diff.edge import _straight_through, render_edge_aware
from tracer_torch.kernels.traversal import make_accel_tracers, tile_rays, tiled_tmax, untile
from tracer_torch.render.whitted import WhittedConfig

_CL_MASK = (1 << CLUSTER_BITS) - 1
DEFAULT_EDGE_CLUSTERS = 2
_TR = 64


def _tile_candidates(accel: ClusterAccel, o_t, d_t, t_max_tile, k_edge: int):
    """The first k_edge front-to-back candidate clusters of each tile ->
    ((Nt, K) int32 ids, (Nt, K) valid), K = k_edge where the reference's
    cull keeps that many columns. The reference cuts its sorted words at
    k = max(8, min(64, Ncl) rounded up to 8) and takes the first k_edge of
    them; the port's cull keeps max(count) rounded up to 8 columns, which
    may be fewer, and the missing ones are WORD_INVALID."""
    k_ref = max(8, -(-min(64, accel.num_clusters) // 8) * 8)
    t_max_tile = t_max_tile.detach() if isinstance(t_max_tile, torch.Tensor) else t_max_tile
    words, _, _ = cull_clusters_sorted(accel.detach(), o_t.detach(), d_t.detach(), t_max_tile)
    w = _cut_words(words, min(k_edge, k_ref))
    valid = w != WORD_INVALID
    return torch.where(valid, w & _CL_MASK, 0), valid


def _candidate_margins(accel: ClusterAccel, o_t, d_t, cl_ids, cl_valid, t_min,
                       eps: float = 1e-12):
    """The smooth edge terms' inputs against the candidate clusters'
    triangles. o_t, d_t: (Nt, TR, 3); cl_ids: (Nt, K). Returns (margin,
    t_plane, valid), each (Nt, TR, K*C): the signed world-space distance
    to the nearest edge, the raw plane-intersection t, and which pairs are
    real, non-degenerate triangles."""
    c = accel.cluster_size
    n_t, k_e = cl_ids.shape
    shade_by_cluster = accel.shade.reshape(accel.num_clusters, c, -1)
    rows = take(shade_by_cluster, cl_ids.long()).reshape(n_t, k_e * c, -1)
    v0 = rows[..., 0:3]
    e1 = rows[..., 3:6]
    e2 = rows[..., 6:9]
    tri_valid = (rows[..., 25] > 0.5) & cl_valid.repeat_interleave(c, dim=1)
    # Padding slots carry all-zero rows, and a norm's gradient at 0 is not
    # finite: masking the result would not help (its cotangent times 0 is
    # still NaN). So padding slots get a safe dummy triangle before any
    # norm or cross.
    safe = tri_valid[..., None]
    v0 = torch.where(safe, v0, 0.0)
    e1 = torch.where(safe, e1, e1.new_tensor([1.0, 0.0, 0.0]))
    e2 = torch.where(safe, e2, e2.new_tensor([0.0, 1.0, 0.0]))

    o = o_t[:, :, None, :]      # (Nt, TR, 1, 3)
    d = d_t[:, :, None, :]
    v0b = v0[:, None]           # (Nt, 1, K*C, 3)
    e1b = e1[:, None]
    e2b = e2[:, None]
    pvec = cross(d, e2b)
    det = (e1b * pvec).sum(-1)
    nondeg = det.abs() > eps
    inv_det = torch.where(nondeg, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0b
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = cross(tvec, e1b)
    v = (d * qvec).sum(-1) * inv_det
    t_plane = torch.where(nondeg, (e2b * qvec).sum(-1) * inv_det, T_FAR)

    # Edge heights from the packed edges: the edges opposite (v0, v1, v2)
    # are (e2 - e1, e2, e1); h_k = 2A / |edge_k|.
    two_a = torch.linalg.norm(cross(e1, e2), dim=-1)  # (Nt, K*C)
    h0 = two_a / torch.clamp_min(torch.linalg.norm(e2 - e1, dim=-1), 1e-20)
    h1 = two_a / torch.clamp_min(torch.linalg.norm(e2, dim=-1), 1e-20)
    h2 = two_a / torch.clamp_min(torch.linalg.norm(e1, dim=-1), 1e-20)
    w_b = 1.0 - u - v
    margin = torch.minimum(torch.minimum(w_b * h0[:, None], u * h1[:, None]), v * h2[:, None])
    return margin, t_plane, tri_valid[:, None] & nondeg


def _soft_union(margin, gate, edge_eps: float, tiling, batch):
    """1 - prod(1 - sigmoid(margin / eps)) over each ray's gated pairs, in
    the rays' batch shape."""
    s = torch.sigmoid(margin / edge_eps) * gate
    soft = 1.0 - torch.prod(1.0 - s, dim=-1)
    return untile(soft, tiling).reshape(batch)


def soft_any_hit_accel(ray: Ray, accel: ClusterAccel, hard_occ, t_max, edge_eps: float,
                       k_edge: int = DEFAULT_EDGE_CLUSTERS, t_min: float = RAY_EPS):
    """Occlusion with an edge-aware gradient over the K nearest candidate
    clusters. `hard_occ` is the exact occlusion from any hard tier; t_max a
    per-ray tensor of the ray batch shape."""
    o_t, d_t, tiling = tile_rays(ray.o, ray.d, _TR)
    tm_t = tiled_tmax(t_max, ray, o_t, _TR)
    cl_ids, cl_valid = _tile_candidates(accel, o_t, d_t, tm_t, k_edge)
    margin, t_plane, valid = _candidate_margins(accel, o_t, d_t, cl_ids, cl_valid, t_min)
    in_range = (t_plane > t_min) & (t_plane < tm_t.detach()[..., None]) & valid
    return _straight_through(hard_occ, _soft_union(margin, in_range, edge_eps, tiling,
                                                   ray.batch_shape))


def soft_coverage_accel(ray: Ray, accel: ClusterAccel, hard_hit, edge_eps: float,
                        k_edge: int = DEFAULT_EDGE_CLUSTERS, t_min: float = RAY_EPS):
    """Primary coverage with an edge-aware gradient over the K nearest
    candidate clusters; `hard_hit` is the exact hit mask."""
    o_t, d_t, tiling = tile_rays(ray.o, ray.d, _TR)
    cl_ids, cl_valid = _tile_candidates(accel, o_t, d_t, T_FAR, k_edge)
    margin, t_plane, valid = _candidate_margins(accel, o_t, d_t, cl_ids, cl_valid, t_min)
    in_front = (t_plane > t_min) & (t_plane < T_FAR) & valid
    return _straight_through(hard_hit, _soft_union(margin, in_front, edge_eps, tiling,
                                                   ray.batch_shape))


def render_diff_accel(scene, ray: Ray, cfg: WhittedConfig, edge_eps: float = 1e-2,
                      k_edge: int = DEFAULT_EDGE_CLUSTERS,
                      cluster_size: int | None = None) -> torch.Tensor:
    """Whitted integrator with accel-tier edge-aware visibility gradients ->
    (..., 3).

    The forward value is that of render_wavefront over the plain cluster
    tracers (make_accel_tracers(use_pallas=False), no kernel); the backward
    pass adds silhouette terms from the K nearest candidate clusters for
    shadow occlusion and primary coverage. Interior gradients (shading,
    positions, albedo) flow through the hit's recompute as in the plain
    tier."""
    accel = build_clusters(scene.verts, scene.tris, cluster_size or CLUSTER_SIZE, scene=scene)
    trace_fn, occlude_fn = make_accel_tracers(scene, accel, use_pallas=False)
    return render_edge_aware(
        scene, ray, cfg, trace_fn,
        lambda sray, t_max: soft_any_hit_accel(sray, accel, occlude_fn(sray, t_max), t_max,
                                               edge_eps, k_edge),
        lambda r, hit: soft_coverage_accel(r, accel, hit.valid, edge_eps, k_edge))
