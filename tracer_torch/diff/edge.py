"""Edge-aware visibility gradients (torch counterpart of tracer/diff/edge.py).

Hit/miss and shadow occlusion are step functions of the geometry, so plain
autograd through render_wavefront gives exactly zero gradient for a
parameter whose only effect is to move a visibility boundary (an occluder
translated between a light and a receiver). The true derivative is a
boundary (silhouette) integral.

Every hard hit indicator is paired with a smooth companion

    s = sigmoid(m / eps),   m = the signed world-space distance from the
                            ray/plane intersection point to the nearest
                            triangle edge (positive inside)

and the two are combined straight-through, soft + (hard - soft).detach():
the forward value is the hard render, while the backward pass sees the
smooth function, whose derivative concentrates in an eps-band around the
silhouette. The world-space margin (the barycentric margin times the
triangle's edge height 2A/|edge|) makes the gradient independent of how
finely the surface is triangulated.

This tier tests every ray against every triangle (R x T): it is the
gradient oracle, for scenes of optimization size. diff/edge_accel.py
restricts the smooth terms to a tile's nearest candidate clusters.
"""
from __future__ import annotations

import math

import torch

from tracer_torch.core import intersect as ci
from tracer_torch.core.types import RAY_EPS, T_FAR, Ray, cross, dot, normalize, take
from tracer_torch.render.whitted import WhittedConfig, material_rows, phong_specular, shading_frame


def _straight_through(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """Value = hard, gradient = d(soft)."""
    return soft + (hard.to(soft.dtype) - soft).detach()


def _corners(verts, tris):
    tl = tris.long()
    return [take(verts, tl[:, k]) for k in range(3)]


def edge_heights(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """(T, 3) world-space heights h[k] = 2 * area / |edge opposite vertex
    k|: the distance to the edge opposite k is bary_k * h[k]."""
    v0, v1, v2 = _corners(verts, tris)
    two_a = torch.linalg.norm(cross(v1 - v0, v2 - v0), dim=-1)
    lens = torch.stack([torch.linalg.norm(v2 - v1, dim=-1),   # opposite v0
                        torch.linalg.norm(v2 - v0, dim=-1),   # opposite v1
                        torch.linalg.norm(v1 - v0, dim=-1)],  # opposite v2
                       dim=-1)
    return two_a[:, None] / torch.clamp_min(lens, 1e-20)


def _pair_margins(ray: Ray, verts, tris, t_min, t_max, eps: float = 1e-12):
    """Every (ray, triangle) pair -> (hard_hit, world_margin, t_plane), each
    of shape batch + (T,).

    hard_hit: the hit predicate of moller_trumbore. world_margin: the
    signed distance from the ray/plane intersection to the triangle's
    nearest edge, positive inside. t_plane: the raw ray/plane parameter,
    defined for every non-degenerate triangle whether or not the
    barycentric test passes: the soft gates must see triangles the ray
    narrowly misses, or the silhouette gradient is one-sided."""
    v0, v1, v2 = _corners(verts, tris)
    e1 = v1 - v0
    e2 = v2 - v0
    o = ray.o[..., None, :]
    d = ray.d[..., None, :]
    pvec = cross(d, e2)
    det = (e1 * pvec).sum(-1)
    nondeg = det.abs() > eps
    inv_det = torch.where(nondeg, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = cross(tvec, e1)
    v = (d * qvec).sum(-1) * inv_det
    t_plane = torch.where(nondeg, (e2 * qvec).sum(-1) * inv_det, T_FAR)
    hit = (nondeg & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t_plane > t_min) & (t_plane < t_max))
    w = 1.0 - u - v
    h = edge_heights(verts, tris)
    margin = torch.minimum(torch.minimum(w * h[:, 0], u * h[:, 1]), v * h[:, 2])
    return hit, margin, t_plane


def soft_any_hit(ray: Ray, verts, tris, t_max, edge_eps: float, t_min: float = RAY_EPS):
    """Occlusion in [0, 1] with an edge-aware gradient: the value is the
    hard any-hit, the gradient that of the smooth union 1 - prod(1 -
    sigmoid(margin / eps)) over the triangles in the t range."""
    t_max_b = t_max[..., None] if isinstance(t_max, torch.Tensor) and t_max.ndim > 0 else t_max
    hit, margin, t_plane = _pair_margins(ray, verts, tris, t_min, T_FAR)
    # The t-range gate stays hard (a bool carries no gradient), on the raw
    # plane t, so triangles the ray narrowly misses (margin < 0) still add
    # their sigmoid tail: a two-sided silhouette gradient.
    in_range = (t_plane > t_min) & (t_plane < t_max_b)
    s = torch.sigmoid(margin / edge_eps) * in_range
    soft_occ = 1.0 - torch.prod(1.0 - s, dim=-1)
    hard_occ = (hit & in_range).any(-1)
    return _straight_through(hard_occ, soft_occ)


def soft_coverage(ray: Ray, verts, tris, edge_eps: float, t_min: float = RAY_EPS):
    """Primary-visibility coverage with an edge-aware gradient: 1 where the
    ray hits anything, the gradient of the smooth union over every triangle
    whose plane the ray crosses in front of it."""
    hit, margin, t_plane = _pair_margins(ray, verts, tris, t_min, T_FAR)
    in_front = (t_plane > t_min) & (t_plane < T_FAR)
    s = torch.sigmoid(margin / edge_eps) * in_front
    soft = 1.0 - torch.prod(1.0 - s, dim=-1)
    return _straight_through(hit.any(-1), soft)


def render_edge_aware(scene, ray: Ray, cfg: WhittedConfig, trace_fn, occlusion_fn,
                      coverage_fn) -> torch.Tensor:
    """The Whitted integrator of the edge-aware tiers -> (..., 3), over
    trace_fn(ray) -> Hit, occlusion_fn(shadow_ray, t_max) -> occlusion in
    [0, 1] and coverage_fn(ray, hit) -> coverage in [0, 1], the last two
    straight-through estimators whose values are the hard ones.

    Shadow rays leave every surface point along wi (unlit points included:
    the lighting is masked afterwards, not the ray), and the surface term is
    blended with the sky by the coverage, as the reference's edge tiers
    do."""
    dev = ray.o.device
    sky = torch.tensor(cfg.sky_color, dtype=torch.float32, device=dev)
    radiance = torch.zeros(ray.batch_shape + (3,), dtype=torch.float32, device=dev)
    throughput = torch.ones_like(radiance)
    live = torch.ones(ray.batch_shape, dtype=torch.bool, device=dev)

    for bounce in range(cfg.max_bounces):
        hit = trace_fn(ray)
        valid = hit.valid & live
        p, n, mat = shading_frame(scene, ray, hit, cfg.smooth_shading)
        albedo, emission, mirror, spec, shin = material_rows(scene.materials, mat)

        direct = torch.zeros_like(p)
        for li in range(scene.lights.count):
            lpos = scene.lights.position[li]
            lint = scene.lights.intensity[li]
            to_l = lpos - p
            dist2 = dot(to_l, to_l)
            dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
            wi = to_l / dist[..., None]
            cos = torch.clamp_min(dot(n, wi), 0.0)
            occ = occlusion_fn(Ray(o=p + n * RAY_EPS, d=wi), dist - 2 * RAY_EPS)
            vis = (1.0 - occ) * valid
            falloff = (vis / torch.clamp_min(dist2, 1e-20))[..., None] * lint
            brdf = (albedo / math.pi * cos[..., None]
                    + phong_specular(ray.d, n, wi, spec, shin)[..., None])
            direct = direct + brdf * falloff

        local = emission + albedo * cfg.ambient + direct
        alpha = torch.where(live, coverage_fn(ray, hit), 0.0)
        surf = torch.where(valid[..., None], local * (1.0 - mirror), 0.0)
        radiance = radiance + throughput * (
            alpha[..., None] * surf + (live * (1.0 - alpha))[..., None] * sky)

        if bounce + 1 < cfg.max_bounces:
            refl_d = ray.d - 2.0 * dot(ray.d, n, keepdim=True) * n
            ray = Ray(o=p + n * RAY_EPS, d=normalize(refl_d))
            throughput = throughput * mirror
            live = valid & (mirror[..., 0] > 0.0)
    return radiance


def render_diff(scene, ray: Ray, cfg: WhittedConfig, edge_eps: float = 1e-2) -> torch.Tensor:
    """Whitted integrator with edge-aware visibility gradients -> (..., 3).

    The forward value is the brute-force render_wavefront's (the
    straight-through estimators do not change the image); the backward
    pass also carries silhouette terms through shadow-ray occlusion and
    primary hit/miss coverage against the sky. Every ray against every
    triangle: for scenes of optimization size and small wavefronts."""
    verts, tris = scene.verts, scene.tris
    return render_edge_aware(
        scene, ray, cfg, lambda r: ci.intersect_brute(r, verts, tris),
        lambda sray, t_max: soft_any_hit(sray, verts, tris, t_max, edge_eps),
        lambda r, _hit: soft_coverage(r, verts, tris, edge_eps))


def render_diff_image(scene, camera, height: int, width: int,
                      cfg: WhittedConfig = WhittedConfig(), edge_eps: float = 1e-2):
    """render_diff of the camera's primary rays -> (H, W, 3)."""
    from tracer_torch.core.camera import generate_rays

    return render_diff(scene, generate_rays(camera, height, width), cfg, edge_eps)
