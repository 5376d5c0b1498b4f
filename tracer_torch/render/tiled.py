"""Tile-resident Whitted integrator (torch counterpart of
tracer/render/tiled.py).

The frame stays in the (Ntiles, TR) tiled layout from primary rays to the
image: cull -> closest-hit kernels (selection only: which triangle) -> one
gather of the packed shade rows by slot id -> Moller-Trumbore recompute of
(t, u, v) and Lambert/Phong shading -> one light-origin shadow pass per
light (cull -> any-hit kernel) -> mirror bounces -> one untile at the end.

Gradients: the kernels are used for selection only (which triangle, a
conservative t) and see detached inputs, as the reference stop-gradients
them: the accel fields the culls and kernels read, the rays and the shadow
targets. Discrete selection is piecewise constant; hit attributes (t, u, v,
normal, position) are recomputed from the gathered shade rows, and that
recompute is differentiable w.r.t. vertices, normals, materials and camera,
so autograd flows through this integrator with no backward kernel of its
own. The gather of the shade rows by slot id (kernels/gather.py
`gather_rows`, whose backward is the segmented row sum of csrc/gather.cu) is
where gradients enter. Edge terms (a silhouette that moves) are not
differentiated.

Tracing (utils/metrics.py): each mirror bounce after the primary pass runs
under the span "render.bounce" (its closest-hit pass, its shadow passes and
its shading), and the counter "bounce_words" adds the words of those passes'
candidate lists, tiles x k, from the k each cull read. A one-bounce frame
records neither.
"""
from __future__ import annotations

import contextlib
import math

import torch

from tracer_torch.bvh.cluster import ClusterAccel
from tracer_torch.bvh.cull import cull_clusters_sorted2, round8
from tracer_torch.core.camera import Camera
from tracer_torch.core.types import T_FAR, RAY_EPS, dot, normalize
from tracer_torch.kernels.gather import gather_rows
from tracer_torch.kernels.traversal import untile, generate_rays_tiled, T_MIN
from tracer_torch.kernels.traversal2 import trace_tiles_split, any_hit_tiles_graded
from tracer_torch.render.whitted import WhittedConfig, phong_specular
from tracer_torch.utils.metrics import count, readback, span


def mt_from_edges(o, d, v0, e1, e2, t_min=T_MIN, eps=1e-12, bary_eps=1e-5):
    """Moller-Trumbore from (v0, e1, e2) rows -> (t, u, v, hit). The kernel
    already chose the triangle; `bary_eps` keeps this recompute from vetoing
    the choice over fp differences between the two formulations."""
    pvec = torch.linalg.cross(d, e2)
    det = dot(e1, pvec)
    inv = torch.where(det.abs() > eps, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv
    qvec = torch.linalg.cross(tvec, e1)
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    hit = ((det.abs() > eps) & (u >= -bary_eps) & (v >= -bary_eps)
           & (u + v <= 1.0 + bary_eps) & (t > t_min))
    return t, u, v, hit


def _trace_rows(accel: ClusterAccel, o_t, d_t):
    """Closest-hit selection pass -> (gid, rows (Nt, TR, SHADE_COLS), excess,
    need (k, s), split_need (P, Z)). The cull and the kernels see detached
    inputs; the rows keep the shade table's graph."""
    sel, o_t, d_t = accel.detach(), o_t.detach(), d_t.detach()
    words, counts, excess, need = cull_clusters_sorted2(sel, o_t, d_t, T_FAR)
    _bt, gid, t_excess, split_need = trace_tiles_split(o_t, d_t, sel, words, counts)
    with span("render.rows"):
        rows = gather_rows(accel.shade, gid.long())
    return gid, rows, excess + t_excess, need, split_need


def _segment_rays(light_pos, p_t, eps_t: float = RAY_EPS):
    """Shadow segments traced FROM the light: o = light, d = p - light
    (unnormalized, so t_max = 1 - eps/|d| uniformly excludes the receiving
    surface). Returns (o_t, d_t, t_max_t), detached: they feed only the
    cull and the any-hit kernel."""
    light_pos, p_t = light_pos.detach(), p_t.detach()
    o_t = light_pos.expand(p_t.shape)
    d_t = p_t - light_pos
    seg_len = torch.sqrt(torch.clamp_min(dot(d_t, d_t), 1e-20))
    return o_t, d_t, 1.0 - eps_t / seg_len


def _segment_occluded(accel: ClusterAccel, light_pos, p_t, eps_t: float = RAY_EPS):
    """Occlusion of the segments light <-> p -> (occ, excess, need, sneed)."""
    sel = accel.detach()
    with span("render.lights"):
        o_t, d_t, t_max_t = _segment_rays(light_pos, p_t, eps_t)
    words, counts, excess, need = cull_clusters_sorted2(sel, o_t, d_t, t_max_t)
    occ, t_excess, sneed = any_hit_tiles_graded(o_t, d_t, t_max_t, sel, words, counts)
    return occ, excess + t_excess, need, sneed


def _surface(o_t, d_t, gid, rows, smooth: bool):
    """Hit recompute and shading frame from the gathered rows -> (found, p,
    n) with n faced against the ray."""
    v0, e1, e2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    t, u, v, hitm = mt_from_edges(o_t, d_t, v0, e1, e2)
    found = (gid >= 0) & hitm & (rows[..., 25] > 0.5)
    p = o_t + t[..., None] * d_t
    if smooth:
        uu, vv = u[..., None], v[..., None]
        n = normalize(rows[..., 9:12] * (1.0 - uu - vv) + rows[..., 12:15] * uu
                      + rows[..., 15:18] * vv)
    else:
        n = normalize(torch.linalg.cross(e1, e2))
    n = torch.where(dot(n, d_t, keepdim=True) > 0, -n, n)
    return found, p, n


def _light_target(p, n, valid, lpos):
    """Per-light geometry -> (dist2, wi, cos, lit, target). Rays that
    cannot receive light target the light itself: a zero-length segment
    (d == 0) that the cull ignores and that never hits."""
    to_l = lpos - p
    dist2 = dot(to_l, to_l)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
    wi = to_l / dist[..., None]
    cos = torch.clamp_min(dot(n, wi), 0.0)
    lit = valid & (cos > 0.0)
    target = torch.where(lit[..., None], p + n * RAY_EPS, lpos)
    return dist2, wi, cos, lit, target


def render_tiled(scene, accel: ClusterAccel, camera: Camera, height: int,
                 width: int, cfg: WhittedConfig, tr: int = 64,
                 with_aux: bool = False):
    """Full-image Whitted render -> (H, W, 3), or ((H, W, 3), aux) when
    with_aux. aux['overflow'] counts cull candidates dropped (0: exact, and
    0 by construction here); aux['live_rays'] counts rays traced (the d != 0
    closest wavefront per bounce plus each light's lit segments); the
    need_* entries are the exact sizes each pass ran at."""
    dev = camera.position.device
    with span("render.rays"):
        o_t, d_t, tiling = generate_rays_tiled(camera, height, width, tr)
        shape = tuple(o_t.shape[:2])
        sky = torch.tensor(cfg.sky_color, dtype=torch.float32, device=dev)
        radiance = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
        throughput = torch.ones(shape + (3,), dtype=torch.float32, device=dev)
        live = torch.ones(shape, dtype=torch.bool, device=dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        live_rays = torch.zeros((), dtype=torch.int64, device=dev)
    needs = dict.fromkeys(("need_closest", "need_shadow", "need_s", "need_split",
                           "need_zero", "need_sh_b1", "need_sh_zero"), 0)

    def grow(key, value):
        needs[key] = max(needs[key], int(value))

    for bounce in range(cfg.max_bounces):
        with span("render.bounce") if bounce else contextlib.nullcontext():
            live_rays = live_rays + (d_t != 0.0).any(-1).sum()
            gid, rows, exc, need, sneed = _trace_rows(accel, o_t, d_t)
            overflow = overflow + exc
            grow("need_closest", need[0])
            grow("need_s", need[1])
            grow("need_split", sneed[0])
            grow("need_zero", sneed[1])
            if bounce:
                count("bounce_words", shape[0] * round8(need[0]))
            with span("render.surface"):
                found, p, n = _surface(o_t, d_t, gid, rows, cfg.smooth_shading)
                valid = found & live
                albedo = rows[..., 18:21]
                emission = rows[..., 21:24]
                mirror = rows[..., 24:25]
                spec = rows[..., 26]
                shin = rows[..., 27]
                direct = torch.zeros_like(p)

            for li in range(scene.lights.count):
                with span("render.lights"):
                    lpos = scene.lights.position[li]
                    lint = scene.lights.intensity[li]
                    dist2, wi, cos, lit, target = _light_target(p, n, valid, lpos)
                    live_rays = live_rays + lit.sum()
                occ, exc, need, sneed = _segment_occluded(accel, lpos, target)
                overflow = overflow + exc
                grow("need_shadow", need[0])
                grow("need_s", need[1])
                grow("need_sh_b1", sneed[0])
                grow("need_sh_zero", sneed[1])
                if bounce:
                    count("bounce_words", shape[0] * round8(need[0]))
                with span("render.shade"):
                    vis = torch.where(occ | ~lit, 0.0, 1.0)
                    falloff = (vis / torch.clamp_min(dist2, 1e-20))[..., None] * lint
                    brdf = (albedo / math.pi * cos[..., None]
                            + phong_specular(d_t, n, wi, spec, shin)[..., None])
                    direct = direct + brdf * falloff

            with span("render.shade"):
                local = emission + albedo * cfg.ambient + direct
                miss_contrib = torch.where((live & ~found)[..., None], sky, 0.0)
                surf_contrib = torch.where(valid[..., None], local * (1.0 - mirror), 0.0)
                radiance = radiance + throughput * (surf_contrib + miss_contrib)

                if bounce + 1 < cfg.max_bounces:
                    refl_d = d_t - 2.0 * dot(d_t, n, keepdim=True) * n
                    live = valid & (mirror[..., 0] > 0.0)
                    # Dead rays (a miss, or a non-mirror surface) get d = 0: the
                    # cull ignores them and all-dead tiles cost no kernel work.
                    m = live[..., None]
                    o_t = torch.where(m, p + n * RAY_EPS, 0.0)
                    d_t = torch.where(m, normalize(refl_d), 0.0)
                    throughput = throughput * mirror

    with span("render.untile"):
        img = untile(radiance, tiling)
    if with_aux:
        return img, {"overflow": readback(overflow, "render.overflow"),
                     "live_rays": readback(live_rays, "render.live_rays"), **needs}
    return img
