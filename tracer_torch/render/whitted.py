"""Whitted light transport over a ray wavefront: direct lighting, shadow
rays and mirror bounces (torch counterpart of tracer/render/whitted.py).

Tracing is pluggable: trace_fn(ray) -> Hit and occlude_fn(ray, t_max) ->
bool, so the same integrator drives the brute-force tracers and the
streamed kernel tier (kernels/stream.py). The bounce loop runs over the
whole wavefront; dead rays carry d = 0 and zero throughput instead of
leaving it.

Under a profiler the shading records the spans "wavefront.surface" (the
shading frame and material rows), "wavefront.lights" (each light's shadow
rays) and "wavefront.shade" (BRDF, falloff, the bounce's radiance and its
mirror continuation); the tracers run outside them, so they hold the
integrator's own work and no cull or traversal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from tracer_torch.core import intersect as ci
from tracer_torch.core.camera import generate_rays
from tracer_torch.core.types import RAY_EPS, Hit, Ray, dot, normalize, take
from tracer_torch.utils.metrics import readback, span

TraceFn = Callable[[Ray], Hit]
OccludeFn = Callable[[Ray, torch.Tensor], torch.Tensor]


def make_brute_tracers(scene) -> tuple[TraceFn, OccludeFn]:
    """Brute-force all-pairs tracers (every ray against every triangle)."""

    def trace(ray: Ray) -> Hit:
        return ci.intersect_brute(ray, scene.verts, scene.tris)

    def occlude(ray: Ray, t_max) -> torch.Tensor:
        return ci.any_hit_brute(ray, scene.verts, scene.tris, t_min=RAY_EPS, t_max=t_max)

    return trace, occlude


def shading_frame(scene, ray: Ray, hit: Hit, smooth: bool):
    """Surface point, shading normal (faced against the ray) and material
    index at each hit; misses get harmless defaults (masked later)."""
    tri = hit.tri.clamp_min(0).long()
    idx = scene.tris[tri].long()
    p = ray.at(hit.t)
    if smooth:
        n0, n1, n2 = (take(scene.normals, idx[..., i]) for i in range(3))
        u = hit.uv[..., 0:1]
        v = hit.uv[..., 1:2]
        n = normalize(n0 * (1.0 - u - v) + n1 * u + n2 * v)
    else:
        v0, v1, v2 = (take(scene.verts, idx[..., i]) for i in range(3))
        n = normalize(torch.linalg.cross(v1 - v0, v2 - v0))
    n = torch.where(dot(n, ray.d, keepdim=True) > 0, -n, n)
    return p, n, scene.mat_id[tri].long()


def material_rows(mats, mat):
    """The material of each hit -> (albedo (..., 3), emission (..., 3),
    mirror (..., 1), specular (...), shininess (...))."""
    return (take(mats.albedo, mat), take(mats.emission, mat), take(mats.mirror, mat)[..., None],
            take(mats.specular, mat), take(mats.shininess, mat))


def phong_specular(d, n, wi, spec, shin):
    """Classic Phong lobe: ks * max(0, R . wi)^shininess with R the view
    ray's mirror direction about the shading normal; (...,) weight. ks == 0
    contributes exactly zero (0^n is masked)."""
    r = d - 2.0 * (d * n).sum(-1, keepdim=True) * n
    cos_r = torch.clamp_min((r * wi).sum(-1), 0.0)
    on = spec > 0.0
    base = torch.where(cos_r > 0.0, cos_r, 1.0)
    lobe = torch.where((cos_r > 0.0) & on, base ** shin, 0.0)
    return spec * lobe


def shadow_ray(p, n, valid, lpos):
    """The shadow ray of each surface point toward one point light: it
    leaves the surface (o = p + n*RAY_EPS) along wi, or along d = 0 where
    the point is not lit (not valid, or facing away), with t_max = dist -
    2*RAY_EPS. Returns (ray, t_max, dist2, wi, cos)."""
    to_l = lpos - p
    dist2 = dot(to_l, to_l)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
    wi = to_l / dist[..., None]
    cos = torch.clamp_min(dot(n, wi), 0.0)
    lit = valid & (cos > 0.0)
    ray = Ray(o=p + n * RAY_EPS, d=torch.where(lit[..., None], wi, 0.0))
    return ray, dist - 2 * RAY_EPS, dist2, wi, cos


def direct_lighting(scene, p, n, d, albedo, spec, shin, valid, occlude_fn: OccludeFn):
    """Lambert + Phong direct lighting with one shadow wavefront per point
    light; `d` is the incoming unit ray direction."""
    total = torch.zeros_like(p)
    for li in range(scene.lights.count):
        with span("wavefront.lights"):
            ray, t_max, dist2, wi, cos = shadow_ray(p, n, valid, scene.lights.position[li])
        occluded = occlude_fn(ray, t_max)
        with span("wavefront.shade"):
            vis = torch.where(occluded | ~valid, 0.0, 1.0)
            falloff = ((vis / torch.clamp_min(dist2, 1e-20))[..., None]
                       * scene.lights.intensity[li])
            brdf = (albedo / math.pi * cos[..., None]
                    + phong_specular(d, n, wi, spec, shin)[..., None])
            total = total + brdf * falloff
    return total


@dataclasses.dataclass(frozen=True)
class WhittedConfig:
    max_bounces: int = 1  # 1 = primary rays only
    smooth_shading: bool = True
    sky_color: tuple = (0.0, 0.0, 0.0)
    ambient: float = 0.04


def bounce_step(scene, ray: Ray, throughput, live, cfg: WhittedConfig,
                trace_fn: TraceFn, occlude_fn: OccludeFn):
    """One Whitted bounce on an explicit wavefront state -> (contrib,
    next_ray, next_throughput, next_live): the radiance this bounce adds per
    ray, and the mirror continuation."""
    hit = trace_fn(ray)
    with span("wavefront.surface"):
        valid = hit.valid & live
        p, n, mat = shading_frame(scene, ray, hit, cfg.smooth_shading)
        albedo, emission, mirror, spec, shin = material_rows(scene.materials, mat)

    direct = direct_lighting(scene, p, n, ray.d, albedo, spec, shin, valid, occlude_fn)
    with span("wavefront.shade"):
        sky = torch.tensor(cfg.sky_color, dtype=torch.float32, device=ray.o.device)
        local = emission + albedo * cfg.ambient + direct
        miss_contrib = torch.where((live & ~hit.valid)[..., None], sky, 0.0)
        surf_contrib = torch.where(valid[..., None], local * (1.0 - mirror), 0.0)
        contrib = throughput * (surf_contrib + miss_contrib)

        refl_d = ray.d - 2.0 * dot(ray.d, n, keepdim=True) * n
        next_live = valid & (mirror[..., 0] > 0.0)
        # Dead rays bounce with d = 0: the tracers skip them for free.
        m = next_live[..., None]
        next_ray = Ray(o=torch.where(m, p + n * RAY_EPS, 0.0),
                       d=torch.where(m, normalize(refl_d), 0.0))
    return contrib, next_ray, throughput * mirror, next_live


def render_wavefront(scene, ray: Ray, cfg: WhittedConfig, trace_fn: TraceFn,
                     occlude_fn: OccludeFn) -> torch.Tensor:
    """Integrate a wavefront of rays -> linear RGB (..., 3)."""
    radiance = torch.zeros(ray.batch_shape + (3,), dtype=torch.float32, device=ray.o.device)
    throughput = torch.ones_like(radiance)
    live = torch.ones(ray.batch_shape, dtype=torch.bool, device=ray.o.device)
    for _ in range(cfg.max_bounces):
        contrib, ray, throughput, live = bounce_step(scene, ray, throughput, live, cfg,
                                                     trace_fn, occlude_fn)
        radiance = radiance + contrib
    return radiance


def render_wavefront_aux(scene, ray: Ray, cfg: WhittedConfig, trace_fn_aux, occlude_fn_aux):
    """render_wavefront over tracers that also return their cull's aux
    {"excess", "need_k", "need_s"} (kernels/stream.py). Returns (radiance,
    aux) with aux["overflow"] the excess summed over every pass (on the
    device, read once at the end: the read-back "wavefront.overflow"), and
    the needs max-combined: "need_trace_k" over the closest-hit passes,
    "need_occ_k" over the occlusion passes, "need_s" over both."""
    tot = {"overflow": 0, "need_trace_k": 0, "need_occ_k": 0, "need_s": 0}

    def add(aux, k_key):
        tot["overflow"] = tot["overflow"] + aux["excess"]
        tot[k_key] = max(tot[k_key], int(aux["need_k"]))
        tot["need_s"] = max(tot["need_s"], int(aux["need_s"]))

    def trace_fn(r):
        hit, aux = trace_fn_aux(r)
        add(aux, "need_trace_k")
        return hit

    def occlude_fn(r, t_max):
        occ, aux = occlude_fn_aux(r, t_max)
        add(aux, "need_occ_k")
        return occ

    radiance = render_wavefront(scene, ray, cfg, trace_fn, occlude_fn)
    over = tot["overflow"]
    over = readback(over, "wavefront.overflow") if torch.is_tensor(over) else over
    return radiance, {**tot, "overflow": over}


def render_image(scene, camera, height: int, width: int, cfg: WhittedConfig = WhittedConfig(),
                 trace_fn: TraceFn | None = None,
                 occlude_fn: OccludeFn | None = None) -> torch.Tensor:
    """Full-image render -> (H, W, 3) linear RGB, on the scene's device.
    Either tracer not given is the brute-force one."""
    if trace_fn is None or occlude_fn is None:
        bt, bo = make_brute_tracers(scene)
        trace_fn = trace_fn or bt
        occlude_fn = occlude_fn or bo
    return render_wavefront(scene, generate_rays(camera, height, width), cfg, trace_fn,
                            occlude_fn)
