"""Tile/ray data parallelism: image rows split over the "data" ranks,
geometry and accel replicated (torch counterpart of tracer/dist/ray_dp.py).

Each rank generates only its own band of rows (core.camera.
generate_rays_band, bit-equal to those rows of the full frame's rays),
renders it through the one-card pipeline, and the bands meet in one
all_gather over the data group: every rank returns the full image, as the
reference returns a global array. Ranks that share a data index (the
"geom" axis) render the same band. The grad step's loss is the global
image mean: its all_reduce and the gradient's (SUM over the data group)
take the place of the psum that XLA inserts in the reference. The bucketed
grad step, whose all-reduces overlap the next bucket's backward, is
dist/grad_overlap.py.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
import torch.distributed as dist

from tracer_torch.core.camera import Camera, generate_rays_band
from tracer_torch.core.types import Ray
from tracer_torch.dist.mesh import DATA_AXIS, make_render_mesh, mesh_device
from tracer_torch.render.whitted import (
    WhittedConfig, bounce_step, make_brute_tracers, render_wavefront)
from tracer_torch.scene.types import Scene


def band_rows(height: int, n: int, i: int) -> tuple[int, int]:
    """(y0, rows) of band i of n over `height` rows: as torch.tensor_split
    splits them (the first height % n bands one row longer)."""
    q, rem = divmod(height, n)
    return i * q + min(i, rem), q + (i < rem)


def _data_coords(mesh) -> tuple[int, int, object]:
    """(data size, this rank's data index, the data group)."""
    return mesh.size(0), mesh.get_local_rank(DATA_AXIS), mesh.get_group(DATA_AXIS)


def shard_rays(rays: Ray, mesh) -> Ray:
    """This rank's rows (the first axis) of a ray batch: its band over the
    data axis, the placement of the reference's NamedSharding."""
    n, i, _ = _data_coords(mesh)
    y0, rows = band_rows(rays.o.shape[0], n, i)
    return Ray(o=rays.o[y0:y0 + rows], d=rays.d[y0:y0 + rows])


def gather_rows(local: torch.Tensor, height: int, group) -> torch.Tensor:
    """Every rank's band (band_rows over the group) -> the (height, ...)
    whole on every rank: one all_gather of bands padded to equal rows."""
    n = dist.get_world_size(group)
    longest = -(-height // n)
    pad = local.new_zeros((longest - local.shape[0], *local.shape[1:]))
    parts = [torch.empty((longest, *local.shape[1:]), dtype=local.dtype, device=local.device)
             for _ in range(n)]
    dist.all_gather(parts, torch.cat([local, pad]).contiguous(), group=group)
    return torch.cat([p[:band_rows(height, n, k)[1]] for k, p in enumerate(parts)])


def make_sharded_render_fn(scene: Scene, cfg, mesh, tracer_builder=None):
    """(scene, camera) -> the (H, W, 3) image on every rank; each rank
    renders its band of rows over builder(scene) (default: brute force).
    Any height: bands differ by at most one row."""
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    builder = tracer_builder or make_brute_tracers
    n, i, group = _data_coords(mesh)

    def run(scene: Scene, camera: Camera) -> torch.Tensor:
        with torch.inference_mode():
            trace_fn, occlude_fn = builder(scene)
            y0, rows = band_rows(cfg.height, n, i)
            rays = generate_rays_band(camera, cfg.height, cfg.width, y0, rows)
            img = render_wavefront(scene, rays, wcfg, trace_fn, occlude_fn)
            return gather_rows(img, cfg.height, group)

    return run


def _resharded_bands(scene, rays: Ray, wcfg, trace_fn, occlude_fn, group) -> torch.Tensor:
    """The band's radiance (R, 3) with every bounce after the first traced
    on the rank of the data group that owns its origins' Morton range
    (ulysses.reshard_rays_by_position), the results sent back after it."""
    from tracer_torch.dist.ulysses import reshard_rays_by_position

    lo = scene.verts.amin(0)
    hi = scene.verts.amax(0)
    o = rays.o.reshape(-1, 3)
    d = rays.d.reshape(-1, 3)
    r = o.shape[0]
    radiance = o.new_zeros((r, 3))
    throughput = o.new_ones((r, 3))
    live = torch.ones((r,), dtype=torch.bool, device=o.device)
    for bounce in range(wcfg.max_bounces):
        if bounce == 0:
            contrib, nray, throughput, live = bounce_step(
                scene, Ray(o=o, d=d), throughput, live, wcfg, trace_fn, occlude_fn)
            o, d = nray.o, nray.d
        else:
            aux = [throughput[:, 0], throughput[:, 1], throughput[:, 2], live.to(o.dtype)]
            o2, d2, aux2, restore = reshard_rays_by_position(o, d, aux, lo, hi, group)
            thr2 = torch.stack(aux2[0:3], -1)
            contrib2, nray2, thr3, live3 = bounce_step(
                scene, Ray(o=o2, d=d2), thr2, aux2[3] > 0.5, wcfg, trace_fn, occlude_fn)
            back = restore([*contrib2.unbind(-1), *nray2.o.unbind(-1), *nray2.d.unbind(-1),
                            *thr3.unbind(-1), live3.to(o.dtype)])
            contrib = torch.stack(back[0:3], -1)
            o = torch.stack(back[3:6], -1)
            d = torch.stack(back[6:9], -1)
            throughput = torch.stack(back[9:12], -1)
            live = back[12] > 0.5
        radiance = radiance + contrib
    return radiance


def make_sharded_accel_render_fn(scene: Scene, cfg, mesh, tracer_builder=None,
                                 reshard_bounces: bool = False):
    """Tile DP through the accel tiers: (scene, camera) -> the (H, W, 3)
    image on every rank. Each rank generates its own band of H / data rows,
    builds the replicated accel through tracer_builder (default
    api.build_tracers of cfg: on CUDA tensors the sorted tracers up to
    api.TILED_MAX_CLUSTERS clusters, the streamed ones past it, their
    kernels launched) and renders the band locally; no communication until
    the image's all_gather. The height must divide by the data size.

    reshard_bounces=True re-shards the wavefront of every bounce after the
    first across the data group by the Morton key of its origins
    (dist/ulysses.py), traces and shades it where it lands, and sends the
    contributions and the continuation back to the owning pixels. Exact:
    only the placement of the work moves."""
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    if tracer_builder is None:
        from tracer_torch.api import build_tracers

        tracer_builder = partial(build_tracers, cfg=cfg)
    n, i, group = _data_coords(mesh)
    if cfg.height % n:
        raise ValueError(f"height {cfg.height} not divisible by data={n}")
    if not reshard_bounces:
        return make_sharded_render_fn(scene, cfg, mesh, tracer_builder)
    band = cfg.height // n

    def run(scene: Scene, camera: Camera) -> torch.Tensor:
        with torch.inference_mode():
            rays = generate_rays_band(camera, cfg.height, cfg.width, i * band, band)
            trace_fn, occlude_fn = tracer_builder(scene)
            img = _resharded_bands(scene, rays, wcfg, trace_fn, occlude_fn, group)
            return gather_rows(img.reshape(band, cfg.width, 3), cfg.height, group)

    return run


def band_grad(scene: Scene, camera: Camera, target: torch.Tensor, cfg, builder, y0: int,
              rows: int):
    """(loss, d loss / d verts) of image rows [y0, y0 + rows): their share
    of the whole image's mean((img - target)**2), rendered over
    builder(scene with the verts)."""
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    verts = scene.verts.detach().requires_grad_(True)
    s = dataclasses.replace(scene, verts=verts)
    trace_fn, occlude_fn = builder(s)
    rays = generate_rays_band(camera, cfg.height, cfg.width, y0, rows)
    img = render_wavefront(s, rays, wcfg, trace_fn, occlude_fn)
    loss = ((img - target[y0:y0 + rows]) ** 2).sum() / (cfg.height * cfg.width * 3)
    (grads,) = torch.autograd.grad(loss, verts, allow_unused=True)
    return loss.detach(), torch.zeros_like(verts) if grads is None else grads


def make_sharded_grad_fn(scene: Scene, cfg, mesh, tracer_builder=None):
    """(scene, camera, target) -> (loss, d loss / d verts), the same on
    every rank: loss = mean((img - target)**2) over the whole image, each
    rank rendering its band over builder(scene with the verts) (default:
    brute force); the band's sum and its vertex gradient are all-reduced
    (SUM) over the data group."""
    builder = tracer_builder or make_brute_tracers
    n, i, group = _data_coords(mesh)

    def step(scene: Scene, camera: Camera, target: torch.Tensor):
        loss, grads = band_grad(scene, camera, target, cfg, builder, *band_rows(cfg.height, n, i))
        dist.all_reduce(loss, group=group)
        dist.all_reduce(grads, group=group)
        return loss, grads

    return step


def dryrun(device="cuda") -> None:
    """One sharded render and grad step, the bucketed grad step, the
    re-sharded-bounce render and (at an even world of 4 or more) the
    sharded-geometry tiers, on tiny shapes over the current world: proves
    that every distributed path runs. Every rank must call it."""
    from tracer_torch.api import get_scene
    from tracer_torch.dist.grad_overlap import make_overlapped_grad_fn
    from tracer_torch.utils.config import load_config

    dev = torch.device(device)
    n = dist.get_world_size()
    mesh = make_render_mesh(data=n, geom=1, device=dev)
    cfg = load_config("cornell256", height=8 * n, width=16)
    scene, camera = get_scene(cfg, mesh_device(mesh))

    img = make_sharded_render_fn(scene, cfg, mesh)(scene, camera)
    if img.shape != (cfg.height, cfg.width, 3):
        raise RuntimeError(f"sharded render: shape {tuple(img.shape)}")

    target = torch.zeros((cfg.height, cfg.width, 3), device=img.device)
    loss, grads = make_sharded_grad_fn(scene, cfg, mesh)(scene, camera, target)
    if grads.shape != scene.verts.shape or not bool(torch.isfinite(loss)):
        raise RuntimeError(f"sharded grad step: loss {float(loss)}, grads {tuple(grads.shape)}")

    loss_b, grads_b = make_overlapped_grad_fn(cfg, mesh, n_buckets=2)(scene, camera, target)
    if grads_b.shape != scene.verts.shape or not bool(torch.isfinite(loss_b)):
        raise RuntimeError(f"bucketed grad step: loss {float(loss_b)}")

    cfg3 = load_config("cornell256", height=8 * n, width=16, max_bounces=2)
    img_u = make_sharded_accel_render_fn(scene, cfg3, mesh, tracer_builder=make_brute_tracers,
                                         reshard_bounces=True)(scene, camera)
    if img_u.shape != (cfg3.height, cfg3.width, 3):
        raise RuntimeError(f"re-sharded render: shape {tuple(img_u.shape)}")

    if n % 2 == 0 and n >= 4:
        from tracer_torch.dist.ring import make_ring_render_fn

        mesh2 = make_render_mesh(data=n // 2, geom=2, device=dev)
        runs = [make_ring_render_fn(scene, cfg, mesh2, use_ring=u) for u in (True, False)]
        runs.append(make_ring_render_fn(scene, cfg, mesh2, use_ring=True, use_accel=True))
        for run in runs:
            img2 = run(scene, camera)
            if img2.shape != (cfg.height, cfg.width, 3):
                raise RuntimeError(f"sharded-geometry render: shape {tuple(img2.shape)}")
