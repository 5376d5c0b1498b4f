"""User-facing API: get_scene / build_tracers / make_render_fn / render /
benchmark (torch counterpart of tracer/api.py, forward frames).

make_render_fn picks a tier from the config, as the reference does:
  * use_bvh + use_pallas, at most TILED_MAX_CLUSTERS clusters: the tiled
    tier (render/tiled.py over kernels/traversal2.py);
  * use_bvh + use_pallas, more clusters: the streamed tier
    (render/whitted.py's wavefront integrator over kernels/stream.py);
  * every other config: the wavefront integrator over build_tracers: brute
    force without use_bvh, the plain cluster tier (kernels/traversal.py)
    with use_bvh alone.

The reference recompiles its frames until static candidate caps are wide
enough (a sizing loop with a persisted caps cache), because XLA needs
static shapes. Here each pass reads its needs and runs at exactly that size,
so every frame is exact by construction and there is nothing to size.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from tracer_torch.bvh.cluster import CLUSTER_SIZE, build_scene_accel
from tracer_torch.core.camera import Camera, generate_rays
from tracer_torch.kernels.stream import make_streamed_tracers, make_streamed_tracers_aux
from tracer_torch.kernels.traversal import make_accel_tracers
from tracer_torch.kernels.traversal2 import make_sorted_tracers
from tracer_torch.render.tiled import render_tiled
from tracer_torch.render.whitted import (
    WhittedConfig, make_brute_tracers, render_wavefront, render_wavefront_aux)
from tracer_torch.scene import procedural
from tracer_torch.scene.types import Scene
from tracer_torch.utils.config import RenderConfig, load_config

# Clusters (of CLUSTER_SIZE triangles) up to which a use_bvh + use_pallas
# config renders through the tiled tier; past it, through the streamed one.
# The reference's _VMEM_RESIDENT_CLUSTERS (tracer/api.py:64).
TILED_MAX_CLUSTERS = 2048


def get_scene(cfg: RenderConfig, device) -> tuple[Scene, Camera]:
    """Resolve the scene + canonical camera named by the config."""
    if cfg.scene == "cornell":
        scene, cam = procedural.cornell_box(device=device)
    elif cfg.scene == "bunny":
        scene, cam = procedural.bunny_scene(subdiv=cfg.scene_arg or 5, device=device)
    elif cfg.scene == "hall":
        scale = max(cfg.scene_arg, 0)
        scene, cam = procedural.columned_hall(
            cols_x=12 * (1 + scale), cols_z=8 * (1 + scale),
            blob_subdiv=4 + (1 if scale else 0), device=device)
    elif cfg.scene == "bench":
        scene, cam = procedural.bench_scene(device=device)
    elif cfg.scene == "soup":
        scene = procedural.random_tri_soup(cfg.scene_arg or 1024, device=device)
        cam = dict(position=(0.0, 0.5, 3.0), look_at=(0.0, 0.0, 0.0), fov_y_deg=45.0)
    else:
        raise ValueError(f"unknown scene '{cfg.scene}'")
    return scene, Camera.make(**cam, device=device)


def use_streamed_tier(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether make_render_fn renders (scene, cfg) through the streamed tier."""
    n_clusters = -(-scene.num_tris // CLUSTER_SIZE)
    return cfg.use_bvh and cfg.use_pallas and n_clusters > TILED_MAX_CLUSTERS


def build_tracers(scene: Scene, cfg: RenderConfig, accel=None):
    """The (trace_fn, occlude_fn) pair of a config: brute force without
    use_bvh; with use_bvh + use_pallas the sorted tracers up to
    TILED_MAX_CLUSTERS clusters and the streamed ones past it; with use_bvh
    alone the plain cluster tier. `accel` is the scene's cluster accel
    where the caller has one already; it is built here otherwise. Which of
    a kernel and its plain version runs follows from the tensors' device."""
    if not cfg.use_bvh:
        return make_brute_tracers(scene)
    if accel is None:
        accel = build_scene_accel(scene)
    if not cfg.use_pallas:
        return make_accel_tracers(scene, accel, use_pallas=False)
    if accel.num_clusters <= TILED_MAX_CLUSTERS:
        return make_sorted_tracers(scene, accel)
    return make_streamed_tracers(scene, accel)


def make_render_fn(scene: Scene, cfg: RenderConfig, device):
    """(scene, camera, with_aux=False, ensure_exact=False) -> image (H, W, 3)
    [, aux] on `device`.

    Routing: a use_bvh + use_pallas config renders through the tiled tier
    when its scene has at most TILED_MAX_CLUSTERS clusters (aux keys
    overflow, live_rays and its need_* sizes) and through the streamed tier
    when it has more (aux keys overflow, need_trace_k, need_occ_k, need_s).
    Every other config renders through the wavefront integrator over
    build_tracers(scene, cfg): brute force without use_bvh, the plain
    cluster tier with use_bvh alone (aux {"overflow": 0}: these tracers
    have no caps). The cluster accel is built when a new scene object
    arrives and reused across frames. Every frame is exact by construction
    (overflow 0), so ensure_exact, the reference's re-sizing request,
    changes nothing. Raises on a config the port cannot honour: a dtype
    other than float32, or profile=True."""
    if cfg.dtype != "float32" or cfg.profile:
        raise ValueError(f"the port renders in float32 with no profile option, got "
                         f"dtype={cfg.dtype!r}, profile={cfg.profile}")
    device = torch.device(device)
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    state = {"scene": None, "accel": None}

    def tiled_frame(scene, accel, camera):
        return render_tiled(scene, accel, camera, cfg.height, cfg.width, wcfg, with_aux=True)

    def streamed_frame(scene, accel, camera):
        trace_fn, occlude_fn = make_streamed_tracers_aux(scene, accel)
        rays = generate_rays(camera, cfg.height, cfg.width)
        return render_wavefront_aux(scene, rays, wcfg, trace_fn, occlude_fn)

    def wavefront_frame(scene, accel, camera):
        trace_fn, occlude_fn = build_tracers(scene, cfg, accel)
        rays = generate_rays(camera, cfg.height, cfg.width)
        return render_wavefront(scene, rays, wcfg, trace_fn, occlude_fn), {"overflow": 0}

    if not (cfg.use_bvh and cfg.use_pallas):
        frame = wavefront_frame
    elif use_streamed_tier(scene, cfg):
        frame = streamed_frame
    else:
        frame = tiled_frame

    def run(scene: Scene, camera: Camera, with_aux: bool = False, ensure_exact: bool = False):
        for name, x in (("scene", scene.verts), ("camera", camera.position)):
            if x.device.type != device.type:
                raise ValueError(f"{name} lives on {x.device}, the render fn on {device}")
        with torch.inference_mode():
            if state["scene"] is not scene:
                state["accel"] = build_scene_accel(scene) if cfg.use_bvh else None
                state["scene"] = scene
            img, aux = frame(scene, state["accel"], camera)
        return (img, aux) if with_aux else img

    run.state = state
    return run


def render(config: str | RenderConfig | None = None, *, device, **overrides) -> np.ndarray:
    """One-call render: config -> scene -> (H, W, 3) float32 numpy image."""
    cfg = config if isinstance(config, RenderConfig) else load_config(config, **overrides)
    scene, camera = get_scene(cfg, device)
    return make_render_fn(scene, cfg, device)(scene, camera).cpu().numpy()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(config: str | RenderConfig | None = None, iters: int = 10,
              warmup: int = 2, *, device="cuda", **overrides) -> dict:
    """Timed forward renders -> ms/frame and rays/s (the keys of
    tracer.api.benchmark, plus the device the frames ran on)."""
    device = torch.device(device)
    cfg = config if isinstance(config, RenderConfig) else load_config(config, **overrides)
    scene, camera = get_scene(cfg, device)
    run = make_render_fn(scene, cfg, device)
    for _ in range(max(warmup, 1)):
        run(scene, camera)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        img = run(scene, camera)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    _, aux = run(scene, camera, with_aux=True)
    primary_rays = cfg.height * cfg.width
    # Every traced wavefront: per bounce one closest-hit pass plus one
    # shadow pass per light. primary_rays_per_s counts the closest-hit
    # passes only; live_rays_per_s only rays actually traced (d != 0), and
    # is None for a tier that does not count them (all but the tiled one).
    rays_per_frame = primary_rays * cfg.max_bounces * (1 + scene.lights.count)
    live_rays = aux.get("live_rays")
    return {
        "config": cfg,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "rays_per_s": rays_per_frame / dt,
        "primary_rays_per_s": primary_rays * cfg.max_bounces / dt,
        "live_rays_per_s": None if live_rays is None else live_rays / dt,
        "num_tris": scene.num_tris,
        "overflow": aux["overflow"],
        "image": img.cpu().numpy(),
    }
