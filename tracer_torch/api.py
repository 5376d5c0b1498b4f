"""User-facing API: get_scene / make_render_fn / render / benchmark (torch
counterpart of tracer/api.py, tiled path only).

The reference recompiles its tiled frame until static candidate caps are
wide enough (a sizing loop with a persisted caps cache), because XLA needs
static shapes. Here each pass reads its needs and runs at exactly that size,
so every frame is exact by construction and there is nothing to size.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from tracer_torch.bvh.cluster import build_scene_accel
from tracer_torch.core.camera import Camera
from tracer_torch.render.tiled import render_tiled
from tracer_torch.render.whitted import WhittedConfig
from tracer_torch.scene import procedural
from tracer_torch.scene.types import Scene
from tracer_torch.utils.config import RenderConfig, load_config


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


def make_render_fn(scene: Scene, cfg: RenderConfig, device):
    """(scene, camera, with_aux=False) -> image (H, W, 3) [, aux] on
    `device`. The cluster accel is built when a new scene object arrives
    and reused across frames. Raises on a config the port cannot honour:
    a dtype other than float32, or profile=True."""
    if cfg.dtype != "float32" or cfg.profile:
        raise ValueError(f"the port renders in float32 with no profile option, got "
                         f"dtype={cfg.dtype!r}, profile={cfg.profile}")
    device = torch.device(device)
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    state = {"scene": None, "accel": None}

    def run(scene: Scene, camera: Camera, with_aux: bool = False):
        for name, x in (("scene", scene.verts), ("camera", camera.position)):
            if x.device.type != device.type:
                raise ValueError(f"{name} lives on {x.device}, the render fn on {device}")
        with torch.inference_mode():
            if state["scene"] is not scene:
                state["accel"] = build_scene_accel(scene)
                state["scene"] = scene
            img, aux = render_tiled(scene, state["accel"], camera, cfg.height,
                                    cfg.width, wcfg, with_aux=True)
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
    # passes only; live_rays_per_s only rays actually traced (d != 0).
    rays_per_frame = primary_rays * cfg.max_bounces * (1 + scene.lights.count)
    return {
        "config": cfg,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "rays_per_s": rays_per_frame / dt,
        "primary_rays_per_s": primary_rays * cfg.max_bounces / dt,
        "live_rays_per_s": aux["live_rays"] / dt,
        "num_tris": scene.num_tris,
        "overflow": aux["overflow"],
        "image": img.cpu().numpy(),
    }
