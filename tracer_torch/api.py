"""User-facing API: get_scene / build_tracers / make_render_fn / render /
benchmark, and the grad step: make_grad_step_fn / grad_step /
benchmark_grad_step, over image_loss, the loss body that diff.fit shares
(torch counterpart of tracer/api.py).

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

make_render_fn's frames are inference-only. The differentiable entry points
are make_grad_step_fn and render_tiled / render_wavefront called directly.
"""
from __future__ import annotations

import dataclasses
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
from tracer_torch.scene.io import load_obj
from tracer_torch.scene.types import (
    Scene, compute_vertex_normals_torch, make_vertex_normal_fn)
from tracer_torch.utils.config import RenderConfig, load_config
from tracer_torch.utils.metrics import profile_trace, span

# Clusters (of CLUSTER_SIZE triangles) up to which a use_bvh + use_pallas
# config renders through the tiled tier; past it, through the streamed one.
# The reference's _VMEM_RESIDENT_CLUSTERS (tracer/api.py:64).
TILED_MAX_CLUSTERS = 2048


def get_scene(cfg: RenderConfig, device) -> tuple[Scene, Camera]:
    """Resolve the scene + canonical camera named by the config; an
    obj:<path> scene is loaded by scene.io.load_obj."""
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
    elif cfg.scene.startswith("obj:"):
        scene = load_obj(cfg.scene[4:], device=device)
        verts = scene.verts.cpu().numpy()
        lo, hi = verts.min(0), verts.max(0)
        c = (lo + hi) / 2
        # The bounding box's centre, seen from (0, 0.3, 1.2) times its diagonal.
        cam = dict(position=tuple(c + np.array([0.0, 0.3, 1.2]) * np.linalg.norm(hi - lo)),
                   look_at=tuple(c), fov_y_deg=45.0)
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


def _check_dtype(cfg: RenderConfig):
    if cfg.dtype != "float32":
        raise ValueError(f"the port renders in float32, got dtype={cfg.dtype!r}")


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
    arrives and reused across frames. The frame is rendered under
    torch.inference_mode(), so its image cannot enter autograd: the
    differentiable entry points are make_grad_step_fn, and render_tiled and
    render_wavefront called directly. Every frame is exact by construction
    (overflow 0), so ensure_exact, the reference's re-sizing request,
    changes nothing. Raises on a dtype other than float32, which the port
    cannot honour."""
    _check_dtype(cfg)
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
        with torch.inference_mode(), span("frame"):
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
    tracer.api.benchmark, plus the device the frames ran on). With
    cfg.profile the timed loop runs under utils.metrics.profile_trace, which
    writes a Chrome trace (trace.json) into $TRACER_PROFILE_DIR."""
    device = torch.device(device)
    cfg = config if isinstance(config, RenderConfig) else load_config(config, **overrides)
    scene, camera = get_scene(cfg, device)
    run = make_render_fn(scene, cfg, device)
    for _ in range(max(warmup, 1)):
        run(scene, camera)
    _sync(device)
    with profile_trace(cfg.profile):
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


# ---------------------------------------------------------------------------
# The grad step
# ---------------------------------------------------------------------------

GRAD_PARAMS = ("verts", "albedo", "cam_pos")


def _apply_grad_params(scene: Scene, camera: Camera, p: dict, normal_fn=None):
    """(scene, camera) with the optimized families of `p` put in: "verts"
    (and the vertex normals recomputed from them, so that smooth shading
    follows the vertices: by `normal_fn`, make_vertex_normal_fn's gather,
    where given, by compute_vertex_normals_torch's scatter otherwise),
    "albedo", "cam_pos"."""
    s = scene
    with span("grad.params"):
        if "verts" in p:
            normals = (normal_fn(p["verts"]) if normal_fn is not None
                       else compute_vertex_normals_torch(p["verts"], s.tris))
            s = dataclasses.replace(s, verts=p["verts"], normals=normals)
        if "albedo" in p:
            s = dataclasses.replace(s, materials=dataclasses.replace(s.materials,
                                                                     albedo=p["albedo"]))
        cam = camera
        if "cam_pos" in p:
            cam = dataclasses.replace(cam, position=p["cam_pos"])
    return s, cam


def use_tiled_grad(scene: Scene | None, cfg: RenderConfig, tiled: str) -> bool:
    """Whether make_grad_step_fn(cfg, scene, tiled=tiled) differentiates
    through the tiled tier: always for "interpret", never for "off", and for
    "auto" where make_render_fn would render the scene through it."""
    if tiled not in ("auto", "interpret", "off"):
        raise ValueError(f"tiled must be 'auto', 'interpret' or 'off', got {tiled!r}")
    if tiled == "auto":
        return (scene is not None and cfg.use_bvh and cfg.use_pallas
                and not use_streamed_tier(scene, cfg))
    return tiled == "interpret"


def image_loss(scene: Scene, camera: Camera, target: torch.Tensor, cfg: RenderConfig,
               tiled: bool, tracers=None):
    """(loss, overflow) of one frame of (scene, camera) under autograd: the
    image MSE mean((img - target)**2), the one loss body of
    make_grad_step_fn's two tiers and of diff.fit's tiled, replay and jnp
    modes.

    tiled: render_tiled over an accel built here from `scene` (its shade
    rows are functions of the optimized parameters), the overflow from its
    aux (0 by construction). Otherwise render_wavefront over
    tracers(scene) -> (trace_fn, occlude_fn), by default build_tracers of
    the config with use_pallas off (the plain cluster tier with use_bvh,
    brute force without; no kernel), and an overflow of 0."""
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    if tiled:
        with span("grad.accel"):
            accel = build_scene_accel(scene)
        img, aux = render_tiled(scene, accel, camera, cfg.height, cfg.width, wcfg,
                                with_aux=True)
        overflow = aux["overflow"]
    else:
        if tracers is None:
            cfg_plain = cfg.replace(use_pallas=False)
            tracers = lambda s: build_tracers(s, cfg_plain)  # noqa: E731
        img = render_wavefront(scene, generate_rays(camera, cfg.height, cfg.width), wcfg,
                               *tracers(scene))
        overflow = 0
    with span("grad.loss"):
        return torch.mean((img - target) ** 2), overflow


def make_grad_step_fn(cfg: RenderConfig, scene: Scene | None = None,
                      camera: Camera | None = None, tiled: str = "auto", *, device):
    """(scene, camera, target, params, optimizer) -> (loss, params, optimizer,
    {"overflow": 0}): one optimization step of the image MSE
    mean((img - target)**2) with respect to `params`, a dict of leaf tensors
    that require grad, with optional keys "verts", "albedo" and "cam_pos".
    `optimizer` is a torch.optim.Optimizer over params.values(): the step
    zeroes its gradients, runs the loss, calls backward and steps it, which
    updates the params in place; it returns them and the optimizer so that
    callers map one for one onto the reference's four slots. The loss comes
    back detached.

    tiled:
      * "auto": the tiled tier (render/tiled.py: the traversal2 kernels for
        selection on detached inputs, gradients through the shade-row
        recompute) where make_render_fn would route `scene` to it (use_bvh
        and use_pallas, at most TILED_MAX_CLUSTERS clusters; `scene` must be
        given); the jnp tier otherwise;
      * "interpret": the tiled tier always. On CPU tensors its kernels run
        their plain versions, the port's counterpart of the reference's
        interpret mode; on CUDA tensors they launch;
      * "off": the jnp tier: render_wavefront over build_tracers of the
        config with use_pallas off (the plain cluster tier with use_bvh,
        brute force without), no kernel.
    The reference routes "auto" to the tiled tier only on a TPU backend;
    here the config decides, as for make_render_fn. The tiled tier builds
    the accel inside the loss each step (its shade rows are functions of the
    params) and takes no caps: sizes are read at run time, so overflow is 0
    by construction, and `camera`, which the reference's cap sizing
    renders from, is taken for its signature only. Vertex normals follow
    the vertices through make_vertex_normal_fn's gather in the tiled tier
    when `scene` is given, through compute_vertex_normals_torch's scatter
    otherwise."""
    _check_dtype(cfg)
    device = torch.device(device)
    tiled_tier = use_tiled_grad(scene, cfg, tiled)
    normal_fn = None
    if tiled_tier and scene is not None:
        normal_fn = make_vertex_normal_fn(scene.tris.cpu().numpy(), scene.verts.shape[0],
                                          device=device)

    def loss_fn(scene, camera, target, p):
        s, cam = _apply_grad_params(scene, camera, p, normal_fn)
        return image_loss(s, cam, target, cfg, tiled_tier)

    def step(scene: Scene, camera: Camera, target: torch.Tensor, params: dict, optimizer):
        for name, x in (("scene", scene.verts), ("camera", camera.position),
                        ("target", target), *params.items()):
            if x.device.type != device.type:
                raise ValueError(f"{name} lives on {x.device}, the grad step on {device}")
        with span("grad.step"):
            with span("grad.zero"):
                optimizer.zero_grad(set_to_none=True)
            loss, overflow = loss_fn(scene, camera, target, params)
            with span("grad.backward"):
                loss.backward()
            with span("grad.adam"):
                optimizer.step()
        return loss.detach(), params, optimizer, {"overflow": overflow}

    return step


def grad_params(scene: Scene, camera: Camera, names=("verts",)) -> dict:
    """Fresh leaf tensors that require grad for the named families, copied
    from the scene and camera (which the optimizer then leaves alone)."""
    unknown = set(names) - set(GRAD_PARAMS)
    if unknown:
        raise ValueError(f"unknown parameter families {sorted(unknown)}; known: {GRAD_PARAMS}")
    src = {"verts": scene.verts, "albedo": scene.materials.albedo,
           "cam_pos": camera.position}
    return {k: src[k].detach().clone().requires_grad_(True) for k in names}


def grad_step(scene: Scene, camera: Camera, target: torch.Tensor, cfg: RenderConfig,
              optimizer=None, params: dict | None = None, *, device):
    """One optimization step (a convenience wrapper over make_grad_step_fn,
    routed by the config with tiled="auto") -> (loss, params, optimizer).
    Defaults: params {"verts": a copy of scene.verts}, optimizer
    torch.optim.Adam(lr=1e-3) over them. The reference keeps a cache of
    compiled steps and reads the overflow every 16th call; both answer the
    cost of jit compiles, which the port does not have, so neither is here:
    this wrapper builds its step on each call, and a loop should hold
    make_grad_step_fn's step itself. Overflow is 0 by construction."""
    if params is None:
        params = grad_params(scene, camera)
    if optimizer is None:
        optimizer = torch.optim.Adam(params.values(), lr=1e-3)
    step = make_grad_step_fn(cfg, scene, camera, device=device)
    loss, params, optimizer, _aux = step(scene, camera, target, params, optimizer)
    return loss, params, optimizer


def benchmark_grad_step(config: str | RenderConfig | None = "bunny-grad", iters: int = 5,
                        warmup: int = 1, params: tuple = ("verts",), tiled: str = "auto", *,
                        device="cuda", **overrides) -> dict:
    """Timed optimization steps (loss, backward, Adam(1e-3) update) against
    a zeros target -> {"grad_step_ms", "loss", "overflow", "config",
    "device"}. `params` names the optimized families ("verts", "albedo",
    "cam_pos"); `tiled` as for make_grad_step_fn. The loop is timed on the
    host clock between two synchronizes of the device."""
    device = torch.device(device)
    cfg = config if isinstance(config, RenderConfig) else load_config(config, **overrides)
    scene, camera = get_scene(cfg, device)
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=device)
    p = grad_params(scene, camera, params)
    optimizer = torch.optim.Adam(p.values(), lr=1e-3)
    step = make_grad_step_fn(cfg, scene, camera, tiled, device=device)
    for _ in range(max(warmup, 1)):
        loss, p, optimizer, aux = step(scene, camera, target, p, optimizer)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, p, optimizer, aux = step(scene, camera, target, p, optimizer)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    return {"grad_step_ms": dt * 1e3, "loss": float(loss), "overflow": int(aux["overflow"]),
            "config": cfg,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
