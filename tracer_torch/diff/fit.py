"""Inverse-rendering optimization loop with checkpoint/resume (torch
counterpart of tracer/diff/fit.py).

Scene parameters (an offset added to the vertices, and optionally a
replacement albedo table) are recovered from a target image by gradient
descent on the image MSE through the renderer. The optimizer's state is
checkpointed, so a run that is killed resumes from its last checkpoint.

make_loss_fn picks one of five modes, in the reference's order:
  * tiled: without edge_aware, where api.use_tiled_grad(scene, cfg, "auto")
    holds (use_bvh + use_pallas, at most api.TILED_MAX_CLUSTERS clusters):
    render_tiled, its three traversal2 kernels on detached selection inputs;
  * edge-aware accel: edge_aware with use_bvh (diff/edge_accel.py);
  * edge-aware brute: edge_aware without use_bvh (diff/edge.py);
  * replay: without use_bvh, the brute-force tracers with the replayed
    nearest hit (diff/vjp.py);
  * jnp: otherwise, the plain cluster tier (use_pallas off).
The reference takes the tiled mode only on a TPU; here the config decides,
as it does for api.make_render_fn. Only the tiled mode launches kernels.
"""
from __future__ import annotations

import dataclasses as dc
import os
import sys

import torch

from tracer_torch.api import image_loss, use_tiled_grad
from tracer_torch.core.camera import Camera, generate_rays
from tracer_torch.diff.edge import render_diff
from tracer_torch.diff.edge_accel import render_diff_accel
from tracer_torch.diff.vjp import make_replay_tracers
from tracer_torch.render.whitted import WhittedConfig
from tracer_torch.scene.types import Scene, make_vertex_normal_fn
from tracer_torch.utils.config import RenderConfig


@dc.dataclass(frozen=True)
class FitConfig:
    steps: int = 200
    learning_rate: float = 1e-2
    optimize_verts: bool = True
    optimize_albedo: bool = False
    edge_aware: bool = False        # silhouette gradients: diff.edge_accel
    #                                 with cfg.use_bvh, diff.edge without
    edge_eps: float = 1e-2
    edge_clusters: int = 2          # k nearest candidate clusters (accel tier)
    checkpoint_every: int = 25
    checkpoint_dir: str = ""        # empty = no checkpointing


def _apply_params(scene: Scene, params: dict, normal_fn) -> Scene:
    """The scene with the parameters put in: vertices moved by
    "vert_offset" (and the vertex normals recomputed from them by
    normal_fn, so that smooth shading follows the vertices), the albedo
    table replaced by "albedo"."""
    if "vert_offset" in params:
        verts = scene.verts + params["vert_offset"]
        scene = dc.replace(scene, verts=verts, normals=normal_fn(verts))
    if "albedo" in params:
        scene = dc.replace(scene, materials=dc.replace(scene.materials,
                                                       albedo=params["albedo"]))
    return scene


def init_params(scene: Scene, fcfg: FitConfig) -> dict:
    """Leaf tensors that require grad, on the scene's device: "vert_offset"
    zeros, "albedo" a copy of the scene's table."""
    params = {}
    if fcfg.optimize_verts:
        params["vert_offset"] = torch.zeros_like(scene.verts)
    if fcfg.optimize_albedo:
        params["albedo"] = scene.materials.albedo.detach().clone()
    return {k: v.requires_grad_(True) for k, v in params.items()}


def make_loss_fn(scene: Scene, camera: Camera, target: torch.Tensor, cfg: RenderConfig,
                 fcfg: FitConfig):
    """params -> (loss, overflow): the image MSE against `target` through
    the mode the configs pick (see the module docstring)."""
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    tiled = not fcfg.edge_aware and use_tiled_grad(scene, cfg, "auto")
    normal_fn = make_vertex_normal_fn(scene.tris.cpu().numpy(), scene.verts.shape[0],
                                      device=scene.verts.device)

    def loss_fn(params):
        s = _apply_params(scene, params, normal_fn)
        if tiled:
            return image_loss(s, camera, target, cfg, tiled=True)
        if fcfg.edge_aware:
            rays = generate_rays(camera, cfg.height, cfg.width)
            if cfg.use_bvh:
                img = render_diff_accel(s, rays, wcfg, edge_eps=fcfg.edge_eps,
                                        k_edge=fcfg.edge_clusters)
            else:
                img = render_diff(s, rays, wcfg, edge_eps=fcfg.edge_eps)
            return torch.mean((img - target) ** 2), 0
        if not cfg.use_bvh:
            return image_loss(s, camera, target, cfg, tiled=False, tracers=make_replay_tracers)
        return image_loss(s, camera, target, cfg, tiled=False)

    return loss_fn


def save_checkpoint(ckpt_dir: str, step: int, params: dict, optimizer) -> None:
    """{step, params, optimizer state} -> ckpt_dir/step_N (N = step, 8
    digits), written as step_N.tmp and then renamed: a process killed while
    it writes never leaves a step_N that latest_checkpoint would take."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")
    tmp = path + ".tmp"
    state = {"step": step, "params": {k: v.detach().cpu() for k, v in params.items()},
             "optimizer": optimizer.state_dict()}
    with open(tmp, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def latest_checkpoint(ckpt_dir: str):
    """(step, path) of the newest complete checkpoint, or (None, None)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None, None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name[5:].isdigit():
            steps.append((int(name[5:]), os.path.join(ckpt_dir, name)))
    return max(steps) if steps else (None, None)


def restore_checkpoint(path: str, device) -> dict:
    """A checkpoint written by save_checkpoint, its tensors on `device`."""
    return torch.load(path, map_location=device, weights_only=True)


def _adam(params, lr: float):
    return torch.optim.Adam(params, lr=lr, eps=1e-8)


def fit(scene: Scene, camera: Camera, target: torch.Tensor, cfg: RenderConfig,
        fcfg: FitConfig = FitConfig(), optimizer=None, log_every: int = 0, metrics=None):
    """Run (or resume) the optimization -> (params, losses): the
    parameters (detached) and the loss of each step run here, each before
    that step's update.

    Everything runs on the device of the scene's tensors. `optimizer` is a
    factory (parameter list, learning rate) -> torch.optim.Optimizer, by
    default Adam with eps 1e-8 (optax.adam's defaults). If
    fcfg.checkpoint_dir holds a checkpoint, the run continues from the step
    after it with its parameters and optimizer state; a checkpoint is
    written every fcfg.checkpoint_every steps and after the last step.
    `metrics` (utils.metrics.MetricsLogger) gets one record a step."""
    device = scene.verts.device
    params = init_params(scene, fcfg)
    opt = (optimizer or _adam)(list(params.values()), fcfg.learning_rate)
    start_step = 0
    step_no, path = latest_checkpoint(fcfg.checkpoint_dir)
    if step_no is not None:
        state = restore_checkpoint(path, device)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(state["params"][k])
        opt.load_state_dict(state["optimizer"])
        start_step = int(state["step"]) + 1

    loss_fn = make_loss_fn(scene, camera, target, cfg, fcfg)
    losses = []
    warned = False
    for step in range(start_step, fcfg.steps):
        opt.zero_grad(set_to_none=True)
        loss, overflow = loss_fn(params)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if not warned and int(overflow) != 0:
            print(f"[fit] WARNING: step {step} dropped {int(overflow)} cull candidates; "
                  f"gradients are on truncated geometry", file=sys.stderr)
            warned = True
        if metrics is not None:
            metrics.log(step=step, loss=losses[-1])
        if log_every and step % log_every == 0:
            print(f"[fit] step {step:5d}  loss {losses[-1]:.6g}", flush=True)
        if (fcfg.checkpoint_dir and fcfg.checkpoint_every
                and (step + 1) % fcfg.checkpoint_every == 0):
            save_checkpoint(fcfg.checkpoint_dir, step, params, opt)
    if fcfg.checkpoint_dir and fcfg.steps > start_step:
        save_checkpoint(fcfg.checkpoint_dir, fcfg.steps - 1, params, opt)
    return {k: v.detach() for k, v in params.items()}, losses
