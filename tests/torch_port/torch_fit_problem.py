"""A fit problem in torch alone, for the fit tests' child processes, which
must not import JAX: the cornell box at 16x16 from a camera looking 0.0123
and 0.0071 off the preset's point, and a target rendered by tracer_torch
from the box with its vertices moved by a seeded normal offset."""
import dataclasses

import numpy as np
import torch

from tracer_torch.api import get_scene
from tracer_torch.core.camera import generate_rays
from tracer_torch.render.whitted import WhittedConfig, make_brute_tracers, render_wavefront
from tracer_torch.utils.config import load_config

CFG = load_config("cornell256", height=16, width=16)


def torch_problem():
    """(scene, camera, target) on the CPU."""
    scene, cam = get_scene(CFG, "cpu")
    cam = dataclasses.replace(cam, look_at=cam.look_at + torch.tensor([0.0123, 0.0071, 0.0]))
    off = np.random.default_rng(0).normal(0, 0.02, tuple(scene.verts.shape)).astype(np.float32)
    s_true = dataclasses.replace(scene, verts=scene.verts + torch.as_tensor(off))
    wcfg = WhittedConfig(max_bounces=CFG.max_bounces, smooth_shading=CFG.smooth_shading)
    with torch.no_grad():
        target = render_wavefront(s_true, generate_rays(cam, CFG.height, CFG.width), wcfg,
                                  *make_brute_tracers(s_true))
    return scene, cam, target
