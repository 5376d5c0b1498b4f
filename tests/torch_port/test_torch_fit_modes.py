"""tracer_torch.diff.fit.make_loss_fn against the JAX package's on the CPU,
in each of its five modes: the loss and its gradients w.r.t. vert_offset
and albedo at the initial parameters, against a target rendered by the
reference from a scene whose vertices were moved (seeded, as
tests/grad/test_fit.py:_problem does). The cameras look at a point 0.0123
and 0.0071 off the presets' so that no pixel centre lies on a projected
edge of the box, where the directions' last bit (XLA's CPU rsqrt is not
1/sqrt) decides which wall a ray hits (ROADMAP Queue 3, brute-force
flips).

  replay, edge-aware brute: cornell256 at 16x16;
  edge-aware accel, jnp:    bunny-grad (subdiv 2) at 16x16;
  tiled:                    bunny-grad (subdiv 2) at 16x16 with use_pallas;
                            the reference through its tiled mode in
                            interpret mode (tracer.api._FORCE_TILED_INTERPRET,
                            as tests/grad/test_tiled_grad.py), the port's
                            kernels through their plain versions.

Gate: loss to rtol 1e-5; each gradient nonzero and to rtol 2e-3 of its
largest entry (plus rtol 2e-3 of the entry), as test_torch_grad.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer.api as japi
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.diff.fit import FitConfig as JFitConfig
from tracer.diff.fit import init_params as j_init_params
from tracer.diff.fit import make_loss_fn as j_make_loss_fn
from tracer.render.whitted import WhittedConfig as JWhittedConfig
from tracer.render.whitted import render_wavefront as j_render_wavefront
from tracer.utils.config import load_config as j_load_config
from tracer_torch.bridge import camera_from_arrays, scene_from_arrays
from tracer_torch.diff.fit import FitConfig, init_params, make_loss_fn
from tracer_torch.kernels import traversal2 as t2
from tracer_torch.utils.config import load_config

from parity_util import leaves

SIZE = dict(height=16, width=16)
MODES = {  # mode -> (preset, overrides, edge_aware)
    "replay": ("cornell256", {}, False),
    "edge brute": ("cornell256", {}, True),
    "edge accel": ("bunny-grad", {"scene_arg": 2}, True),
    "jnp": ("bunny-grad", {"scene_arg": 2}, False),
    "tiled": ("bunny-grad", {"scene_arg": 2, "use_pallas": True}, False),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small CPU ops: one intra-op thread, the caller's setting
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_target(j_cfg, j_scene, j_cam, seed: int = 0, sigma: float = 0.02):
    """The reference's frame of the scene with its vertices moved by a
    seeded normal offset (brute force or the plain cluster tier)."""
    rng = np.random.default_rng(seed)
    off = jnp.asarray(rng.normal(0, sigma, j_scene.verts.shape).astype(np.float32))
    s_true = dataclasses.replace(j_scene, verts=j_scene.verts + off)
    wcfg = JWhittedConfig(max_bounces=j_cfg.max_bounces, smooth_shading=j_cfg.smooth_shading)
    tracers = japi.build_tracers(s_true, j_cfg.replace(use_pallas=False))
    rays = j_generate_rays(j_cam, j_cfg.height, j_cfg.width)
    return np.array(j_render_wavefront(s_true, rays, wcfg, *tracers))


def problem(preset: str, over: dict, edge_aware: bool):
    """(j_cfg, cfg, fcfg, j_scene, j_cam, scene, camera, target) of a
    preset at 16x16 with `over` put in."""
    j_cfg, cfg = j_load_config(preset, **SIZE, **over), load_config(preset, **SIZE, **over)
    j_scene, j_cam = japi.get_scene(j_cfg)
    j_cam = dataclasses.replace(j_cam, look_at=j_cam.look_at + jnp.array([0.0123, 0.0071, 0.0]))
    fcfg = FitConfig(optimize_albedo=True, edge_aware=edge_aware)
    return (j_cfg, cfg, fcfg, j_scene, j_cam, scene_from_arrays(leaves(j_scene), "cpu"),
            camera_from_arrays(leaves(j_cam), "cpu"), j_target(j_cfg, j_scene, j_cam))


def j_loss_grads(j_cfg, fcfg, j_scene, j_cam, target):
    j_fcfg = JFitConfig(**dataclasses.asdict(fcfg))
    loss_fn = j_make_loss_fn(j_scene, j_cam, jnp.asarray(target), j_cfg, j_fcfg)
    params = j_init_params(j_scene, j_fcfg)
    (loss, overflow), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert int(overflow) == 0
    return float(loss), {k: np.asarray(g) for k, g in grads.items()}


def t_loss_grads(cfg, fcfg, scene, camera, target):
    loss_fn = make_loss_fn(scene, camera, torch.as_tensor(target), cfg, fcfg)
    params = init_params(scene, fcfg)
    loss, overflow = loss_fn(params)
    assert overflow == 0
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(params, grads)}


@pytest.mark.parametrize("mode", list(MODES))
def test_loss_fn_matches_reference(mode, monkeypatch):
    """Loss and gradients of one mode; the tiled mode is the only one that
    calls the traversal2 wrappers (the routing is observed, not assumed)."""
    j_cfg, cfg, fcfg, j_scene, j_cam, scene, camera, target = problem(*MODES[mode])
    if mode == "tiled":
        monkeypatch.setattr(japi, "_FORCE_TILED_INTERPRET", True)
        assert japi._use_tiled_path(j_scene, j_cfg)
    want_loss, want = j_loss_grads(j_cfg, fcfg, j_scene, j_cam, target)
    calls = []
    real = t2.trace_tiles_split

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr("tracer_torch.render.tiled.trace_tiles_split", spy)
    loss, got = t_loss_grads(cfg, fcfg, scene, camera, target)
    assert bool(calls) == (mode == "tiled")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(got) == set(want) == {"vert_offset", "albedo"}
    for key, b in want.items():
        a = got[key]
        assert np.abs(b).max() > 0 and np.abs(a).max() > 0, f"{mode} {key}: zero gradient"
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * np.abs(b).max(),
                                   err_msg=f"{mode} {key}")
