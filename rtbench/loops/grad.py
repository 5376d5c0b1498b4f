"""loop "grad": a closed loop of api.make_grad_step_fn's step (Adam on the
traffic's "params") toward one target image, the reference's frame of a
seeded perturbation of the scene. End-to-end: grad_step_ms (the window over
its steps).

The check: the program's first FIRST_STEPS steps, which warm it up, against
the reference's from the same start; and one more step after the window,
from the parameters and Adam state the window left, against one reference
step from that same state. Traffic keys: "camera" {"path": "fixed"},
"tiled", "params", "optimizer" {"name": "Adam", "lr"}, "target" (read by
generate.perturbed)."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from rtbench import checks, generate, harness, reference

FIRST_STEPS = 3


def make_target(arrays, spec: dict, seed: int, rcfg, device):
    """The fit's target image: the reference's frame of the seeded
    perturbation (pixels as the program lays them out, (H, W, 3))."""
    pert = generate.perturbed(arrays, spec, seed)
    scene = harness.reference_scene(arrays, device, normals=False, verts=pert["verts"],
                                    albedo=pert["albedo"])
    cam = harness.reference_camera(dict(arrays.camera, position=pert["cam_pos"]), device)
    with torch.no_grad():
        return reference.render_image(scene, cam, rcfg.height, rcfg.width, rcfg.max_bounces)


def image_mse(img, target):
    return torch.mean((img - target) ** 2)


def reference_steps(arrays, start: dict, state: dict | None, lr: float, target, rcfg, device,
                    n: int, tf32: bool = False, loss_fn=None) -> dict:
    """The reference's n steps with Adam(lr) from the parameters `start`
    {leaf: array} and, where given, the Adam state {leaf: {"step",
    "exp_avg", "exp_avg_sq"}}: {"losses", "grad1" (the first step's
    gradient), "change"} as checks.fit_numbers reads them."""
    start = {k: torch.as_tensor(v, device=device).detach().clone() for k, v in start.items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    opt = torch.optim.Adam(leaves.values(), lr=lr)
    for k, st in (state or {}).items():
        opt.state[leaves[k]] = {s: t.clone() for s, t in st.items()}
    base = harness.reference_scene(arrays, device, normals=False)
    losses, grad1 = [], None
    for j in range(n):
        opt.zero_grad(set_to_none=True)
        scene = dict(base, **{k: leaves[k] for k in ("verts", "albedo") if k in leaves})
        cam = harness.reference_camera(arrays.camera, device)
        if "cam_pos" in leaves:
            cam["position"] = leaves["cam_pos"]
        img = reference.render_image(scene, cam, rcfg.height, rcfg.width, rcfg.max_bounces,
                                     tf32)
        loss = (loss_fn or image_mse)(img, target)
        loss.backward()
        losses.append(float(loss.detach()))
        if j == 0:
            grad1 = {k: v.grad.detach().clone() for k, v in leaves.items()}
        opt.step()
    change = {k: leaves[k].detach() - start[k] for k in start}
    return {"losses": losses, "grad1": grad1, "change": change}


def initial_params(arrays, names) -> dict:
    init = {"verts": arrays.verts, "albedo": arrays.albedo,
            "cam_pos": np.asarray(arrays.camera["position"], np.float32)}
    return {k: init[k] for k in names}


def reference_fit(arrays, names, lr: float, target, rcfg, device, tf32: bool = False,
                  loss_fn=None) -> dict:
    """The reference's first FIRST_STEPS steps from the scene's own start."""
    return reference_steps(arrays, initial_params(arrays, names), None, lr, target, rcfg,
                           device, FIRST_STEPS, tf32, loss_fn)


def reference_late(arrays, at: dict, lr: float, target, rcfg, device, tf32: bool = False,
                   loss_fn=None) -> dict:
    """One reference step from the state `at` {"params", "state"} that the
    window left the program in."""
    return reference_steps(arrays, at["params"], at["state"], lr, target, rcfg, device, 1,
                           tf32, loss_fn)


def adam_grad(opt, leaf, exp_avg_before, beta1: float):
    """The gradient Adam took in its last step, from its first moment:
    exp_avg = beta1 * exp_avg_before + (1 - beta1) * grad."""
    return (opt.state[leaf]["exp_avg"].detach() - beta1 * exp_avg_before) / (1.0 - beta1)


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float) -> dict:
    from tracer_torch import api
    from tracer_torch.core.camera import Camera

    arrays = harness.scene_arrays(cell)
    scene = harness.program_scene(arrays, device)
    rcfg = harness.render_config(cell)
    harness.check_tier(cell, scene, rcfg)
    path = generate.camera_path(cell.traffic["camera"], arrays.camera, cell.root)
    if len(path) != 1:
        raise ValueError("a grad loop fits from one camera")
    camera = Camera.make(**path[0], device=device)
    opt_spec = cell.traffic["optimizer"]
    if opt_spec["name"] != "Adam":
        raise ValueError("the gradients are read back from Adam's state")
    # The target is the reference's (the benchmark's), not set-up.
    t_target = time.perf_counter()
    target = make_target(arrays, cell.traffic["target"], seed, rcfg, device)
    harness.sync(device)
    t_target = time.perf_counter() - t_target
    names = tuple(cell.traffic["params"])
    params = api.grad_params(scene, camera, names)
    opt = torch.optim.Adam(params.values(), lr=opt_spec["lr"])
    beta1 = opt.param_groups[0]["betas"][0]
    step = api.make_grad_step_fn(rcfg, scene, camera, cell.traffic["tiled"], device=device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    # The first steps: warm-up, and the readings the reference follows.
    init = {k: v.detach().clone() for k, v in params.items()}
    zero = {k: torch.zeros_like(v) for k, v in init.items()}
    losses, grad1, overflow = [], None, 0
    for j in range(FIRST_STEPS):
        loss, params, opt, aux = step(scene, camera, target, params, opt)
        losses.append(float(loss))
        overflow += aux["overflow"]
        if j == 0:
            grad1 = {k: adam_grad(opt, v, zero[k], beta1) for k, v in params.items()}
    change = {k: params[k].detach() - init[k] for k in names}
    prog = {"losses": losses, "grad1": grad1, "change": change}
    harness.sync(device)

    def call(i):
        nonlocal params, opt
        loss, params, opt, aux = step(scene, camera, target, params, opt)
        return aux

    def on_unit(i, aux):
        nonlocal overflow
        overflow += aux["overflow"]

    tracer = harness.make_tracer(cell, device) if trace else None
    setup_s = time.time() - t_process - t_target
    times, window_s = harness.window(call, seconds, device, tracer, on_unit)
    n = len(times)
    harness.log_units(times)
    metrics, profile = ({}, None)
    if trace:
        metrics, profile = harness.traced(cell, tracer, call, n, device)
    else:
        metrics = {"grad_step_ms": window_s / n * 1e3, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # One more step from the state the window left: the reference follows it.
    at = {"params": {k: v.detach().clone() for k, v in params.items()},
          "state": {k: {s: t.clone() for s, t in opt.state[v].items()}
                    for k, v in params.items()}}
    loss, params, opt, aux = step(scene, camera, target, params, opt)
    overflow += aux["overflow"]
    late = {"losses": [float(loss)],
            "grad1": {k: adam_grad(opt, v, at["state"][k]["exp_avg"], beta1)
                      for k, v in params.items()},
            "change": {k: params[k].detach() - at["params"][k] for k in names}}
    del step, params, opt, scene
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_fit(arrays, names, opt_spec["lr"], target, rcfg, device)
    late_ref = reference_late(arrays, at, opt_spec["lr"], target, rcfg, device)
    harness.log(f"target {t_target:.3f} s, setup {setup_s:.3f} s, window {window_s:.3f} s "
                f"({n} steps), reference {time.perf_counter() - t_ref:.3f} s")
    values = dict(checks.fit_numbers(prog, ref), **checks.late_numbers(late, late_ref),
                  overflow=overflow)
    ok, judged = checks.judge(values, cell.limits)
    return {"correct": ok, "attempted": n, "failed": 0, "metrics": metrics, "peak": peak,
            "profile": profile, "checks": judged,
            "extras": {"prog": prog, "ref": ref, "late": late, "late_ref": late_ref, "at": at,
                       "arrays": arrays, "target": target, "rcfg": rcfg, "names": names,
                       "lr": opt_spec["lr"], "times": times, "window_s": window_s}}
