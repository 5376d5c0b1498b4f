"""The rank functions of the torch port's distributed tests
(tests/torch_port/test_torch_dist_*.py). Each runs on every rank of a world
that tracer_torch.dist.mesh.spawn_world spawns over gloo, builds the port's
scene and camera from the numpy arrays the test took from the JAX package,
runs its cases and returns numpy results. This module imports torch, numpy
and tracer_torch only, so that the spawned ranks never import JAX."""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from tracer_torch.bridge import camera_from_arrays, scene_from_arrays
from tracer_torch.dist import grad_overlap, ray_dp, ring, ulysses
from tracer_torch.dist.mesh import DATA_AXIS, GEOM_AXIS, make_render_mesh


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _scene_cam(scene, camera):
    return scene_from_arrays(scene, "cpu"), camera_from_arrays(camera, "cpu")


def _errors(fn, *args, **kwargs) -> str | None:
    """The message of the exception fn raises (None if it returns)."""
    try:
        fn(*args, **kwargs)
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def mesh_world(rank, layouts):
    """For each (data, geom): this rank's mesh coordinates and the global
    ranks of its data and geom groups; then the refusals of a mesh that does
    not fit the world and of a CUDA mesh over gloo."""
    out = {}
    for data, geom in layouts:
        mesh = make_render_mesh(data, geom, device="cpu")
        out[(data, geom)] = (mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(GEOM_AXIS),
                             dist.get_process_group_ranks(mesh.get_group(DATA_AXIS)),
                             dist.get_process_group_ranks(mesh.get_group(GEOM_AXIS)))
    out["misfit"] = _errors(make_render_mesh, 3, 3, device="cpu")
    out["cuda"] = _errors(make_render_mesh, device="cuda")
    return out


def dying_world(rank, how):
    """Rank 1 leaves (os._exit) or raises while rank 0 waits in a collective."""
    import os

    if rank == 1:
        if how == "exit":
            os._exit(3)
        raise ValueError("rank 1 raised on purpose")
    dist.all_reduce(torch.ones(1))


class _CountingAllToAll:
    """dist.all_to_all_single, counted."""

    def __init__(self):
        self.calls = 0
        self.inner = dist.all_to_all_single

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)


def ulysses_world(rank, key, a, b, spread_key, scene, camera, cfg):
    """The re-shard of this rank's rows of (key, a, b) over a data group of
    every rank (resharded a, b and the restored results of a * 2, b + 7),
    the key spread before and after on spread_key, and the resharded-bounce
    render against the band render at cfg (with the number of exchanges)."""
    n = dist.get_world_size()
    mesh = make_render_mesh(data=n, geom=1, device="cpu")
    group = mesh.get_group(DATA_AXIS)
    r = key.shape[0] // n
    mine = slice(rank * r, (rank + 1) * r)
    k, ta, tb = (torch.as_tensor(x[mine]) for x in (key, a, b))
    (a2, b2), restore = ulysses.reshard_by_key(k, [ta, tb], group)
    ra, rb = restore([a2 * 2.0, b2 + 7])
    r2 = spread_key.shape[0] // n
    sk = torch.as_tensor(spread_key[rank * r2:(rank + 1) * r2])
    (k2,), _ = ulysses.reshard_by_key(sk, [sk], group)
    out = {"a2": _np(a2), "b2": _np(b2), "ra": _np(ra), "rb": _np(rb),
           "spread": (int(sk.max() - sk.min()), int(k2.max() - k2.min()))}

    s, cam = _scene_cam(scene, camera)
    out["plain"] = _np(ray_dp.make_sharded_accel_render_fn(s, cfg, mesh)(s, cam))
    counter = _CountingAllToAll()
    dist.all_to_all_single = counter
    try:
        out["resharded"] = _np(ray_dp.make_sharded_accel_render_fn(
            s, cfg, mesh, reshard_bounces=True)(s, cam))
    finally:
        dist.all_to_all_single = counter.inner
    out["exchanges"] = counter.calls
    return out


def ray_dp_world(rank, scene, camera, cam_off, target, cfg, cfg_odd, cfg_accel):
    """Tile DP at world n: the brute sharded render at cfg and at cfg_odd (a
    height the data size does not divide), shard_rays' band, the accel
    render at cfg_accel (the plain cluster tier), the sharded grad step from
    cam_off against target, and dryrun."""
    from tracer_torch.core.camera import generate_rays

    n = dist.get_world_size()
    mesh = make_render_mesh(data=n, geom=1, device="cpu")
    s, cam = _scene_cam(scene, camera)
    out = {"brute": _np(ray_dp.make_sharded_render_fn(s, cfg, mesh)(s, cam)),
           "odd": _np(ray_dp.make_sharded_render_fn(s, cfg_odd, mesh)(s, cam)),
           "accel": _np(ray_dp.make_sharded_accel_render_fn(s, cfg_accel, mesh)(s, cam))}
    band = ray_dp.shard_rays(generate_rays(cam, cfg_odd.height, cfg_odd.width), mesh)
    out["band"] = _np(band.o), _np(band.d)
    _, cam2 = _scene_cam(scene, cam_off)
    loss, grads = ray_dp.make_sharded_grad_fn(s, cfg, mesh)(s, cam2, torch.as_tensor(target))
    out["loss"], out["grads"] = float(loss), _np(grads)
    made = []
    make_ring_render_fn = ring.make_ring_render_fn
    ring.make_ring_render_fn = lambda *a, **k: made.append(k) or make_ring_render_fn(*a, **k)
    try:
        ray_dp.dryrun("cpu")
    finally:
        ring.make_ring_render_fn = make_ring_render_fn
    out["dryrun_ring"] = made
    return out


def grad_overlap_world(rank, scene, camera, target, cfg, cfg_accel):
    """The bucketed grad step (B = 4), the unbucketed one, and the bucketed
    one (B = 2) over the accel tracers of cfg_accel."""
    from tracer_torch.api import build_tracers

    n = dist.get_world_size()
    mesh = make_render_mesh(data=n, geom=1, device="cpu")
    s, cam = _scene_cam(scene, camera)
    tgt = torch.as_tensor(target)
    out = {}
    for name, fn in (
            ("bucketed", grad_overlap.make_overlapped_grad_fn(cfg, mesh, n_buckets=4)),
            ("unbucketed", grad_overlap.make_unbucketed_grad_fn(cfg, mesh)),
            ("accel", grad_overlap.make_overlapped_grad_fn(
                cfg_accel, mesh, n_buckets=2,
                tracer_builder=partial(build_tracers, cfg=cfg_accel)))):
        loss, grads = fn(s, cam, tgt)
        out[name] = float(loss), _np(grads)
    return out


def ring_world(rank, scenes, cases):
    """make_ring_render_fn for each case (scene name, (data, geom), use_ring,
    use_accel, k_cap) of `cases`, scenes[name] = (scene arrays, camera
    arrays, config) -> {case: (image, overflow)}."""
    built = {name: (*_scene_cam(sc, cam), cfg) for name, (sc, cam, cfg) in scenes.items()}
    meshes, out = {}, {}
    for case in cases:
        name, layout, use_ring, use_accel, k_cap = case
        if layout not in meshes:
            meshes[layout] = make_render_mesh(*layout, device="cpu")
        s, cam, cfg = built[name]
        run = ring.make_ring_render_fn(s, cfg, meshes[layout], use_ring=use_ring,
                                       use_accel=use_accel, with_aux=True, k_cap=k_cap)
        img, aux = run(s, cam)
        out[case] = _np(img), aux["overflow"]
    return out
