"""The scaling sweep (torch counterpart of tracer/dist/scaling.py): the
tile-DP accel render (ray_dp.make_sharded_accel_render_fn) timed on 1, 2,
4, ... ranks, one row a count with its rays/s and its efficiency against
the smallest count.

Each count k is a world of its own (mesh.spawn_world): k spawned ranks over
NCCL on cards 0 .. k-1, or over gloo on the CPU where the caller asks for
it (a proof of the harness whose times say nothing of a card). Each world
renders back to back, then synchronizes and meets at a barrier; rank 0
returns its row.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist


def default_device_counts(n: int) -> list[int]:
    """1, 2, 4, ... up to n, always including n itself."""
    counts = []
    k = 1
    while k < n:
        counts.append(k)
        k *= 2
    counts.append(n)
    return counts


def _time_world(rank: int, cfg, iters: int, warmup: int, device: str):
    """One world's row (on rank 0; None on the others): ms a frame of the
    sharded accel render at cfg over every rank on the data axis."""
    from tracer_torch.api import get_scene
    from tracer_torch.dist.mesh import make_render_mesh, mesh_device
    from tracer_torch.dist.ray_dp import make_sharded_accel_render_fn

    k = dist.get_world_size()
    mesh = make_render_mesh(data=k, geom=1, device=device)
    dev = mesh_device(mesh)
    scene, camera = get_scene(cfg, dev)
    run = make_sharded_accel_render_fn(scene, cfg, mesh)

    def settle():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    for _ in range(max(warmup, 1)):
        run(scene, camera)
    settle()
    t0 = time.perf_counter()
    for _ in range(iters):
        run(scene, camera)
    settle()
    dt = (time.perf_counter() - t0) / iters
    if rank:
        return None
    return {"dt": dt, "lights": scene.lights.count}


def scaling_sweep(cfg, device_counts: list[int] | None = None, iters: int = 3,
                  warmup: int = 1, device="cuda") -> list[dict]:
    """Time the sharded accel render at each count of ranks -> one dict a
    count: {devices, height, ms_per_frame, rays_per_s, efficiency}, with
    efficiency = rays/s / (devices x rays/s a rank at the smallest count).
    The height is rounded up to a multiple of each count (rays/s counts the
    height rendered). Default counts: default_device_counts of the visible
    cards (on the CPU: [1]). A count beyond the visible cards ends the sweep
    on the card."""
    from tracer_torch.dist.mesh import spawn_world

    kind = torch.device(device).type
    n = torch.cuda.device_count() if kind == "cuda" else None
    if kind == "cuda" and n == 0:
        raise RuntimeError("scaling_sweep on the card: CUDA is not available")
    counts = device_counts or default_device_counts(n or 1)
    rows: list[dict] = []
    base = None
    for k in counts:
        if n is not None and k > n:
            break
        h = -(-cfg.height // k) * k
        cfgk = cfg.replace(height=h)
        res = spawn_world(_time_world, k, cfgk, iters, warmup, kind, device=kind)[0]
        dt = res["dt"]
        rps = h * cfgk.width * cfgk.max_bounces * (1 + res["lights"]) / dt
        if base is None:
            base = rps / k  # a rank's rate at the smallest count
        rows.append({"devices": k, "height": h, "ms_per_frame": dt * 1e3,
                     "rays_per_s": rps, "efficiency": rps / (k * base)})
    return rows
