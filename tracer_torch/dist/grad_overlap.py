"""Bucketed gradient all-reduce overlapped with the backward passes (torch
counterpart of tracer/dist/grad_overlap.py).

Each rank's band of image rows is split into B buckets. For each bucket in
turn: the forward pass, torch.autograd.grad with respect to the vertices,
then dist.all_reduce of that bucket's gradient issued at once with
async_op=True, so that it runs (on NCCL's own stream, or gloo's thread)
while the next bucket's forward and backward occupy the device. Every
handle is waited on before the buckets' gradients are summed. XLA's
scheduler supplies this overlap in the reference; here it is explicit.

Each bucket's gradient is all-reduced exactly once: a second reduction
would multiply it by the data size (the reference's comment records that
bug).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tracer_torch.core.camera import Camera
from tracer_torch.dist.ray_dp import _data_coords, band_grad
from tracer_torch.render.whitted import make_brute_tracers
from tracer_torch.scene.types import Scene


def make_overlapped_grad_fn(cfg, mesh, n_buckets: int = 4, tracer_builder=None):
    """(scene, camera, target) -> (loss, d loss / d verts), the same on
    every rank. The loss is the global image MSE; rows are split over the
    data axis (H / data a rank) and each rank runs n_buckets forward and
    backward passes over H / (data * n_buckets) rows each, all-reducing
    each bucket's vertex gradient as soon as it exists. builder(scene)
    gives the tracers (default: brute force)."""
    builder = tracer_builder or make_brute_tracers
    n_data, i, group = _data_coords(mesh)
    if cfg.height % (n_data * n_buckets):
        raise ValueError(f"height {cfg.height} not divisible by data axis {n_data} x "
                         f"buckets {n_buckets}")
    rows = cfg.height // n_data
    bh = rows // n_buckets

    def step(scene: Scene, camera: Camera, target: torch.Tensor):
        losses, grads, handles = [], [], []
        for b in range(n_buckets):
            loss_b, g = band_grad(scene, camera, target, cfg, builder, i * rows + b * bh, bh)
            handles.append(dist.all_reduce(g, group=group, async_op=True))
            losses.append(loss_b)
            grads.append(g)
        loss_all = torch.stack(losses)
        handles.append(dist.all_reduce(loss_all, group=group, async_op=True))
        for h in handles:
            h.wait()
        loss = loss_all.new_zeros(())
        total = torch.zeros_like(grads[0])
        for b in range(n_buckets):
            loss = loss + loss_all[b]
            total = total + grads[b]
        return loss, total

    return step


def make_unbucketed_grad_fn(cfg, mesh, tracer_builder=None):
    """The same sharded loss with one all-reduce at the end of the backward."""
    return make_overlapped_grad_fn(cfg, mesh, n_buckets=1, tracer_builder=tracer_builder)
