"""Nearest-hit intersection with a saved-hit-id replay backward (torch
counterpart of tracer/diff/vjp.py).

Differentiating the brute-force tier straight through would keep the whole
(R x T) packed intersection for the backward pass: O(R*T) work and memory.
The hit selection is piecewise constant, so the derivative involves each
ray's winning triangle only: the forward pass saves the selected triangle
ids, and the backward pass replays one Moller-Trumbore test a ray (all rays
at once) under autograd and adds the three winning vertices' gradients into
the vertex table with index_add_ over the rays that hit. The gradients are
those of the dense path (tests/torch_port/test_torch_vjp.py).
"""
from __future__ import annotations

import torch

from tracer_torch.core.intersect import any_hit_brute, intersect_brute, moller_trumbore
from tracer_torch.core.types import RAY_EPS, T_FAR, Hit, Ray


def _forward(o, d, verts, tris, t_min, t_max):
    """(R, 3) rays x every triangle (intersect_packed and nearest_hit, in
    chunks of rays) -> (t (R,), tri (R,) int32, uv (R, 2))."""
    hit = intersect_brute(Ray(o=o, d=d), verts, tris, t_min, t_max)
    return hit.t, hit.tri, hit.uv


def _replay(o, d, v0, v1, v2, valid, t_min, t_max):
    """One Moller-Trumbore test a ray against its saved triangle -> (t, uv);
    misses (not `valid`, or the replay rejects the pair) give T_FAR and 0,
    so their gradient is exactly 0. bary_eps = 1e-5, as render/tiled.py's
    mt_from_edges: the forward pass already chose the triangle, and a ray
    through a shared edge can recompute to u ~ -5e-8 here."""
    t, u, v, hit = moller_trumbore(o, d, v0, v1, v2, t_min=t_min, t_max=t_max, bary_eps=1e-5)
    ok = hit & valid
    t = torch.where(ok, t, T_FAR)
    uv = torch.where(ok[..., None], torch.stack([u, v], dim=-1), 0.0)
    return t, uv


class IntersectNearest(torch.autograd.Function):
    """(o (R, 3), d (R, 3), verts (V, 3), tris (T, 3), t_min, t_max) ->
    (t, tri, uv); differentiable in o, d and verts."""

    @staticmethod
    def forward(ctx, o, d, verts, tris, t_min, t_max):
        t, tri, uv = _forward(o, d, verts, tris, t_min, t_max)
        ctx.save_for_backward(o, d, verts, tris, tri)
        ctx.t_range = (t_min, t_max)
        ctx.mark_non_differentiable(tri)
        return t, tri, uv

    @staticmethod
    def backward(ctx, ct_t, _ct_tri, ct_uv):
        o, d, verts, tris, tri = ctx.saved_tensors
        valid = tri >= 0
        idx = tris[tri.clamp_min(0).long()].long()  # (R, 3)
        corners = [verts.detach()[idx[:, k]] for k in range(3)]
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(True) for x in (o, d, *corners)]
            out = _replay(*inputs, valid, *ctx.t_range)
            grads = torch.autograd.grad(out, inputs, (ct_t, ct_uv))
        do, dd = grads[:2]
        dverts = None
        if ctx.needs_input_grad[2]:
            dverts = torch.zeros_like(verts)
            for k in range(3):
                dverts.index_add_(0, idx[valid, k], grads[2 + k][valid])
        return do, dd, dverts, None, None, None


def intersect_nearest(o, d, verts, tris, t_min: float = 1e-4, t_max: float = T_FAR):
    """Differentiable nearest hit with an O(R) backward (see the module
    docstring) -> (t (R,), tri (R,) int32, uv (R, 2))."""
    return IntersectNearest.apply(o, d, verts, tris, t_min, t_max)


def make_replay_tracers(scene, t_min: float = 1e-4):
    """(trace_fn, occlude_fn) with the replayed nearest hit: the brute-force
    tracers of render/whitted.py for single-device differentiable losses
    (diff/fit.py)."""

    def trace(ray: Ray) -> Hit:
        batch = ray.batch_shape
        t, tri, uv = intersect_nearest(ray.o.reshape(-1, 3), ray.d.reshape(-1, 3), scene.verts,
                                       scene.tris, t_min, T_FAR)
        return Hit(t=t.reshape(batch), tri=tri.reshape(batch), uv=uv.reshape(batch + (2,)))

    def occlude(ray: Ray, t_max):
        return any_hit_brute(ray, scene.verts, scene.tris, t_min=RAY_EPS, t_max=t_max)

    return trace, occlude
