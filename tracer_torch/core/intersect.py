"""Ray-triangle intersection (torch counterpart of tracer/core/intersect.py).

Triangles are precompiled into per-triangle affine maps (the Baldwin-Weber
form of Moller-Trumbore): rows [n | -n.v0], [au | -au.v0], [av | -av.v0]
with n = e1 x e2, au = (e2 x n)/|n|^2, av = (n x e1)/|n|^2, so that for a
homogeneous ray (o, 1) + t (d, 0) the plane value and both barycentrics are
affine in t. The traversal kernels (kernels/traversal2.py) evaluate exactly
these maps; `moller_trumbore` is the classic formulation they are held to.
"""
from __future__ import annotations

import torch

from tracer_torch.core.types import T_FAR, dot


def moller_trumbore(ray_o, ray_d, v0, v1, v2, t_min: float = 1e-4,
                    t_max: float = T_FAR, eps: float = 1e-12,
                    bary_eps: float = 0.0):
    """Classic Moller-Trumbore, broadcasting over leading batch dims.
    Returns (t, u, v, hit); t == T_FAR on a miss. Double-sided."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = torch.linalg.cross(ray_d, e2)
    det = dot(e1, pvec)
    inv_det = torch.where(det.abs() > eps,
                          1.0 / torch.where(det == 0, torch.ones_like(det), det),
                          torch.zeros_like(det))
    tvec = ray_o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = dot(ray_d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((det.abs() > eps) & (u >= -bary_eps) & (v >= -bary_eps)
           & (u + v <= 1.0 + bary_eps) & (t > t_min) & (t < t_max))
    return torch.where(hit, t, torch.full_like(t, T_FAR)), u, v, hit


def triangle_affine_maps(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """(T, 3, 4) affine intersection maps. Degenerate triangles
    (|n|^2 <= 1e-24) get zero u/v rows and never report a hit."""
    tris = tris.long()
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = torch.linalg.cross(e1, e2)
    n2 = (n * n).sum(-1, keepdim=True)
    inv_n2 = torch.where(n2 > 1e-24,
                         1.0 / torch.where(n2 == 0, torch.ones_like(n2), n2),
                         torch.zeros_like(n2))
    au = torch.linalg.cross(e2, n) * inv_n2
    av = torch.linalg.cross(n, e1) * inv_n2
    rows = torch.stack([n, au, av], dim=1)  # (T, 3, 3)
    offs = -(rows * v0[:, None, :]).sum(-1)  # (T, 3)
    return torch.cat([rows, offs[..., None]], dim=-1)
