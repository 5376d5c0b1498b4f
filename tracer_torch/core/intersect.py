"""Ray-triangle intersection (torch counterpart of tracer/core/intersect.py).

Triangles are precompiled into per-triangle affine maps (the Baldwin-Weber
form of Moller-Trumbore): rows [n | -n.v0], [au | -au.v0], [av | -av.v0]
with n = e1 x e2, au = (e2 x n)/|n|^2, av = (n x e1)/|n|^2, so that for a
homogeneous ray (o, 1) + t (d, 0) the plane value and both barycentrics are
affine in t. The traversal kernels (kernels/traversal2.py) evaluate exactly
these maps; `moller_trumbore` is the classic formulation they are held to.
`intersect_packed` evaluates them for every ray against every triangle as
two float32 products; `intersect_brute` and `any_hit_brute` run it over
chunks of rays: the brute-force tracers, and the oracle of the accel tiers'
tests.
"""
from __future__ import annotations

import torch

from tracer_torch.core.types import T_FAR, Hit, Ray, dot


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


# Bytes of (rays, 3T) products the brute-force passes hold at once.
_BRUTE_BYTES = 1 << 28


def _packed_epilogue(so, sd, t_min, t_max, eps):
    """(R, T, 3) plane/u/v values at the origins and along the directions ->
    (t, u, v, hit) each (R, T); t == T_FAR where the pair misses."""
    denom = sd[..., 0]
    safe = denom.abs() > eps
    t = -so[..., 0] / torch.where(safe, denom, 1.0)
    u = so[..., 1] + t * sd[..., 1]
    v = so[..., 2] + t * sd[..., 2]
    hit = safe & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return torch.where(hit, t, T_FAR), u, v, hit


def intersect_packed(o4: torch.Tensor, d4: torch.Tensor, tri_maps: torch.Tensor,
                     t_min: float = 1e-4, t_max=T_FAR, eps: float = 1e-12):
    """Every one of R rays against every one of T triangles by two products.

    o4, d4: (R, 4) homogeneous rays ((o, 1) and (d, 0)); tri_maps: (T, 3, 4)
    from triangle_affine_maps; t_max a scalar or an (R, 1) per-ray bound.
    Returns (t, u, v, hit) each (R, T); t == T_FAR where the pair misses.
    The products must run in full float32: a reduced-precision product
    (TF32, which torch.backends.cuda.matmul.allow_tf32 turns on, or bf16)
    misclassifies hits, since t is compared against bounds of 1e-4."""
    n_tri = tri_maps.shape[0]
    w = tri_maps.reshape(n_tri * 3, 4).T  # (4, 3T)
    so = (o4 @ w).reshape(-1, n_tri, 3)
    sd = (d4 @ w).reshape(-1, n_tri, 3)
    return _packed_epilogue(so, sd, t_min, t_max, eps)


def _brute_chunks(ray: Ray, maps: torch.Tensor, t_min, t_max, eps: float = 1e-12):
    """intersect_packed over chunks of the rays -> yields (t, u, v, hit)
    each (R_chunk, T), in ray order. t_max is a scalar or a (R,) per-ray
    bound."""
    o = ray.o.reshape(-1, 3)
    d = ray.d.reshape(-1, 3)
    n_tri = maps.shape[0]
    step = max(1, _BRUTE_BYTES // max(1, 8 * 3 * n_tri * 4))
    for a in range(0, o.shape[0], step):
        sl = slice(a, min(a + step, o.shape[0]))
        o4 = torch.cat([o[sl], o.new_ones((o[sl].shape[0], 1))], dim=-1)
        d4 = torch.cat([d[sl], d.new_zeros((d[sl].shape[0], 1))], dim=-1)
        tm = t_max[sl, None] if isinstance(t_max, torch.Tensor) and t_max.ndim > 0 else t_max
        yield intersect_packed(o4, d4, maps, t_min, tm, eps)


def nearest_hit(t, u, v, tri_ids=None) -> Hit:
    """Reduce (R, T) per-pair results to the nearest Hit per ray (the first
    triangle among equal t). tri_ids (T,) maps a column to its triangle id;
    without it the column is the id."""
    idx = torch.argmin(t, dim=-1)
    r = torch.arange(t.shape[0], device=t.device)
    t_best = t[r, idx]
    uv = torch.stack([u[r, idx], v[r, idx]], dim=-1)
    tri = idx.to(torch.int32) if tri_ids is None else tri_ids[idx].to(torch.int32)
    tri = torch.where(t_best < T_FAR, tri, -1)
    return Hit(t=t_best, tri=tri, uv=torch.where(t_best[..., None] < T_FAR, uv, 0.0))


def intersect_brute(ray: Ray, verts, tris, t_min: float = 1e-4, t_max: float = T_FAR) -> Hit:
    """All rays x all triangles: the nearest hit per ray, in the ray batch's
    shape. Rays run in chunks so the (R, 3T) products stay near 256 MB."""
    maps = triangle_affine_maps(verts, tris)
    parts = [nearest_hit(*res[:3]) for res in _brute_chunks(ray, maps, t_min, t_max)]
    shape = ray.batch_shape
    return Hit(t=torch.cat([h.t for h in parts]).reshape(shape),
               tri=torch.cat([h.tri for h in parts]).reshape(shape),
               uv=torch.cat([h.uv for h in parts]).reshape(shape + (2,)))


def any_hit_brute(ray: Ray, verts, tris, t_min: float = 1e-4, t_max=T_FAR) -> torch.Tensor:
    """Occlusion: True where any triangle has t in (t_min, t_max); t_max a
    scalar or a per-ray tensor of the ray batch shape."""
    maps = triangle_affine_maps(verts, tris)
    if isinstance(t_max, torch.Tensor) and t_max.ndim > 0:
        t_max = t_max.reshape(-1)
    parts = [res[3].any(-1) for res in _brute_chunks(ray, maps, t_min, t_max)]
    return torch.cat(parts).reshape(ray.batch_shape)
