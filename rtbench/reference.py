"""The plain reference: a Whitted renderer in plain PyTorch that the
benchmark holds the program's frames and grad steps to. It imports no part
of the program, shares no code with it, and takes nothing it has made: it
is handed the benchmark's own scene arrays and cameras.

Semantics (those of the program's tiled tier, written down afresh):
  * pinhole camera, rays through pixel centres, pixel (0, 0) top left;
  * nearest hit with t > T_MIN over every triangle, double-sided; a
    triangle is tested by its three affine maps (plane, barycentric u and
    v), evaluated for a chunk of rays against every triangle as one matrix
    product each for the origins and the directions;
  * smooth shading from area-weighted vertex normals, faced against the ray;
  * per point light: Lambert plus a Phong lobe, falloff 1/r^2, and a shadow
    segment traced from the light to p + n*RAY_EPS, blocked by any hit with
    T_MIN < t < 1 - RAY_EPS/|segment|;
  * radiance = emission + albedo*AMBIENT + direct, times (1 - mirror), plus
    mirror bounces up to max_bounces; black sky.

Selection (which triangle, whether blocked) is piecewise constant and runs
without gradients; hit attributes are recomputed from the chosen
triangle's maps, so autograd gives the gradients the program's tiled tier
gives (no edge terms). `tf32=True` rounds the operands of every matrix
product to TF32 (10 explicit mantissa bits, round to nearest even) and
accumulates in float32, as a GPU does with TF32 products enabled: the
control, one precision below the configuration's float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

T_MIN = 1e-4
RAY_EPS = 1e-4
T_FAR = 1e30
AMBIENT = 0.04
# Bytes of one chunk's (rays, triangles) float32 matrix; rays shaded at once.
CHUNK_BYTES = 1 << 28
PIXEL_CHUNK = 1 << 16


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept in float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _mm(a, b, tf32: bool):
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def tri_maps(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """(T, 3, 4) affine maps of every triangle: rows [n | -n.v0], [au |
    -au.v0], [av | -av.v0] with n = e1 x e2, au = (e2 x n)/|n|^2, av =
    (n x e1)/|n|^2, so that at x = o + t d the plane value is n.x - n.v0 and
    the barycentrics u, v are affine in x. Degenerate triangles get zero
    u/v rows and never hit."""
    t = tris.long()
    v0, v1, v2 = verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    n = torch.linalg.cross(e1, e2)
    n2 = (n * n).sum(-1, keepdim=True)
    inv = torch.where(n2 > 1e-24, 1.0 / torch.where(n2 > 0, n2, 1.0), 0.0)
    rows = torch.stack([n, torch.linalg.cross(e2, n) * inv, torch.linalg.cross(n, e1) * inv], 1)
    return torch.cat([rows, -(rows * v0[:, None, :]).sum(-1, keepdim=True)], -1)


def _pair_t(o, d, wt, t_max, tf32):
    """Rays (R, 3) against every triangle; wt (4, 3T) the maps' columns
    [plane | u | v] -> t (R, T), T_FAR where the pair does not hit."""
    n_tri = wt.shape[1] // 3
    ones = torch.ones_like(o[:, :1])
    so = _mm(torch.cat([o, ones], 1), wt, tf32)
    sd = _mm(torch.cat([d, torch.zeros_like(ones)], 1), wt, tf32)
    den = sd[:, :n_tri]
    ok_den = den.abs() > 1e-12
    t = -so[:, :n_tri] / torch.where(ok_den, den, 1.0)
    u = so[:, n_tri:2 * n_tri] + t * sd[:, n_tri:2 * n_tri]
    v = so[:, 2 * n_tri:] + t * sd[:, 2 * n_tri:]
    hit = ok_den & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN) & (t < t_max)
    return torch.where(hit, t, T_FAR)


def _columns(maps):
    return maps.permute(2, 1, 0).reshape(4, -1).contiguous()   # (4, 3T): plane | u | v


def _chunk(n_tri: int) -> int:
    return max(32, CHUNK_BYTES // (4 * n_tri))


@torch.no_grad()
def closest(o, d, maps, tf32: bool = False):
    """Nearest hit of each ray (R, 3) -> triangle index (R,) i64, -1 on a
    miss. Equal t: the lower index."""
    wt = _columns(maps.detach())
    step = _chunk(maps.shape[0])
    out = []
    for a in range(0, o.shape[0], step):
        t = _pair_t(o[a:a + step].detach(), d[a:a + step].detach(), wt, T_FAR, tf32)
        best, idx = t.min(1)
        out.append(torch.where(best < T_FAR, idx, -1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.long, device=o.device)


@torch.no_grad()
def blocked(o, d, t_max, maps, tf32: bool = False):
    """Whether each segment o + t d, T_MIN < t < t_max (R,), hits any
    triangle -> (R,) bool. Rays with d == 0 never hit."""
    wt = _columns(maps.detach())
    step = _chunk(maps.shape[0])
    out = []
    for a in range(0, o.shape[0], step):
        t = _pair_t(o[a:a + step].detach(), d[a:a + step].detach(), wt,
                    t_max[a:a + step, None].detach(), tf32)
        out.append((t < T_FAR).any(1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool, device=o.device)


def vertex_normals(verts, tris):
    """Area-weighted vertex normals, differentiable in verts."""
    t = tris.long()
    v0, v1, v2 = verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    acc = torch.zeros_like(verts)
    for k in range(3):
        acc = acc.index_add(0, t[:, k], fn)
    return acc / torch.linalg.norm(acc, dim=-1, keepdim=True).clamp_min(1e-20)


def _unit(x):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-20)


def camera_rays(position, look_at, fov_y_deg: float, height: int, width: int, ys, xs):
    """Rays through the centres of pixels (ys, xs) (R,) of an H x W image ->
    (o, d) (R, 3), differentiable in position."""
    up = torch.tensor([0.0, 1.0, 0.0], device=position.device)
    fwd = _unit(look_at - position)
    right = _unit(torch.linalg.cross(fwd, up))
    cam_up = torch.linalg.cross(right, fwd)
    fov = np.float32(fov_y_deg) * np.float32(np.pi / 180)
    tan_half = math.tan(float(fov) * 0.5)
    ndc_x = ((xs.float() + 0.5) / width * 2.0 - 1.0) * (width / height) * tan_half
    ndc_y = (1.0 - (ys.float() + 0.5) / height * 2.0) * tan_half
    d = ndc_x[:, None] * right + ndc_y[:, None] * cam_up + fwd
    return position.expand(d.shape), _unit(d)


def _dot(a, b):
    return (a * b).sum(-1)


def shade(scene: dict, o, d, max_bounces: int, tf32: bool = False):
    """Radiance (R, 3) of rays (o, d) in `scene`, a dict of tensors: verts,
    tris, mat_id, albedo, emission, mirror, specular, shininess, light_pos,
    light_int, and normals (recomputed from verts where absent). Autograd
    flows through verts, albedo and the rays; not through selection."""
    verts, tris = scene["verts"], scene["tris"]
    normals = scene.get("normals")
    if normals is None:
        normals = vertex_normals(verts, tris)
    maps = tri_maps(verts, tris)
    tl = tris.long()
    radiance = torch.zeros_like(o)
    throughput = torch.ones_like(o)
    live = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for bounce in range(max_bounces):
        tri = closest(o, d, maps, tf32)
        found = (tri >= 0) & live
        k = tri.clamp_min(0)
        w = maps[k]                                        # (R, 3, 4)
        so = (w[..., :3] * o[:, None]).sum(-1) + w[..., 3]
        sd = (w[..., :3] * d[:, None]).sum(-1)
        t = -so[:, 0] / torch.where(sd[:, 0].abs() > 1e-12, sd[:, 0], 1.0)
        u = so[:, 1] + t * sd[:, 1]
        v = so[:, 2] + t * sd[:, 2]
        p = o + t[:, None] * d
        idx = tl[k]
        n = _unit(normals[idx[:, 0]] * (1 - u - v)[:, None] + normals[idx[:, 1]] * u[:, None]
                  + normals[idx[:, 2]] * v[:, None])
        n = torch.where((_dot(n, d) > 0)[:, None], -n, n)
        mat = scene["mat_id"].long()[k]
        albedo, emission = scene["albedo"][mat], scene["emission"][mat]
        mirror = scene["mirror"][mat][:, None]
        spec, shin = scene["specular"][mat], scene["shininess"][mat]
        direct = torch.zeros_like(o)
        for li in range(scene["light_pos"].shape[0]):
            lpos, lint = scene["light_pos"][li], scene["light_int"][li]
            to_l = lpos - p
            dist2 = _dot(to_l, to_l)
            wi = to_l / torch.sqrt(dist2.clamp_min(1e-20))[:, None]
            cos = _dot(n, wi).clamp_min(0.0)
            lit = found & (cos > 0)
            target = (p + n * RAY_EPS).detach()
            seg = torch.where(lit[:, None], target - lpos, 0.0)
            seg_len = torch.sqrt(_dot(seg, seg).clamp_min(1e-20))
            occ = blocked(lpos.detach().expand(seg.shape), seg, 1.0 - RAY_EPS / seg_len,
                          maps, tf32)
            vis = (lit & ~occ).float()
            r = d - 2.0 * _dot(d, n)[:, None] * n
            cos_r = _dot(r, wi).clamp_min(0.0)
            lobe = torch.where((cos_r > 0) & (spec > 0),
                               torch.where(cos_r > 0, cos_r, 1.0) ** shin, 0.0)
            brdf = albedo / math.pi * cos[:, None] + (spec * lobe)[:, None]
            direct = direct + brdf * (vis / dist2.clamp_min(1e-20))[:, None] * lint
        local = emission + albedo * AMBIENT + direct
        radiance = radiance + throughput * torch.where(found[:, None], local * (1 - mirror), 0.0)
        if bounce + 1 < max_bounces:
            live = found & (mirror[:, 0] > 0)
            refl = d - 2.0 * _dot(d, n)[:, None] * n
            o = torch.where(live[:, None], p + n * RAY_EPS, 0.0)
            d = torch.where(live[:, None], _unit(refl), 0.0)
            throughput = throughput * mirror
    return radiance


def render_pixels(scene: dict, camera: dict, height: int, width: int, ys, xs,
                  max_bounces: int, tf32: bool = False):
    """Radiance (R, 3) at pixels (ys, xs) of the frame seen from `camera`
    {"position", "look_at" tensors, "fov_y_deg"}, in chunks of rays."""
    out = []
    for a in range(0, ys.shape[0], PIXEL_CHUNK):
        o, d = camera_rays(camera["position"], camera["look_at"], camera["fov_y_deg"],
                           height, width, ys[a:a + PIXEL_CHUNK], xs[a:a + PIXEL_CHUNK])
        out.append(shade(scene, o, d, max_bounces, tf32))
    return torch.cat(out)


def render_image(scene: dict, camera: dict, height: int, width: int, max_bounces: int,
                 tf32: bool = False):
    """The whole H x W x 3 frame."""
    dev = scene["verts"].device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    img = render_pixels(scene, camera, height, width, ys.reshape(-1), xs.reshape(-1),
                        max_bounces, tf32)
    return img.reshape(height, width, 3)
