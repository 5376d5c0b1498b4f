"""CPU reference oracle (numpy): the port's own copy of
tracer/refcpu/oracle.py, a classic scalar-style Whitted renderer
(vectorized only over triangles per pixel) with textbook Moller-Trumbore,
a different algorithm and code path from the port's affine-map products
and cluster culls, so agreement between the two is evidence of
correctness. It imports numpy only: the scene and camera are read through
numpy (tensors on any device are copied to the host), and nothing of the
port's rendering code is used. Slow: small images only (refcpu.cpp is the
fast fp64 oracle).
"""
from __future__ import annotations

import numpy as np

T_FAR = 1e30
RAY_EPS = 1e-4


def host_array(x, dtype=np.float64) -> np.ndarray:
    """A tensor (on any device) or array -> a C-contiguous numpy array of
    dtype."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=dtype)


def _mt_one_ray(o, d, v0, v1, v2, t_min=1e-4, t_max=T_FAR):
    """Moller-Trumbore: one ray vs all triangles. Returns (t, u, v, hit)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(np.broadcast_to(d, e2.shape), e2)
    det = np.einsum("ij,ij->i", e1, pvec)
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = np.einsum("ij,ij->i", tvec, pvec) * inv_det
    qvec = np.cross(tvec, e1)
    v = np.einsum("j,ij->i", d, qvec) * inv_det
    t = np.einsum("ij,ij->i", e2, qvec) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
    return np.where(hit, t, T_FAR), u, v, hit


def _trace(o, d, v0, v1, v2, t_min=1e-4):
    t, u, v, _ = _mt_one_ray(o, d, v0, v1, v2, t_min)
    i = int(np.argmin(t))
    if t[i] >= T_FAR:
        return T_FAR, -1, 0.0, 0.0
    return float(t[i]), i, float(u[i]), float(v[i])


def _occluded(o, d, v0, v1, v2, t_max):
    _, _, _, hit = _mt_one_ray(o, d, v0, v1, v2, RAY_EPS, t_max)
    return bool(hit.any())


def _normalize(v):
    return v / max(np.linalg.norm(v), 1e-20)


def cpu_render(scene, camera, height, width, max_bounces=1, smooth_shading=True,
               sky_color=(0.0, 0.0, 0.0), ambient=0.04):
    """Per-pixel loop CPU renderer with the same shading model as
    render/whitted.py. Slow — use small images."""
    verts = host_array(scene.verts)
    tris = host_array(scene.tris, np.int64)
    normals = host_array(scene.normals)
    mat_id = host_array(scene.mat_id, np.int64)
    albedo = host_array(scene.materials.albedo)
    emission = host_array(scene.materials.emission)
    mirror = host_array(scene.materials.mirror)
    specular = host_array(scene.materials.specular)
    shininess = host_array(scene.materials.shininess)
    lpos = host_array(scene.lights.position)
    lint = host_array(scene.lights.intensity)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]

    pos = host_array(camera.position)
    fwd = _normalize(host_array(camera.look_at) - pos)
    right = _normalize(np.cross(fwd, host_array(camera.up)))
    up = np.cross(right, fwd)
    tan_half = np.tan(float(camera.fov_y) * 0.5)
    aspect = width / height

    img = np.zeros((height, width, 3), np.float64)
    sky = np.asarray(sky_color, np.float64)
    for y in range(height):
        for x in range(width):
            ndc_x = ((x + 0.5) / width * 2 - 1) * aspect * tan_half
            ndc_y = (1 - (y + 0.5) / height * 2) * tan_half
            o = pos.copy()
            d = _normalize(ndc_x * right + ndc_y * up + fwd)
            throughput = np.ones(3)
            color = np.zeros(3)
            for bounce in range(max_bounces):
                t, tri, u, v = _trace(o, d, v0, v1, v2)
                if tri < 0:
                    color += throughput * sky
                    break
                p = o + t * d
                idx = tris[tri]
                if smooth_shading:
                    n = _normalize(
                        (1 - u - v) * normals[idx[0]] + u * normals[idx[1]] + v * normals[idx[2]]
                    )
                else:
                    n = _normalize(np.cross(verts[idx[1]] - verts[idx[0]],
                                            verts[idx[2]] - verts[idx[0]]))
                if np.dot(n, d) > 0:
                    n = -n
                m = mat_id[tri]
                direct = np.zeros(3)
                for li in range(len(lpos)):
                    to_l = lpos[li] - p
                    dist = np.linalg.norm(to_l)
                    wi = to_l / dist
                    cos = max(np.dot(n, wi), 0.0)
                    so = p + n * RAY_EPS
                    vis = 0.0 if _occluded(so, wi, v0, v1, v2, dist - 2 * RAY_EPS) else 1.0
                    # Lambert + Phong lobe (render/whitted.py:phong_specular).
                    r = d - 2 * np.dot(d, n) * n
                    cos_r = max(np.dot(r, wi), 0.0)
                    ph = specular[m] * (cos_r ** shininess[m]) if (
                        specular[m] > 0.0 and cos_r > 0.0) else 0.0
                    brdf = albedo[m] / np.pi * cos + ph
                    direct += brdf * vis / max(dist * dist, 1e-20) * lint[li]
                local = emission[m] + albedo[m] * ambient + direct
                color += throughput * local * (1.0 - mirror[m])
                if bounce + 1 >= max_bounces or mirror[m] <= 0.0:
                    break
                d = _normalize(d - 2 * np.dot(d, n) * n)
                o = p + n * RAY_EPS
                throughput = throughput * mirror[m]
            img[y, x] = color
    return img.astype(np.float32)
