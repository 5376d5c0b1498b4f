"""The columned hall: a shell of floor, ceiling and four walls facing
inward, a grid of cols_x x cols_z square columns, and a displaced blob of
20*4^blob_subdiv triangles on every second cell as clutter, two point
lights under the ceiling, the blobs' material a quarter mirror (3,936,780
triangles at cols_x 24, cols_z 16, blob_subdiv 5)."""
from __future__ import annotations

import numpy as np

from rtbench.scenes.mesh import displaced_blob, quad, scene_arrays

# Columns: half their width; the hall's height.
COLUMN_HALF = 0.12
HEIGHT = 4.0


def box(lo, hi):
    """12-triangle axis-aligned box with outward winding."""
    (x0, y0, z0), (x1, y1, z1) = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    verts = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                      [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]], np.float32)
    faces = [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
             [3, 6, 2], [3, 7, 6], [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5]]
    return verts, np.array(faces, np.int32)


def make(cols_x: int = 12, cols_z: int = 8, blob_subdiv: int = 4):
    white, stone, accent = 0, 1, 2
    hx, hy, hz = cols_x * 1.0, HEIGHT, cols_z * 1.0
    shell = [
        ([0, 0, 0], [hx, 0, 0], [hx, 0, hz], [0, 0, hz]),       # floor
        ([0, hy, 0], [0, hy, hz], [hx, hy, hz], [hx, hy, 0]),   # ceiling
        ([0, 0, 0], [0, hy, 0], [hx, hy, 0], [hx, 0, 0]),       # back
        ([0, 0, hz], [hx, 0, hz], [hx, hy, hz], [0, hy, hz]),   # front
        ([0, 0, 0], [0, 0, hz], [0, hy, hz], [0, hy, 0]),       # left
        ([hx, 0, 0], [hx, hy, 0], [hx, hy, hz], [hx, 0, hz]),   # right
    ]
    parts = []
    for corners in shell:
        v, t = quad(*corners)
        parts.append((v, t, np.full(len(t), white, np.int32)))
    blob_v, blob_f = displaced_blob(blob_subdiv, seed=7)
    rng = np.random.default_rng(3)
    for ix in range(cols_x):
        for iz in range(cols_z):
            cx, cz = ix + 0.5, iz + 0.5
            v, t = box([cx - COLUMN_HALF, 0, cz - COLUMN_HALF],
                       [cx + COLUMN_HALF, hy, cz + COLUMN_HALF])
            parts.append((v, t, np.full(len(t), stone, np.int32)))
            if (ix + iz) % 2 == 0:
                s = 0.18 + 0.1 * rng.random()
                pos = np.array([cx, 0.35, cz], np.float32)
                parts.append((blob_v * s + pos, blob_f, np.full(len(blob_f), accent, np.int32)))
    return scene_arrays(
        parts, albedo=[[0.70, 0.68, 0.62], [0.52, 0.50, 0.46], [0.45, 0.30, 0.22]],
        mirror=[0.0, 0.0, 0.25],
        light_pos=[[hx * 0.3, hy - 0.4, hz * 0.3], [hx * 0.7, hy - 0.4, hz * 0.7]],
        light_int=[[60.0, 58.0, 52.0], [50.0, 52.0, 58.0]],
        camera=dict(position=(hx * 0.5, 1.7, hz - 0.6), look_at=(hx * 0.5, 1.4, 0.0),
                    fov_y_deg=55.0))
