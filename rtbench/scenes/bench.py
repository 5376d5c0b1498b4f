"""The headline scene: num_blobs displaced blobs of 20*4^subdiv triangles on
a ring of radius 2.2 over a ground quad, one point light (102,402
triangles at the defaults)."""
from __future__ import annotations

import numpy as np

from rtbench.scenes.mesh import displaced_blob, quad, scene_arrays


def make(num_blobs: int = 5, subdiv: int = 5):
    rng = np.random.default_rng(11)
    parts = []
    for i in range(num_blobs):
        v, f = displaced_blob(subdiv, seed=i)
        s = 0.45 + 0.25 * rng.random()
        pos = np.array([2.2 * np.cos(2 * np.pi * i / num_blobs), s + 0.05,
                        2.2 * np.sin(2 * np.pi * i / num_blobs)], np.float32)
        parts.append((v * s + pos, f, np.full(len(f), i % 3, np.int32)))
    gv, gf = quad([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6])
    parts.append((gv, gf, np.full(len(gf), 1, np.int32)))
    return scene_arrays(
        parts, albedo=[[0.62, 0.55, 0.45], [0.50, 0.52, 0.55], [0.35, 0.45, 0.60]],
        light_pos=[[4.0, 6.0, 3.0]], light_int=[[45.0, 44.0, 42.0]],
        camera=dict(position=(0.0, 2.6, 5.5), look_at=(0.0, 0.6, 0.0), fov_y_deg=50.0))
