"""The bunny stand-in: one displaced blob of 20*4^subdiv triangles, scaled
by 0.6 and raised to y = 0.75, over a ground quad, one point light that
casts its shadow on the ground (81,922 triangles at subdiv 6)."""
from __future__ import annotations

import numpy as np

from rtbench.scenes.mesh import displaced_blob, quad, scene_arrays


def make(subdiv: int = 6):
    body_v, body_f = displaced_blob(subdiv)
    body_v = body_v * 0.6 + np.array([0.0, 0.75, 0.0], np.float32)
    ground_v, ground_f = quad([-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3])
    parts = [(body_v, body_f, np.full(len(body_f), 0, np.int32)),
             (ground_v, ground_f, np.full(len(ground_f), 1, np.int32))]
    return scene_arrays(
        parts, albedo=[[0.62, 0.57, 0.50], [0.55, 0.55, 0.58]],
        light_pos=[[1.8, 2.6, 1.4]], light_int=[[7.0, 6.8, 6.5]],
        camera=dict(position=(0.0, 1.1, 2.6), look_at=(0.0, 0.65, 0.0), fov_y_deg=42.0))
