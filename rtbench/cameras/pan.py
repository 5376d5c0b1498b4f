"""camera {"path": "pan", "period": P, "eye": [x, y, z], "look_distance":
r, "look_height": h[, "fov_y_deg": f]}: P cameras turning on the spot at
`eye`, in order, each looking at a point r ahead at height h; the first
looks along the preset camera's heading (its horizontal direction to its
look-at). The field of view is the preset's unless given."""
from __future__ import annotations

import math

import numpy as np


def cameras(spec: dict, preset: dict) -> list[dict]:
    eye = np.asarray(spec["eye"], np.float64)
    pos = np.asarray(preset["position"], np.float64)
    look = np.asarray(preset["look_at"], np.float64)
    base = math.atan2(look[2] - pos[2], look[0] - pos[0])
    r, h = spec["look_distance"], spec["look_height"]
    out = []
    for i in range(spec["period"]):
        a = base + 2.0 * math.pi * i / spec["period"]
        centre = (eye[0] + r * math.cos(a), h, eye[2] + r * math.sin(a))
        out.append(dict(position=tuple(np.float32(eye)), look_at=tuple(np.float32(centre)),
                        fov_y_deg=spec.get("fov_y_deg", preset["fov_y_deg"])))
    return out
