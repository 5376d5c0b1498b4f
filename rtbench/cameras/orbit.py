"""camera {"path": "orbit", "period": P, ...}: P cameras on a circle, in
order. Without further keys the circle is the scene's preset camera turned
about the vertical through its look-at (its horizontal radius, height and
field of view); "eye_radius", "eye_height", "look_radius", "look_height"
(about the origin, at the eye's angle) and "fov_y_deg" set it instead."""
from __future__ import annotations

import math

import numpy as np


def cameras(spec: dict, preset: dict) -> list[dict]:
    pos = np.asarray(preset["position"], np.float64)
    look = np.asarray(preset["look_at"], np.float64)
    eye_r = spec.get("eye_radius", math.hypot(pos[0] - look[0], pos[2] - look[2]))
    eye_h = spec.get("eye_height", pos[1])
    look_r = spec.get("look_radius")
    look_h = spec.get("look_height", look[1])
    base = math.atan2(pos[2] - look[2], pos[0] - look[0])
    out = []
    for i in range(spec["period"]):
        a = base + 2.0 * math.pi * i / spec["period"]
        ca, sa = math.cos(a), math.sin(a)
        if look_r is None:      # turntable about the preset look-at
            centre = (look[0], look_h, look[2])
            eye = (look[0] + eye_r * ca, eye_h, look[2] + eye_r * sa)
        else:                   # about the origin, looking outward
            centre = (look_r * ca, look_h, look_r * sa)
            eye = (eye_r * ca, eye_h, eye_r * sa)
        out.append(dict(position=tuple(np.float32(eye)), look_at=tuple(np.float32(centre)),
                        fov_y_deg=spec.get("fov_y_deg", preset["fov_y_deg"])))
    return out
