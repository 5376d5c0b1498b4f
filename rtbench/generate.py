"""The general traffic generator. A traffic mix is a data file,
rtbench/traffic/<name>.json, read here; nothing in it is code.

  {"loop": "frames", "camera": {...}}: a closed loop of frames, one in
      flight, the camera of frame i being path[(start + i) % period];
  {"loop": "grad", "camera": {...}, "optimizer": {...}, "params": [...],
   "target": {...}}: a closed loop of optimizer steps against one target
      image made from a seeded perturbation of the scene.

The loop is rtbench/loops/<loop>.py and the camera path
rtbench/cameras/<path>.py, each found by its name: "orbit" (P cameras on a
circle; the start index is drawn from the seed, so every seed renders the
same P views in another order) and "fixed" (the preset camera).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from rtbench import plugins
from rtbench.scenes.mesh import SceneArrays

ROOT = Path(__file__).resolve().parents[1]


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use of one seed (any size)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def camera_path(spec: dict, preset: dict, root: Path = ROOT) -> list[dict]:
    """The path's cameras {"position", "look_at", "fov_y_deg"} in order, from
    rtbench/cameras/<spec["path"]>.py."""
    return plugins.load("cameras", spec["path"], root).cameras(spec, preset)


def start_index(seed: int, period: int) -> int:
    return int(rng_of(seed, 1).integers(period))


def perturbed(arrays: SceneArrays, spec: dict, seed: int) -> dict:
    """The fit's target parameters from the seed: albedo times U(lo, hi) per
    entry; the camera moved by cam_offset in a uniformly random direction;
    every vertex moved along its normal by vert_amplitude * f(v), f a sum of
    three seeded plane waves of wave number vert_wave scaled into [-1, 1].
    -> {"verts", "albedo", "cam_pos"} numpy float32."""
    rng = rng_of(seed, 2)
    lo, hi = spec["albedo_scale"]
    albedo = arrays.albedo * rng.uniform(lo, hi, size=arrays.albedo.shape)
    u = rng.normal(size=3)
    cam = (np.asarray(arrays.camera["position"], np.float64)
           + spec["cam_offset"] * u / np.linalg.norm(u))
    k = rng.normal(size=(3, 3))
    k *= spec["vert_wave"] / np.linalg.norm(k, axis=1, keepdims=True)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    field = np.sin(arrays.verts.astype(np.float64) @ k.T + ph).sum(-1) / 3.0
    verts = arrays.verts + spec["vert_amplitude"] * field[:, None] * arrays.normals
    return {"verts": verts.astype(np.float32), "albedo": albedo.astype(np.float32),
            "cam_pos": cam.astype(np.float32)}
