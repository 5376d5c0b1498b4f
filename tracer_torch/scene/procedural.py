"""Procedural scene fixtures (numpy counterpart of tracer/scene/procedural.py:
the same arrays, bit for bit, wrapped in tensors on the given device).

The bunny/Sponza-class fixtures are generated procedurally at the BASELINE
triangle counts (Cornell ~32 tris; "bunny" ~70k tris; "Sponza-class" ~260k
tris; 1M-tri pod scene).
"""
from __future__ import annotations

import numpy as np

from tracer_torch.scene.types import Scene, Materials, Lights, merge_meshes


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise winding)."""
    return np.array([a, b, c, d], np.float32), np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _box(lo, hi):
    """12-triangle axis-aligned box with outward winding."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    verts = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    faces = [
        [0, 2, 1], [0, 3, 2],  # z = z0
        [4, 5, 6], [4, 6, 7],  # z = z1
        [0, 1, 5], [0, 5, 4],  # y = y0
        [3, 6, 2], [3, 7, 6],  # y = y1
        [0, 4, 7], [0, 7, 3],  # x = x0
        [1, 2, 6], [1, 6, 5],  # x = x1
    ]
    return verts, np.array(faces, np.int32)


def cornell_box(with_boxes: bool = True, *, device) -> tuple[Scene, "CameraSpec"]:
    """The Cornell box (BASELINE config 1): 5 colored walls + 2 inner boxes,
    ~34 tris, one area-light approximated as a point light near the ceiling.

    Returns (scene, camera_kwargs) with the canonical viewpoint.
    """
    parts = []
    # Walls of the unit-ish box [0,1]^3, opening toward +z (camera side).
    white, red, green = 0, 1, 2
    wall_quads = [
        # floor y=0 (up normal)
        (([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]), white),
        # ceiling y=1
        (([0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0]), white),
        # back wall z=0
        (([0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0]), white),
        # left wall x=0 (red)
        (([0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]), red),
        # right wall x=1 (green)
        (([1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1]), green),
    ]
    for quad, mat in wall_quads:
        v, t = _quad(*quad)
        parts.append((v, t, np.full(len(t), mat, np.int32)))
    if with_boxes:
        v, t = _box([0.12, 0.0, 0.12], [0.47, 0.60, 0.47])
        parts.append((v, t, np.full(len(t), white, np.int32)))
        v, t = _box([0.55, 0.0, 0.50], [0.85, 0.30, 0.80])
        parts.append((v, t, np.full(len(t), white, np.int32)))

    verts, tris, mat_id = merge_meshes(parts)
    materials = Materials.make(
        albedo=[[0.73, 0.73, 0.73], [0.65, 0.05, 0.05], [0.12, 0.45, 0.15]],
        device=device,
    )
    lights = Lights.make(
        position=np.array([[0.5, 0.93, 0.5]], np.float32),
        intensity=np.array([[1.1, 1.1, 1.1]], np.float32),
        device=device,
    )
    scene = Scene.make(verts, tris, mat_id, materials, lights, device=device)
    cam = dict(position=(0.5, 0.5, 2.2), look_at=(0.5, 0.5, 0.0), fov_y_deg=40.0)
    return scene, cam


def _icosphere(subdiv: int) -> tuple[np.ndarray, np.ndarray]:
    """Icosahedron subdivided `subdiv` times, radius 1. 20*4^s faces."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        # Vectorized midpoint subdivision: unique edges via np.unique.
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
        e = np.sort(e, axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        mids = v[uniq[:, 0]] + v[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = len(v) + inv  # (3F,) midpoint vertex ids per edge slot
        n_faces = len(f)
        ab = mid_idx[0 * n_faces : 1 * n_faces]
        bc = mid_idx[1 * n_faces : 2 * n_faces]
        ca = mid_idx[2 * n_faces : 3 * n_faces]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([b, bc, ab], 1),
                np.stack([c, ca, bc], 1),
                np.stack([ab, bc, ca], 1),
            ],
            axis=0,
        )
        v = np.concatenate([v, mids], axis=0)
    return v.astype(np.float32), f.astype(np.int32)


def _displaced_blob(subdiv: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Organic blob: icosphere with smooth multi-frequency displacement —
    the procedural stand-in for the Stanford bunny (no asset downloads)."""
    v, f = _icosphere(subdiv)
    rng = np.random.default_rng(seed)
    r = np.ones(len(v))
    for freq, amp in [(1.5, 0.22), (3.1, 0.10), (6.3, 0.045)]:
        k = rng.normal(size=(3, 3)) * freq
        ph = rng.uniform(0, 2 * np.pi, size=3)
        r += amp * np.sin(v @ k.T + ph).sum(axis=-1) / 3.0
    return (v * r[:, None]).astype(np.float32), f


def bunny_scene(subdiv: int = 5, *, device) -> tuple[Scene, dict]:
    """BASELINE config 2 stand-in: ~70k-tri organic blob above a ground plane
    with a point light casting shadows. subdiv=5 -> 20*4^5 = 20480*... (20*1024)
    = 20480 faces; subdiv=5 plus ground; use subdiv=6 for ~81k more.
    Default subdiv=5 gives 20,480 + ground; pass subdiv=6 for 81,920 (~"70k"-class).
    """
    body_v, body_f = _displaced_blob(subdiv)
    body_v = body_v * 0.6 + np.array([0.0, 0.75, 0.0], np.float32)
    ground_v, ground_f = _quad([-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3])
    verts, tris, mat_id = merge_meshes(
        [
            (body_v, body_f, np.full(len(body_f), 0, np.int32)),
            (ground_v, ground_f, np.full(len(ground_f), 1, np.int32)),
        ]
    )
    materials = Materials.make(albedo=[[0.62, 0.57, 0.50], [0.55, 0.55, 0.58]],
                               device=device)
    lights = Lights.make(
        position=np.array([[1.8, 2.6, 1.4]], np.float32),
        intensity=np.array([[7.0, 6.8, 6.5]], np.float32),
        device=device,
    )
    scene = Scene.make(verts, tris, mat_id, materials, lights, device=device)
    cam = dict(position=(0.0, 1.1, 2.6), look_at=(0.0, 0.65, 0.0), fov_y_deg=42.0)
    return scene, cam


def columned_hall(cols_x: int = 12, cols_z: int = 8, blob_subdiv: int = 4, *,
                  device) -> tuple[Scene, dict]:
    """BASELINE config 4 stand-in ("Sponza-class", ~260k tris): a columned
    hall — floor, ceiling, walls, a grid of columns, and displaced blobs as
    clutter to reach the target triangle count with non-axis-aligned geometry.
    """
    parts = []
    white, stone, accent = 0, 1, 2
    hx, hy, hz = cols_x * 1.0, 4.0, cols_z * 1.0
    # Shell (floor/ceiling/4 walls) as quads facing inward.
    shell = [
        ([0, 0, 0], [hx, 0, 0], [hx, 0, hz], [0, 0, hz]),       # floor
        ([0, hy, 0], [0, hy, hz], [hx, hy, hz], [hx, hy, 0]),   # ceiling
        ([0, 0, 0], [0, hy, 0], [hx, hy, 0], [hx, 0, 0]),       # back
        ([0, 0, hz], [hx, 0, hz], [hx, hy, hz], [0, hy, hz]),   # front
        ([0, 0, 0], [0, 0, hz], [0, hy, hz], [0, hy, 0]),       # left
        ([hx, 0, 0], [hx, hy, 0], [hx, hy, hz], [hx, 0, hz]),   # right
    ]
    for quad in shell:
        v, t = _quad(*quad)
        parts.append((v, t, np.full(len(t), white, np.int32)))
    blob_v0, blob_f0 = _displaced_blob(blob_subdiv, seed=7)
    rng = np.random.default_rng(3)
    for ix in range(cols_x):
        for iz in range(cols_z):
            cx, cz = ix + 0.5, iz + 0.5
            v, t = _box([cx - 0.12, 0, cz - 0.12], [cx + 0.12, hy, cz + 0.12])
            parts.append((v, t, np.full(len(t), stone, np.int32)))
            # Clutter blob on alternating cells.
            if (ix + iz) % 2 == 0:
                s = 0.18 + 0.1 * rng.random()
                pos = np.array([cx, 0.35, cz], np.float32)
                bv = blob_v0 * s + pos
                parts.append((bv, blob_f0, np.full(len(blob_f0), accent, np.int32)))
    verts, tris, mat_id = merge_meshes(parts)
    materials = Materials.make(
        albedo=[[0.70, 0.68, 0.62], [0.52, 0.50, 0.46], [0.45, 0.30, 0.22]],
        mirror=[0.0, 0.0, 0.25],
        device=device,
    )
    lights = Lights.make(
        position=np.array(
            [[hx * 0.3, hy - 0.4, hz * 0.3], [hx * 0.7, hy - 0.4, hz * 0.7]], np.float32
        ),
        intensity=np.array([[60.0, 58.0, 52.0], [50.0, 52.0, 58.0]], np.float32),
        device=device,
    )
    scene = Scene.make(verts, tris, mat_id, materials, lights, device=device)
    cam = dict(
        position=(hx * 0.5, 1.7, hz - 0.6),
        look_at=(hx * 0.5, 1.4, 0.0),
        fov_y_deg=55.0,
    )
    return scene, cam


def bench_scene(num_blobs: int = 5, subdiv: int = 5, *, device) -> tuple[Scene, dict]:
    """Headline-benchmark scene: ~100k triangles (num_blobs * 20480 + ground)
    of displaced blobs over a ground plane — organic, BVH-friendly geometry
    at the BASELINE '100k-tri scene' operating point."""
    rng = np.random.default_rng(11)
    parts = []
    for i in range(num_blobs):
        v, f = _displaced_blob(subdiv, seed=i)
        s = 0.45 + 0.25 * rng.random()
        pos = np.array([
            2.2 * np.cos(2 * np.pi * i / num_blobs),
            s + 0.05,
            2.2 * np.sin(2 * np.pi * i / num_blobs),
        ], np.float32)
        parts.append((v * s + pos, f, np.full(len(f), i % 3, np.int32)))
    gv, gf = _quad([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6])
    parts.append((gv, gf, np.full(len(gf), 1, np.int32)))
    verts, tris, mat_id = merge_meshes(parts)
    materials = Materials.make(
        albedo=[[0.62, 0.55, 0.45], [0.50, 0.52, 0.55], [0.35, 0.45, 0.60]],
        device=device,
    )
    lights = Lights.make(
        position=np.array([[4.0, 6.0, 3.0]], np.float32),
        intensity=np.array([[45.0, 44.0, 42.0]], np.float32),
        device=device,
    )
    scene = Scene.make(verts, tris, mat_id, materials, lights, device=device)
    cam = dict(position=(0.0, 2.6, 5.5), look_at=(0.0, 0.6, 0.0), fov_y_deg=50.0)
    return scene, cam


def random_tri_soup(num_tris: int, seed: int = 0, extent: float = 1.0, *,
                    device) -> Scene:
    """Random small triangles in a cube — adversarial fixture for traversal
    correctness tests (no spatial coherence)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, size=(num_tris, 1, 3))
    offsets = rng.normal(scale=0.05 * extent, size=(num_tris, 3, 3))
    verts = (centers + offsets).reshape(-1, 3).astype(np.float32)
    tris = np.arange(num_tris * 3, dtype=np.int32).reshape(-1, 3)
    materials = Materials.make(albedo=[[0.7, 0.7, 0.7]], device=device)
    lights = Lights.make(
        position=np.array([[0.0, 3.0, 0.0]], np.float32),
        intensity=np.array([[10.0, 10.0, 10.0]], np.float32),
        device=device,
    )
    return Scene.make(verts, tris, np.zeros(num_tris, np.int32), materials, lights,
                      device=device)
