"""Mesh helpers of the frozen scene generators: a numpy copy of the
procedural fixtures the benchmark's scenes are made from. The copy is
frozen so that the benchmark's inputs stay the same whatever later changes
the program's own generators; a CPU test holds it to them."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """One scene as numpy arrays: verts (V, 3) f32, tris (T, 3) i32, mat_id
    (T,) i32, normals (V, 3) f32 area-weighted vertex normals; materials
    albedo (M, 3), emission (M, 3), mirror (M,), specular (M,), shininess
    (M,); lights position (L, 3), intensity (L, 3); the preset camera
    (position, look_at, fov_y_deg)."""

    verts: np.ndarray
    tris: np.ndarray
    mat_id: np.ndarray
    normals: np.ndarray
    albedo: np.ndarray
    emission: np.ndarray
    mirror: np.ndarray
    specular: np.ndarray
    shininess: np.ndarray
    light_pos: np.ndarray
    light_int: np.ndarray
    camera: dict


def quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise winding)."""
    return np.array([a, b, c, d], np.float32), np.array([[0, 1, 2], [0, 2, 3]], np.int32)


@functools.cache
def _icosphere_cached(subdiv: int) -> tuple[np.ndarray, np.ndarray]:
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
        e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0), axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        mids = v[uniq[:, 0]] + v[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = len(v) + inv.reshape(-1)
        n = len(f)
        ab, bc, ca = mid_idx[:n], mid_idx[n:2 * n], mid_idx[2 * n:]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)], axis=0)
        v = np.concatenate([v, mids], axis=0)
    return v.astype(np.float32), f.astype(np.int32)


def icosphere(subdiv: int) -> tuple[np.ndarray, np.ndarray]:
    """Icosahedron subdivided `subdiv` times, radius 1: 20*4^subdiv faces."""
    v, f = _icosphere_cached(subdiv)
    return v.copy(), f.copy()


def displaced_blob(subdiv: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Icosphere with a smooth multi-frequency radial displacement."""
    v, f = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    r = np.ones(len(v))
    for freq, amp in [(1.5, 0.22), (3.1, 0.10), (6.3, 0.045)]:
        k = rng.normal(size=(3, 3)) * freq
        ph = rng.uniform(0, 2 * np.pi, size=3)
        r += amp * np.sin(v @ k.T + ph).sum(axis=-1) / 3.0
    return (v * r[:, None]).astype(np.float32), f


def merge_meshes(parts):
    """Concatenate (verts, tris, mat_id) triples with index fix-up."""
    verts, tris, mats = [], [], []
    off = 0
    for v, t, m in parts:
        verts.append(v)
        tris.append(np.asarray(t) + off)
        mats.append(m)
        off += len(v)
    return (np.concatenate(verts, axis=0), np.concatenate(tris, axis=0),
            np.concatenate(mats, axis=0))


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def scene_arrays(parts, albedo, light_pos, light_int, camera, mirror=None) -> SceneArrays:
    """SceneArrays of merged parts with the port's material defaults:
    emission 0, mirror 0 unless given, specular 0, shininess 32."""
    verts, tris, mat_id = merge_meshes(parts)
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    albedo = np.asarray(albedo, np.float32)
    m = albedo.shape[0]
    return SceneArrays(
        verts=verts, tris=tris, mat_id=np.asarray(mat_id, np.int32),
        normals=vertex_normals(verts, tris), albedo=albedo,
        emission=np.zeros((m, 3), np.float32),
        mirror=np.zeros(m, np.float32) if mirror is None else np.asarray(mirror, np.float32),
        specular=np.zeros(m, np.float32), shininess=np.full(m, 32.0, np.float32),
        light_pos=np.asarray(light_pos, np.float32), light_int=np.asarray(light_int, np.float32),
        camera=camera)
