"""Scene representation: geometry + materials + lights as frozen dataclasses
of tensors (torch counterpart of tracer/scene/types.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tracer_torch.kernels.gather import gather_rows


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights: position (L, 3), intensity (L, 3) RGB radiant power."""

    position: torch.Tensor
    intensity: torch.Tensor

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def make(position, intensity, *, device) -> "Lights":
        return Lights(position=_f32(position, device),
                      intensity=_f32(intensity, device))


@dataclasses.dataclass(frozen=True)
class Materials:
    """Per-material SoA, indexed by Scene.mat_id: albedo (M, 3), emission
    (M, 3), mirror (M,), specular (M,) Phong ks, shininess (M,) exponent."""

    albedo: torch.Tensor
    emission: torch.Tensor
    mirror: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor

    @staticmethod
    def make(albedo, emission=None, mirror=None, specular=None,
             shininess=None, *, device) -> "Materials":
        albedo = np.asarray(albedo, np.float32)
        m = albedo.shape[0]
        pick = lambda x, default: default if x is None else x
        return Materials(
            albedo=_f32(albedo, device),
            emission=_f32(pick(emission, np.zeros((m, 3))), device),
            mirror=_f32(pick(mirror, np.zeros((m,))), device),
            specular=_f32(pick(specular, np.zeros((m,))), device),
            shininess=_f32(pick(shininess, np.full((m,), 32.0)), device),
        )


@dataclasses.dataclass(frozen=True)
class Scene:
    """verts (V, 3) f32; tris (T, 3) i32; mat_id (T,) i32; materials;
    lights; normals (V, 3) per-vertex shading normals."""

    verts: torch.Tensor
    tris: torch.Tensor
    mat_id: torch.Tensor
    materials: Materials
    lights: Lights
    normals: torch.Tensor

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @staticmethod
    def make(verts, tris, mat_id, materials: Materials, lights: Lights,
             normals=None, *, device) -> "Scene":
        verts = np.asarray(verts, np.float32)
        tris = np.asarray(tris, np.int32)
        if normals is None:
            normals = compute_vertex_normals(verts, tris)
        return Scene(
            verts=_f32(verts, device),
            tris=torch.as_tensor(tris, device=device),
            mat_id=torch.as_tensor(np.asarray(mat_id, np.int32), device=device),
            materials=materials,
            lights=lights,
            normals=_f32(normals, device),
        )


def compute_vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host-side, at load time)."""
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def _face_normals(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Area-weighted face normals (T, 3): cross(v1 - v0, v2 - v0)."""
    tl = tris.long()
    v0, v1, v2 = verts[tl[:, 0]], verts[tl[:, 1]], verts[tl[:, 2]]
    return torch.linalg.cross(v1 - v0, v2 - v0)


def _unit(acc: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp_min(norm, 1e-20)


def compute_vertex_normals_torch(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """compute_vertex_normals in tensor ops, differentiable in verts (the
    counterpart of compute_vertex_normals_jnp): the face normals summed
    into their vertices by index_add. Used by the grad step's jnp tier so
    that smooth-shading normals follow the optimized vertices. On CUDA
    index_add accumulates by atomics, so the last bits may vary from run to
    run; make_vertex_normal_fn's gather does not."""
    fn = _face_normals(verts, tris)
    out = torch.zeros_like(verts)
    for k in range(3):
        out = out.index_add(0, tris[:, k].long(), fn)
    return _unit(out)


def make_vertex_normal_fn(tris_np, n_verts: int, *, device):
    """A differentiable verts -> normals closure over a fixed topology: a
    (V, D) face-incidence table (D the largest vertex degree) is built once
    in numpy and moved to `device`, and each call sums every vertex's D
    face normals by one gather (kernels/gather.py `gather_rows`: its
    backward sums in one fixed order, where ATen's backward of x[idx] on
    the CPU varies its order from call to call). Padding slots index a zero
    face normal appended past the real faces. Deterministic on every
    device."""
    tris_np = np.asarray(tris_np)
    n_faces = len(tris_np)
    # (vertex, face) incidence pairs grouped by vertex with a stable sort: a
    # vertex can sit in the same corner column of many faces.
    pair_v = tris_np.T.reshape(-1).astype(np.int64)
    pair_f = np.tile(np.arange(n_faces, dtype=np.int64), 3)
    order = np.argsort(pair_v, kind="stable")
    pair_v, pair_f = pair_v[order], pair_f[order]
    counts = np.bincount(pair_v, minlength=n_verts)
    inc = np.full((n_verts, max(1, int(counts.max()))), n_faces, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    inc[pair_v, np.arange(len(pair_v)) - starts[pair_v]] = pair_f
    inc_dev = torch.as_tensor(inc, device=device)
    tris_dev = torch.as_tensor(tris_np.astype(np.int64), device=device)

    def normals_of(verts: torch.Tensor) -> torch.Tensor:
        fn = _face_normals(verts, tris_dev)
        fn_pad = torch.cat([fn, fn.new_zeros((1, 3))])
        return _unit(gather_rows(fn_pad, inc_dev).sum(dim=1))

    return normals_of


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
