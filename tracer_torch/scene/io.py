"""Wavefront OBJ loading and saving (torch counterpart of
tracer/scene/io.py): v / f (with the v, v//vn, v/vt/vn forms), negative
indices, `usemtl` material switching and a minimal .mtl parser (Kd diffuse,
Ke emission, Ks as the mirror weight). Polygons are fan-triangulated.
Parsing runs on the host; load_obj returns a Scene on the requested device.
"""
from __future__ import annotations

import os

import numpy as np

from tracer_torch.scene.cpp_loader import LoaderUnavailable, parse_obj_native
from tracer_torch.scene.types import Lights, Materials, Scene

_DEFAULT_MTL = {"Kd": (0.7, 0.7, 0.7), "Ke": (0.0, 0.0, 0.0), "Ks": (0.0, 0.0, 0.0)}


def _parse_mtl(path: str) -> dict[str, dict]:
    """{material name: {"Kd", "Ke", "Ks": 3-tuples}}; {} for a missing file."""
    mats: dict[str, dict] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = dict(_DEFAULT_MTL)
            elif cur and parts[0] in ("Kd", "Ke", "Ks"):
                mats[cur][parts[0]] = tuple(float(x) for x in parts[1:4])
    return mats


def _parse_obj_python(path: str):
    """Pure-Python OBJ parse, the definition of record and the fallback of
    the native parser -> (verts, tris, mat_of_tri, mat_names, mtl_lib)."""
    verts: list = []
    tris: list = []
    mat_of_tri: list = []
    mtl_lib: dict[str, dict] = {}
    mat_names: list[str] = ["default"]
    mat_index = {"default": 0}
    cur_mat = 0

    def vidx(tok: str, n: int) -> int:
        i = int(tok.split("/")[0])
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "mtllib":
                # OBJ allows several library files on one mtllib line.
                for lib in parts[1:]:
                    mtl_lib.update(_parse_mtl(os.path.join(os.path.dirname(path), lib)))
            elif tag == "usemtl":
                name = parts[1]
                if name not in mat_index:
                    mat_index[name] = len(mat_names)
                    mat_names.append(name)
                cur_mat = mat_index[name]
            elif tag == "f":
                n = len(verts)
                idx = [vidx(t, n) for t in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append([idx[0], idx[k], idx[k + 1]])
                    mat_of_tri.append(cur_mat)
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(tris, np.int32).reshape(-1, 3),
            np.asarray(mat_of_tri, np.int32), mat_names, mtl_lib)


def _parse_obj_native(path: str):
    """The C++ parser's result in _parse_obj_python's form."""
    verts, tris, mat, names, libs = parse_obj_native(path)
    mtl_lib: dict[str, dict] = {}
    for lib in libs:
        mtl_lib.update(_parse_mtl(os.path.join(os.path.dirname(path), lib)))
    return verts, tris, mat, names, mtl_lib


def load_obj(path: str, default_light: bool = True, native: bool | str = "auto", *,
             device) -> Scene:
    """Parse an OBJ file into a Scene on `device`, with area-weighted
    vertex normals.

    native: "auto" tries the C++ parser (cpp/objloader.cpp, scene.cpp_loader)
    and falls back to the Python one when it does not build or load; True
    requires it; False skips it. Both give identical Scenes. With
    default_light, one point light at the bounding box's centre plus (0.3,
    0.45, 0.25) times its diagonal, of intensity diagonal squared."""
    parsed = None
    if native not in ("auto", True, False):
        raise ValueError(f"native must be 'auto', True or False, got {native!r}")
    if native in ("auto", True):
        try:
            parsed = _parse_obj_native(path)
        except LoaderUnavailable:
            if native is True:
                raise
    if parsed is None:
        parsed = _parse_obj_python(path)
    verts, tris, mat_of_tri, mat_names, mtl_lib = parsed
    albedo, emission, mirror = [], [], []
    for name in mat_names:
        m = mtl_lib.get(name, _DEFAULT_MTL)
        albedo.append(m["Kd"])
        emission.append(m["Ke"])
        mirror.append(float(np.mean(m["Ks"])))
    materials = Materials.make(albedo=np.asarray(albedo, np.float32),
                               emission=np.asarray(emission, np.float32),
                               mirror=np.asarray(mirror, np.float32), device=device)
    if default_light:
        lo, hi = verts.min(0), verts.max(0)
        center, diag = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
        lights = Lights.make(
            position=np.asarray([center + np.array([0.3, 0.45, 0.25]) * diag], np.float32),
            intensity=np.full((1, 3), diag * diag, np.float32), device=device)
    else:
        lights = Lights.make(position=np.zeros((0, 3), np.float32),
                             intensity=np.zeros((0, 3), np.float32), device=device)
    return Scene.make(verts, tris, np.asarray(mat_of_tri, np.int32), materials, lights,
                      device=device)


def save_obj(path: str, verts, tris) -> None:
    """Minimal OBJ writer (v and f lines) of (V, 3) vertices and (T, 3)
    triangles, numpy arrays or tensors."""
    verts = verts.detach().cpu().numpy() if hasattr(verts, "detach") else np.asarray(verts)
    tris = tris.detach().cpu().numpy() if hasattr(tris, "detach") else np.asarray(tris)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
