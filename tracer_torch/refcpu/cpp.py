"""ctypes binding to the C++ fp64 oracle, cpp/oracle.cpp (the port's own
counterpart of tracer/refcpu/cpp.py): a scalar, double-precision
Moller-Trumbore renderer over a median-split BVH that shares no code with
either package, so a frame that agrees with it is evidence of correctness.

The oracle is built at first use into build/tracer_torch/
(utils.native.build_shared). cpp_render raises OracleUnavailable when it
does not build or load; nothing falls back. It reads the scene and camera
through numpy and imports nothing of the port's rendering code.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess

import numpy as np

from tracer_torch.refcpu.oracle import host_array as host
from tracer_torch.utils.native import build_shared


class OracleUnavailable(RuntimeError):
    pass


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, str]:
    """(the library with its argtypes declared, "") or (None, why not);
    built and loaded once a process."""
    try:
        lib = ctypes.CDLL(str(build_shared("oracle.cpp")))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        return None, f"{type(e).__name__}: {e}"
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.oracle_render.restype = ctypes.c_int
    lib.oracle_render.argtypes = [
        f32p, ctypes.c_int,          # verts, n_verts
        i32p, ctypes.c_int,          # tris, n_tris
        i32p,                        # mat_id
        f32p, f32p, f32p,            # albedo, emission, mirror
        f32p, f32p,                  # specular, shininess
        f32p,                        # normals
        f32p, f32p, ctypes.c_int,    # light_pos, light_int, n_lights
        f32p,                        # cam[10]
        ctypes.c_int, ctypes.c_int,  # height, width
        ctypes.c_int, ctypes.c_int,  # max_bounces, smooth
        f32p, ctypes.c_float,        # sky, ambient
        f32p,                        # out
    ]
    return lib, ""


def available() -> bool:
    """Whether the oracle builds and loads here."""
    return _load()[0] is not None


def cpp_render(scene, camera, height: int, width: int, max_bounces: int = 1,
               smooth_shading: bool = True, sky_color=(0.0, 0.0, 0.0),
               ambient: float = 0.04) -> np.ndarray:
    """The oracle's (H, W, 3) float32 frame of (scene, camera): the shading
    of refcpu.oracle.cpu_render in fp64."""
    lib, why = _load()
    if lib is None:
        raise OracleUnavailable(why)
    verts = host(scene.verts, np.float32)
    tris = host(scene.tris, np.int32)
    if tris.size and not (0 <= tris.min() and tris.max() < verts.shape[0]):
        raise ValueError("triangle indices out of the vertex range")
    mats, lights = scene.materials, scene.lights
    cam = np.concatenate([host(camera.position, np.float32), host(camera.look_at, np.float32),
                          host(camera.up, np.float32),
                          np.asarray([float(camera.fov_y)], np.float32)])
    out = np.empty((height, width, 3), np.float32)
    rc = lib.oracle_render(
        verts, verts.shape[0], tris, tris.shape[0], host(scene.mat_id, np.int32),
        host(mats.albedo, np.float32), host(mats.emission, np.float32),
        host(mats.mirror, np.float32), host(mats.specular, np.float32),
        host(mats.shininess, np.float32), host(scene.normals, np.float32),
        host(lights.position, np.float32), host(lights.intensity, np.float32),
        lights.position.shape[0], cam, height, width, max_bounces,
        1 if smooth_shading else 0, host(sky_color, np.float32), float(ambient), out)
    if rc != 0:
        raise OracleUnavailable(f"oracle_render returned {rc}")
    return out
