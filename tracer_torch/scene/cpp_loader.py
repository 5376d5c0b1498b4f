"""ctypes binding to the native OBJ parser, cpp/objloader.cpp (torch
counterpart of tracer/scene/cpp_loader.py).

The parser is built at first use into build/tracer_torch/
(utils.native.build_shared). parse_obj_native raises LoaderUnavailable on
any build or load problem; scene.io.load_obj(native="auto") then falls back
to the Python parser, which stays the definition of record.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from tracer_torch.utils.native import build_shared


class LoaderUnavailable(RuntimeError):
    pass


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, str]:
    """(the library with its argtypes declared, "") or (None, why not);
    built and loaded once a process."""
    try:
        lib = ctypes.CDLL(str(build_shared("objloader.cpp")))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        return None, f"{type(e).__name__}: {e}"
    i64 = ctypes.c_int64
    lib.obj_parse.restype = i64
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_counts.restype = None
    lib.obj_counts.argtypes = [i64] + [ctypes.POINTER(i64)] * 4
    lib.obj_copy.restype = None
    lib.obj_copy.argtypes = [
        i64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [i64]
    return lib, ""


def _lib() -> ctypes.CDLL:
    lib, why = _load()
    if lib is None:
        raise LoaderUnavailable(why)
    return lib


def available() -> bool:
    """Whether the native parser builds and loads here."""
    return _load()[0] is not None


def parse_obj_native(path: str):
    """Parse `path` with the C++ parser -> (verts (Nv, 3) f32, tris (Nt, 3)
    i32, mat_of_tri (Nt,) i32, mat_names list[str] in index order,
    mtllib_paths list[str])."""
    lib = _lib()
    h = lib.obj_parse(os.fsencode(path))
    if h < 0:
        raise LoaderUnavailable(f"obj_parse failed for {path}")
    try:
        nv, nt, nl, ll = (ctypes.c_int64() for _ in range(4))
        lib.obj_counts(h, ctypes.byref(nv), ctypes.byref(nt), ctypes.byref(nl),
                       ctypes.byref(ll))
        verts = np.empty((nv.value, 3), np.float32)
        tris = np.empty((nt.value, 3), np.int32)
        mat = np.empty((nt.value,), np.int32)
        names_buf = ctypes.create_string_buffer(max(nl.value, 1))
        libs_buf = ctypes.create_string_buffer(max(ll.value, 1))
        lib.obj_copy(h, verts, tris, mat, names_buf, libs_buf)
        names = names_buf.raw[:nl.value].decode() if nl.value else ""
        libs = libs_buf.raw[:ll.value].decode() if ll.value else ""
        return (verts, tris, mat, names.split("\n") if names else [],
                libs.split("\n") if libs else [])
    finally:
        lib.obj_free(h)
