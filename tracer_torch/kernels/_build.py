"""Build and load the CUDA kernels of kernels/csrc/ (nvcc -> shared library
with a plain C interface -> ctypes).

The library is compiled for sm_90a at first use, into build/tracer_torch/
at the repository root, under a name keyed by a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once.
-fmad=false and the absence of fast math keep every product and the IEEE
divide rounded as the plain PyTorch versions round them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("traversal2.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracer_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry points of traversal2.cu: name -> argtypes (see its extern "C" block).
_SIGNATURES = {
    "tt_closest": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
    "tt_closest_fast": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
    "tt_anyhit": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtracer_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library unless it is already built; returns (path, the
    compiler's log: ptxas register/spill lines, empty when cached)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
