"""Build and load the CUDA kernels of kernels/csrc/ (nvcc -> shared library
with a plain C interface -> ctypes).

The library is compiled for sm_90a at first use, into build/tracer_torch/
at the repository root, under a name keyed by a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once.
Each source compiles to an object in its own nvcc process, all started
together, and one more nvcc links the objects into the library. The
sources share the header csrc/common.cuh.
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
SOURCES = ("traversal2.cu", "stream.cu", "traversal.cu", "traversal3.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracer_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))

_P = ctypes.c_void_p
_I = ctypes.c_int
_CLOSEST = [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P]
# words, counts, k_cap, tr, o4, d4, tmax, w, n_cl, c, order, ends, n_ranks,
# next_seg, grid, occ, stream
_ANYHIT = [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _P]
# Entry points (see the extern "C" block of each source): name -> argtypes.
_SIGNATURES = {
    "tt_closest": _CLOSEST,      # traversal2.cu
    "tt_closest_fast": _CLOSEST,
    "tt_anyhit": _ANYHIT,
    "st_closest": _CLOSEST,      # stream.cu
    "st_anyhit": _ANYHIT,
    # traversal.cu. offs, clusters, counts, n_tiles, tr, o4, d4, w, tri_ids, c, order, ends,
    # n_ranks, next_seg, grid, key, bt, btri, bu, bv, stream
    "wl_closest": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                   _P, _P],
    # offs, clusters, counts, tr, o4, d4, tmax, w, c, order, ends, n_ranks, next_seg, grid,
    # occ, stream
    "wl_anyhit": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P],
    "pr_closest": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P],   # traversal3.cu
    "pr_anyhit": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtracer_torch_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise on the first failure, else return
    the compilers' joined output."""
    logs, failed = [], None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def _spawn(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build() -> tuple[Path, str]:
    """Compile the library unless it is already built; returns (path, the
    compilers' log: ptxas register/spill lines, empty when cached)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        log = _run([_spawn([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)])
                    for s, o in zip(SOURCES, objs)])
        log += _run([_spawn([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out, log


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
