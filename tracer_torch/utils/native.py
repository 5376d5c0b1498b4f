"""Build a C++ source of the repository's cpp/ directory into a shared
library with a plain C interface, for ctypes (the counterpart of how
tracer/refcpu/cpp.py and tracer/scene/cpp_loader.py build theirs).

The library lands in build/tracer_torch/ at the repository root, under a
name keyed by a hash of the source and the flags, so a changed source
rebuilds and an unchanged one loads at once; the port never loads the
libraries the JAX package builds beside the sources. The flags carry no
-march=native, so a library built on one machine runs on another.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CPP_DIR = REPO / "cpp"
BUILD_DIR = REPO / "build" / "tracer_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def build_shared(source: str) -> Path:
    """cpp/<source> -> build/tracer_torch/lib<stem>_<hash>.so, compiled by
    g++ unless already built. Raises FileNotFoundError for a missing source
    or compiler, RuntimeError (with the compiler's output) when g++ fails,
    subprocess.TimeoutExpired after 300 s."""
    src = CPP_DIR / source
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
