"""Structured metrics and profiling hooks (torch counterpart of
tracer/utils/metrics.py): a long-running loop (fit, animate) can write one
JSON line a step to a JSONL file, from rank 0 only where torch.distributed
is initialised, and a region can be traced by torch.profiler into a Chrome
trace (`profile_trace`)."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch


def is_host0() -> bool:
    """Rank 0 of torch.distributed where it is initialised; True otherwise."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricsLogger:
    """Append-only JSONL metrics writer; a silent no-op off rank 0.

    append=True keeps the existing file (a resumed run must not erase the
    earlier steps' history); the default truncates it, one file a run."""

    def __init__(self, path: str | None, host0_only: bool = True, append: bool = False):
        self._path = path
        self._enabled = bool(path) and (not host0_only or is_host0())
        self._t0 = time.time()
        if self._enabled:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            if not append:
                with open(path, "w"):
                    pass

    def log(self, **fields) -> None:
        if not self._enabled:
            return
        rec = {"t": round(time.time() - self._t0, 4), **fields}
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def profile_trace(enabled: bool, trace_dir: str | None = None):
    """torch.profiler over the block, the host's activity and the card's
    where CUDA is available, written as a Chrome trace (trace.json) into
    `trace_dir` (default: $TRACER_PROFILE_DIR, else tracer_profile under
    the temporary directory). Yields the directory, or None when not
    enabled."""
    if not enabled:
        yield None
        return
    d = trace_dir or os.environ.get("TRACER_PROFILE_DIR",
                                    os.path.join(tempfile.gettempdir(), "tracer_profile"))
    os.makedirs(d, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield d
    prof.export_chrome_trace(os.path.join(d, "trace.json"))
    print(f"[profile] torch.profiler trace written to {d}", flush=True)
