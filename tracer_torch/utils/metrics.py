"""Structured metrics and profiling hooks (torch counterpart of
tracer/utils/metrics.py): a long-running loop (fit, animate) can write one
JSON line a step to a JSONL file, from rank 0 only where torch.distributed
is initialised, and a region can be traced by torch.profiler into a Chrome
trace (`profile_trace`).

The program's spans and read-back counters (`span`, `readback`, `count`)
go to a recorder that is on only while a torch.profiler session runs
(`profile_trace`, or any profiler of the caller's). Off, a span is one
check. On, each span is a `record_function` range, so it shows as a named
range in the profiler's Chrome trace on one clock with the device's
kernels, and a record: its name, its parent span's name, the unit it
belongs to, host start and end, and on a CUDA device a pair of timing
events on the current stream. A root span ("frame" around a render fn's
frame, "grad.step" around a grad step) opens a new unit; the spans and
counts inside it share that unit's id. `span_totals` sums the records of
the units under a root.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

ROOTS = ("frame", "grad.step")
# The span records a recorder keeps; past them it counts what it drops.
MAX_RECORDS = 1 << 16


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
    the temporary directory). The program's spans ("frame", "cull.stage1",
    "readback.cull.k", ...) appear in it as named ranges, and the recorder
    (`span_totals`) is on for the block. Yields the directory, or None when
    not enabled."""
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


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

class SpanRecord:
    """One span: name, parent span's name, unit id, host start and end
    (perf_counter_ns), and its CUDA events (None on the host clock)."""
    __slots__ = ("name", "parent", "unit", "t0", "t1", "e0", "e1")

    def __init__(self, name: str, parent: str | None, unit: int | None):
        self.name, self.parent, self.unit = name, parent, unit
        self.t0 = self.t1 = self.e0 = self.e1 = None

    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def stream_ms(self) -> float:
        return self.e0.elapsed_time(self.e1) if self.e0 is not None else self.host_ms()


class Recorder:
    """The span records and per-unit counters of one process, at most
    MAX_RECORDS records."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.records: list[SpanRecord] = []
        self.units: dict[int, dict] = {}       # unit id -> {"root", "counts"}
        self.open: list[str] = []              # names of the open spans
        self.unit: int | None = None
        self.dropped = 0
        self._next_unit = 0

    def count(self, name: str, n: int = 1):
        if self.unit is not None:
            counts = self.units[self.unit]["counts"]
            counts[name] = counts.get(name, 0) + n

    def totals(self, root: str) -> dict:
        units = {u for u, v in self.units.items() if v["root"] == root}
        if not units:
            return {}
        if any(r.e0 is not None for r in self.records):
            torch.cuda.synchronize()
        spans: dict[str, dict] = {}
        for r in self.records:
            if r.unit in units and r.t1 is not None:
                t = spans.setdefault(r.name, {"stream_ms": 0.0, "host_ms": 0.0, "calls": 0})
                t["stream_ms"] += r.stream_ms()
                t["host_ms"] += r.host_ms()
                t["calls"] += 1
        counters: dict[str, int] = {}
        for u in units:
            for k, n in self.units[u]["counts"].items():
                counters[k] = counters.get(k, 0) + n
        return {"units": len(units), "spans": spans, "counters": counters,
                "dropped": self.dropped}


class _Span:
    """A span while the recorder is on: a record_function range and a
    record (None once the recorder is full)."""
    __slots__ = ("rec", "name", "events", "rf", "record", "prev_unit")

    def __init__(self, rec: Recorder, name: str, events: bool):
        self.rec, self.name, self.events = rec, name, events

    def __enter__(self):
        rec = self.rec
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.prev_unit = rec.unit
        parent = rec.open[-1] if rec.open else None
        rec.open.append(self.name)
        if len(rec.records) >= MAX_RECORDS:
            rec.dropped += 1
            self.record = None
            if self.name in ROOTS:
                rec.unit = None
            return self
        if self.name in ROOTS:
            rec.unit = rec._next_unit
            rec._next_unit += 1
            rec.units[rec.unit] = {"root": self.name, "counts": {}}
        r = self.record = SpanRecord(self.name, parent, rec.unit)
        rec.records.append(r)
        if self.events and torch.cuda.is_initialized():
            r.e0 = torch.cuda.Event(enable_timing=True)
            r.e0.record()
        r.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        r = self.record
        if r is not None:
            r.t1 = time.perf_counter_ns()
            if r.e0 is not None:
                r.e1 = torch.cuda.Event(enable_timing=True)
                r.e1.record()
        self.rec.open.pop()
        self.rec.unit = self.prev_unit
        self.rf.__exit__(*exc)
        return False


_RECORDER = Recorder()
_OFF = contextlib.nullcontext()
_on = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager around a part of the program: nothing but the
    check while no profiler runs; a recorded span while one does."""
    return _Span(_RECORDER, name, True) if _on() else _OFF


def readback(x: torch.Tensor, site: str):
    """x.tolist() (a Python scalar for a 0-d tensor): a read of device
    values by the host. While the recorder is on it also raises the unit's
    counter "readbacks" and records a span "readback.<site>" on the host
    clock: the time the host sat blocked."""
    if not _on():
        return x.tolist()
    _RECORDER.count("readbacks")
    with _Span(_RECORDER, "readback." + site, False):
        return x.tolist()


def count(name: str, n: int = 1):
    """Raise the current unit's counter `name` by n (a no-op off)."""
    if _on():
        _RECORDER.count(name, n)


def span_totals(root: str) -> dict:
    """Over the recorded units under `root` ("frame" or "grad.step"):
    {"units": n, "spans": {name: {"stream_ms", "host_ms", "calls"}},
    "counters": {name: total}, "dropped": records dropped}, stream ms from
    the CUDA events on a card and the host clock elsewhere (synchronises the
    device first); {} when no such unit was recorded."""
    return _RECORDER.totals(root)


def span_records() -> list[SpanRecord]:
    """The recorder's span records, in the order they opened."""
    return list(_RECORDER.records)


def reset():
    """Empty the recorder."""
    _RECORDER.reset()
