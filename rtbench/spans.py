"""The benchmark's own tracing of the program: spans around the
module-level names the program calls through, a bounded profiler slice,
and what the per-layer readers read from them.

A span target is "package.module:name". Installing it replaces that
attribute of the module by a wrapper that records two CUDA events (no
sync) around the call; the events are read once the window has closed. A
target that is not there raises: a renamed function stops the traced run
instead of reporting 0, and a benchmark change points the metric at the
new name. While the profiler runs, the wrappers also open a
torch.profiler.record_function range of the span's name, so that the idle
gaps of the slice can be named by what the host was doing.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch

# Units (frames or steps) at the start of the window whose wrapped calls
# keep their arguments and results for the readers (the roofline's counts).
KEEP_UNITS = 8
# The profiled slice: at least PROFILE_MIN_UNITS units and PROFILE_SECONDS,
# at most PROFILE_MAX_UNITS.
PROFILE_SECONDS = 1.0
PROFILE_MIN_UNITS = 4
PROFILE_MAX_UNITS = 60
BREAKDOWN_ENTRIES = 10


class Clock:
    """CUDA events on a card; the host clock on the CPU (tests only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Tracer:
    """Span records (name, unit, start, end) of the wrapped calls."""

    def __init__(self, device: torch.device):
        self.device = device
        self.clock = Clock(device)
        self.unit = 0
        self.recording = False
        self.annotate = False
        self.records = []
        self.kept: dict[str, list] = {}
        self._undo = []

    def install(self, name: str, target: str, keep: bool = False):
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        if not hasattr(mod, attr):
            raise AttributeError(f"span {name!r}: {target} does not exist; the metric that "
                                 f"reads it must be pointed at the program's new name")
        orig = getattr(mod, attr)

        def wrapped(*args, **kwargs):
            if not (self.recording or self.annotate):
                return orig(*args, **kwargs)
            ctx = (torch.profiler.record_function(name) if self.annotate
                   else contextlib.nullcontext())
            with ctx:
                a = self.clock.mark()
                out = orig(*args, **kwargs)
                b = self.clock.mark()
            if self.recording:
                self.records.append((name, self.unit, a, b))
                if keep and self.unit < KEEP_UNITS:
                    self.kept.setdefault(name, []).append((self.unit, args, out))
            return out

        setattr(mod, attr, wrapped)
        self._undo.append((mod, attr, orig))

    def uninstall(self):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    @contextlib.contextmanager
    def unit_span(self, unit: int):
        """The harness's own span "unit" around one frame or step."""
        self.unit = unit
        a = self.clock.mark() if self.recording else None
        yield
        if self.recording:
            self.records.append(("unit", unit, a, self.clock.mark()))

    def data(self, n_units: int, profile: dict | None) -> "TraceData":
        if self.clock.cuda:
            torch.cuda.synchronize(self.device)
        ms: dict[str, dict[int, float]] = {}
        for name, unit, a, b in self.records:
            per = ms.setdefault(name, {})
            per[unit] = per.get(unit, 0.0) + self.clock.ms(a, b)
        return TraceData(n_units, ms, self.kept, profile)


class TraceData:
    """What a per-layer reader reads: the span milliseconds of each unit, the
    kept calls and the profiled slice's summary."""

    def __init__(self, n_units: int, ms: dict, kept: dict, profile: dict | None):
        self.n_units = n_units
        self._ms = ms
        self._kept = kept
        self.profile = profile

    def per_unit_ms(self, name: str) -> float | None:
        """Mean over the window's units of the span's milliseconds in a unit;
        None where the span never ran."""
        per = self._ms.get(name)
        if not per or not self.n_units:
            return None
        return sum(per.values()) / self.n_units

    def units_ms(self, names, units) -> float:
        return sum(self._ms.get(n, {}).get(u, 0.0) for n in names for u in units)

    def kept(self, name: str) -> list:
        """[(unit, args, result)] of the span's calls in the first KEEP_UNITS units."""
        return self._kept.get(name, [])


def busy_ms(events) -> float:
    """Union of the device-activity intervals of a profile, in ms."""
    return sum(b - a for a, b in device_intervals(events)) / 1e3


def device_intervals(events) -> list[tuple[float, float]]:
    """The merged device-activity intervals of a profile (us)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def short_name(name: str, limit: int = 100) -> str:
    """A kernel's or operation's name without its return type, anonymous
    namespace and argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


def top_device_ops(events, n: int = BREAKDOWN_ENTRIES) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    from torch.autograd import DeviceType

    tot: dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            k = short_name(e.name)
            tot[k] = tot.get(k, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, n: int = BREAKDOWN_ENTRIES) -> list:
    """[[what the host was doing, seconds]] of the device's idle gaps inside
    the slice, summed by the innermost span ("no span" outside them all) and
    host operation open on the busiest host thread when the gap began,
    longest first. One sweep over the host events in order of start, with a
    stack of the open ones."""
    from collections import Counter

    from torch.autograd import DeviceType

    busy = device_intervals(events)
    gaps = [(b, a2) for (_, b), (a2, _) in zip(busy, busy[1:])]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if not gaps or not host:
        return []
    main = Counter(e.thread for e in host).most_common(1)[0][0]
    evs = sorted(((e.time_range.start, e.time_range.end, short_name(e.name),
                   bool(getattr(e, "is_user_annotation", False)))
                  for e in host if e.thread == main), key=lambda x: (x[0], -x[1]))
    stacks = {True: [], False: []}            # spans, operations
    tot: dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(evs) and evs[j][0] <= g0:
            s, e, name, ann = evs[j]
            st = stacks[ann]
            while st and st[-1][1] <= s:
                st.pop()
            st.append((s, e, name))
            j += 1
        for st in stacks.values():
            while st and st[-1][1] <= g0:
                st.pop()
        sp, op = stacks[True], stacks[False]
        key = f"{sp[-1][2] if sp else 'no span'} > {op[-1][2] if op else 'python'}"
        tot[key] = tot.get(key, 0.0) + (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def profile_summary(prof, wall_ms: float) -> dict:
    events = prof.events()
    return {"busy_ms": busy_ms(events), "wall_ms": wall_ms,
            "device_ops": top_device_ops(events), "idle_gaps": idle_gaps(events)}
