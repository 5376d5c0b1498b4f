"""One run of one cell: set-up, the measured window, the traced readings,
the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in BENCHMARK.json:
  rtbench/configs/<config>.json     the scene deployment as it is run;
  rtbench/traffic/<traffic>.json    the mix, read by rtbench/generate.py;
  rtbench/loops/<loop>.py           the loop a mix names (frames, grad);
  rtbench/cameras/<path>.py         the camera path a mix names;
  rtbench/metrics/<metric>.py       a per-layer reader (SPANS, KEEP and
                                    read(trace) -> value|None);
  rtbench/limits/<workload>.json    the limits of the numbers compared.
From the program (tracer_torch) the harness takes the system under test:
api.make_render_fn's frame, api.make_grad_step_fn's step, and the
module-level names the spans wrap.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rtbench import plugins, scenes, spans

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "rtbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "tracer")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: dict          # metric name -> reader module
    root: Path = ROOT


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_metric(name: str, root: Path = ROOT):
    """The reader module rtbench/metrics/<name>.py."""
    return plugins.load("metrics", name, root)


def _applies(metric: dict, cell: str, e2e: list | None) -> bool:
    """Whether a metric is reported in a cell: the cells its "workloads"
    name; without that key, an end-to-end metric (e2e None) in every cell
    and a per-layer one in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e is None or metric["moves"] in e2e


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench or load_bench(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m["name"] for m in bench["end_to_end"] if _applies(m, name, None)]
    per_layer = {m["name"]: load_metric(m["name"], root) for m in bench["per_layer"]
                 if _applies(m, name, e2e)}
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=json.loads((root / cfg["file"]).read_text()),
                traffic=json.loads((root / "rtbench" / "traffic" / f"{w['traffic']}.json")
                                   .read_text()),
                limits=json.loads((root / "rtbench" / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer, root=root)


# ---------------------------------------------------------------------------
# Inputs: the benchmark's arrays, handed to the program and to the reference
# ---------------------------------------------------------------------------

def scene_arrays(cell: Cell):
    arrays = scenes.make(cell.config["scene"])
    n_tris, n_lights = len(arrays.tris), len(arrays.light_pos)
    if (n_tris, n_lights) != (cell.config["triangles"], cell.config["lights"]):
        raise ValueError(f"{cell.config_name}: {n_tris} triangles and {n_lights} lights, "
                         f"the configuration states "
                         f"{cell.config['triangles']} and {cell.config['lights']}")
    return arrays


def program_scene(arrays, device):
    from tracer_torch.scene.types import Lights, Materials, Scene

    mats = Materials.make(arrays.albedo, arrays.emission, arrays.mirror, arrays.specular,
                          arrays.shininess, device=device)
    lights = Lights.make(arrays.light_pos, arrays.light_int, device=device)
    return Scene.make(arrays.verts, arrays.tris, arrays.mat_id, mats, lights,
                      normals=arrays.normals, device=device)


def reference_scene(arrays, device, normals: bool = True, **replace) -> dict:
    """The reference's scene: tensors of the same arrays (`replace` swaps
    some); without `normals` the reference recomputes them from verts."""
    keys = ("verts", "tris", "mat_id", "albedo", "emission", "mirror", "specular", "shininess",
            "light_pos", "light_int") + (("normals",) if normals else ())
    out = {k: torch.as_tensor(getattr(arrays, k), device=device) for k in keys}
    out.update({k: torch.as_tensor(v, device=device) for k, v in replace.items()})
    return out


def reference_camera(cam: dict, device) -> dict:
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return {"position": f32(cam["position"]), "look_at": f32(cam["look_at"]),
            "fov_y_deg": cam["fov_y_deg"]}


def render_config(cell: Cell):
    from tracer_torch.utils.config import RenderConfig

    return RenderConfig(scene=cell.config["scene"]["kind"], **cell.config["render"])


def check_tier(cell: Cell, scene, rcfg):
    from tracer_torch import api

    tier = ("streamed" if api.use_streamed_tier(scene, rcfg)
            else "tiled" if rcfg.use_bvh and rcfg.use_pallas else "wavefront")
    if tier != cell.config["tier"]:
        raise ValueError(f"{cell.config_name} routes to the {tier} tier, the configuration "
                         f"states {cell.config['tier']}")


def log(msg: str):
    print(f"[rtbench] {msg}", file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log_units(times):
    log(f"unit ms: {summary([t * 1e3 for t in times])}, p95 {p95(times) * 1e3:.6g}")


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

def make_tracer(cell: Cell, device) -> spans.Tracer:
    tr = spans.Tracer(device)
    wanted: dict[str, tuple[str, bool]] = {}
    for mod in cell.per_layer.values():
        keep = set(getattr(mod, "KEEP", ()))
        for name, target in getattr(mod, "SPANS", {}).items():
            if name in wanted and wanted[name][0] != target:
                raise ValueError(f"span {name!r} wraps {wanted[name][0]} and {target}")
            wanted[name] = (target, wanted.get(name, (target, False))[1] or name in keep)
    for name, (target, keep) in wanted.items():
        tr.install(name, target, keep)
    return tr


def window(call, seconds: float, device, tracer, on_unit=None):
    """Closed loop: call(i) until `seconds` have passed, one unit in flight,
    each timed from its call until the device has finished it ->
    (unit seconds, window seconds)."""
    times = []
    gc.collect()
    gc.freeze()
    if tracer is not None:
        tracer.recording = True
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if tracer is not None:
            with tracer.unit_span(i):
                out = call(i)
        else:
            out = call(i)
        sync(device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if on_unit is not None:
            on_unit(i, out)
        i += 1
        if t1 - t_start >= seconds:
            break
    if tracer is not None:
        tracer.recording = False
    gc.unfreeze()
    return times, t1 - t_start


def _profiled_slice(call, start: int, device, tracer) -> dict:
    """torch.profiler over a bounded slice of further units."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    tracer.annotate = True
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n = 0
        while n < spans.PROFILE_MAX_UNITS and (
                n < spans.PROFILE_MIN_UNITS or time.perf_counter() - t0 < spans.PROFILE_SECONDS):
            call(start + n)
            sync(device)
            n += 1
        wall_ms = (time.perf_counter() - t0) * 1e3
    tracer.annotate = False
    return spans.profile_summary(prof, wall_ms)


def traced(cell, tracer, call, n_units, device):
    profile = _profiled_slice(call, n_units, device, tracer)
    data = tracer.data(n_units, profile)
    tracer.uninstall()
    metrics = {}
    for name, mod in cell.per_layer.items():
        v = mod.read(data)
        if v is not None:
            metrics[name] = float(v)
    return metrics, profile


def find_loop(cell: Cell):
    """The cell's loop, rtbench/loops/<traffic's "loop">.py: run(cell, seed,
    seconds, trace, device, t_process) -> the run's result."""
    return plugins.load("loops", cell.traffic["loop"], cell.root)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float):
    return find_loop(cell).run(cell, seed, seconds, trace, torch.device(device), t_process)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is jax, jaxlib, flax or
    tracer (tracer_torch is not tracer)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: Cell, res: dict, device) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    breakdown (traced runs) and, last, the numbers compared."""
    want = cell.end_to_end if "setup_s" in res["metrics"] else list(cell.per_layer)
    bench = load_bench()
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {k: {"value": res["metrics"][k], "unit": units[k]} for k in want
               if k in res["metrics"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": int(res["peak"])}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if res["profile"] is not None:
        p = res["profile"]
        dev["busy_s"] = p["busy_ms"] / 1e3
        dev["window_s"] = p["wall_ms"] / 1e3
        line["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    line["checks"] = res["checks"]
    return line


def summary(values) -> str:
    return (f"median {statistics.median(values):.6g}, min {min(values):.6g}, "
            f"max {max(values):.6g}")
