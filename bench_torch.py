#!/usr/bin/env python3
"""Benchmark entry point of the PyTorch/CUDA port (tracer_torch) on one NVIDIA
GPU: prints ONE JSON line with bench.py's names, plus detail.device.

    python3 bench_torch.py

  - value / rays_per_s: the BENCH_PRESET frame (default bench100k),
    BENCH_ITERS frames (default 10) after 2 warm-ups, rays/frame = H*W *
    bounces * (1 + lights) (tracer_torch.api.benchmark);
    primary_rays_per_s counts the closest-hit passes only, live_rays_per_s
    the rays actually traced (tiled tier only);
  - overflow: cull candidates dropped (0 by construction; the run exits 1
    on any other value, frame or grad step);
  - with BENCH_GRAD unset or not "0", the three grad steps of bench.py:
    bunny-grad (3 steps, its config routes it to the jnp tier), bunny512
    through the tiled tier with verts, albedo and cam_pos (3 steps after 1),
    and bunny512 through the jnp tier (use_pallas off, tiled="off"; 1 step
    after 1) (tracer_torch.api.benchmark_grad_step). A grad step that raises
    fails the run; bench.py records such an error in the line instead.

It runs on the card only: without CUDA it raises.

    python3 bench_torch.py --scaling

prints bench.py's scaling table instead (BENCH_PRESET, BENCH_ITERS default
5): with more than one card, tracer_torch.dist.scaling.scaling_sweep over
1, 2, 4, ... cards (NCCL, a world of ranks a count); with one card, the
card's row measured by api.benchmark and the 1-host and 4-host rows marked
pending.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from tracer_torch.api import benchmark, benchmark_grad_step  # noqa: E402

# BASELINE.json's target of 100M rays/s a chip; a goal, not a measurement.
BASELINE_RAYS_PER_S = 100e6
GRAD_PRESET = "bunny-grad"
ALL_PARAMS = ("verts", "albedo", "cam_pos")
# bench.py:98-125, by the detail key that carries each step's time.
GRAD_RUNS = {
    "grad_step_ms": dict(config=GRAD_PRESET, iters=3),
    "grad_step_bunny512_ms": dict(config="bunny512", iters=3, warmup=1, params=ALL_PARAMS),
    "grad_step_bunny512_jnp_ms": dict(config="bunny512", iters=1, warmup=1, params=ALL_PARAMS,
                                      tiled="off", use_pallas=False),
}


def grad_steps(device="cuda") -> dict:
    """benchmark_grad_step of each of GRAD_RUNS, by its detail key."""
    return {key: benchmark_grad_step(**kw, device=device) for key, kw in GRAD_RUNS.items()}


def bench_line(preset: str, frame: dict, grads: dict | None) -> tuple[int, dict]:
    """(exit code, the JSON line) from benchmark's result for the frame and
    grad_steps' results (None: not run). A frame that dropped candidates
    gives bench.py's error line; a grad step that did gives exit code 1."""
    if frame["overflow"] != 0:
        return 1, {"error": "bench frame dropped cull candidates",
                   "overflow": int(frame["overflow"])}
    detail = {
        "ms_per_frame": frame["ms_per_frame"],
        "num_tris": int(frame["num_tris"]),
        "preset": preset,
        "primary_rays_per_s": frame["primary_rays_per_s"],
        "overflow": frame["overflow"],
    }
    if frame["live_rays_per_s"] is not None:
        detail["live_rays_per_s"] = frame["live_rays_per_s"]
    rc = 0
    if grads is not None:
        detail["grad_step_ms"] = grads["grad_step_ms"]["grad_step_ms"]
        detail["grad_preset"] = GRAD_PRESET
        g5 = grads["grad_step_bunny512_ms"]
        detail["grad_step_bunny512_ms"] = g5["grad_step_ms"]
        detail["grad_step_bunny512_overflow"] = g5["overflow"]
        detail["grad_step_bunny512_jnp_ms"] = grads["grad_step_bunny512_jnp_ms"]["grad_step_ms"]
        rc = int(any(g["overflow"] != 0 for g in grads.values()))
    detail["device"] = frame["device"]
    return rc, {
        "metric": "rays_per_s_per_chip_100ktri_1080p",
        "value": frame["rays_per_s"],
        "unit": "rays/s",
        "vs_baseline": frame["rays_per_s"] / BASELINE_RAYS_PER_S,
        "detail": detail,
    }


def run(preset: str, iters: int, grad: bool, device="cuda") -> tuple[int, dict]:
    """The frame, then (if `grad` and the frame dropped nothing) the grad
    steps -> (exit code, the JSON line)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py measures the card: CUDA is not available")
    frame = benchmark(preset, iters=iters, device=device)
    if frame["overflow"] != 0 or not grad:
        return bench_line(preset, frame, None)
    return bench_line(preset, frame, grad_steps(device))


def scaling_rows(preset: str, iters: int, device="cuda") -> list[str]:
    """bench.py --scaling's table, as lines. On the card: with more than one
    card, one measured row a count of cards of scaling_sweep; with one, the
    card's row (api.benchmark) and the multi-card rows pending. device="cpu"
    sweeps 1 and 2 gloo ranks: a proof of the harness, not a measurement."""
    from tracer_torch.dist.scaling import scaling_sweep
    from tracer_torch.utils.config import load_config

    cfg = load_config(preset)
    lines = ["| Topology | rays/s | scaling efficiency | status |", "|---|---|---|---|"]
    if torch.device(device).type == "cpu":
        rows = scaling_sweep(cfg, device_counts=[1, 2], iters=iters, device="cpu")
        kind, status = "CPU rank", "cpu (gloo; harness proof, timings not hardware)"
    elif not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py --scaling measures the cards: CUDA is not available")
    else:
        n = torch.cuda.device_count()
        kind, status = torch.cuda.get_device_name(0), "measured"
        if n == 1:
            mray = benchmark(cfg, iters=iters, device=device)["rays_per_s"] / 1e6
            return lines + [f"| 1 card ({kind}) | {mray:.1f} Mrays/s | 100% (definition) | "
                            f"measured |"] + [
                f"| {label} | — | target >=85% | pending: this machine has {n} card |"
                for label in ("1 host (4 cards)", "4 hosts (16 cards)")]
        rows = scaling_sweep(cfg, iters=iters, device=device)
    return lines + [f"| {r['devices']}x {kind} | {r['rays_per_s'] / 1e6:.1f} Mrays/s | "
                    f"{r['efficiency'] * 100:.1f}% | {status} |" for r in rows]


def main() -> int:
    if sys.argv[1:] == ["--scaling"]:
        print("\n".join(scaling_rows(os.environ.get("BENCH_PRESET", "bench100k"),
                                     int(os.environ.get("BENCH_ITERS", "5")))))
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"bench_torch.py takes no arguments but --scaling, got {sys.argv[1:]}")
    rc, line = run(os.environ.get("BENCH_PRESET", "bench100k"),
                   int(os.environ.get("BENCH_ITERS", "10")),
                   os.environ.get("BENCH_GRAD", "1") != "0")
    print(json.dumps(line))
    return rc


if __name__ == "__main__":
    sys.exit(main())
