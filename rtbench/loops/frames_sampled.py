"""loop "frames_sampled": loop "frames" (rtbench/loops/frames.py) with the
number of pixels the check samples from each kept frame taken from the
traffic mix, "check_pixels", instead of frames.CHECK_PIXELS: the reference
is brute force, and at millions of triangles 65,536 pixels a frame would
take minutes. The frames kept, the frames checked and the warm-up are
frames.py's (SAMPLE_STRIDE, CHECK_FRAMES, WARM_STRIDE, read when a run
starts). End-to-end: frame_ms, frame_p95_ms."""
from __future__ import annotations

import gc
import time

import torch

from rtbench import checks, generate, harness, plugins, reference


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float) -> dict:
    from tracer_torch import api
    from tracer_torch.core.camera import Camera

    frames = plugins.load("loops", "frames", cell.root)
    sample_stride, check_frames, warm_stride = (frames.SAMPLE_STRIDE, frames.CHECK_FRAMES,
                                                frames.WARM_STRIDE)
    check_pixels = int(cell.traffic["check_pixels"])
    stages = {"start": time.time() - t_process}
    arrays = harness.scene_arrays(cell)
    stages["arrays"] = time.time() - t_process
    scene = harness.program_scene(arrays, device)
    rcfg = harness.render_config(cell)
    harness.check_tier(cell, scene, rcfg)
    stages["scene"] = time.time() - t_process
    path = generate.camera_path(cell.traffic["camera"], arrays.camera, cell.root)
    period = len(path)
    start = generate.start_index(seed, period)
    cams = [Camera.make(**c, device=device) for c in path]
    render = api.make_render_fn(scene, rcfg, device)
    overflow = 0
    for j in range(0, period, warm_stride):
        overflow += render(scene, cams[(start + j) % period], with_aux=True)[1]["overflow"]
        if j == 0:
            harness.sync(device)
            stages["first_frame"] = time.time() - t_process
    harness.sync(device)
    harness.log("set-up stages (s from process start): "
                + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # The sample, drawn from the seed before the window: the pixels, and
    # which frames keep them (every sample_stride-th from an offset).
    h, w = rcfg.height, rcfg.width
    rng = generate.rng_of(seed, 3)
    offset = int(rng.integers(sample_stride))
    pix = torch.as_tensor(rng.choice(h * w, min(check_pixels, h * w), replace=False),
                          device=device)
    ys, xs = pix // w, pix % w
    kept = {}

    def call(i):
        return render(scene, cams[(start + i) % period], with_aux=True)

    def on_unit(i, out):
        nonlocal overflow
        overflow += out[1]["overflow"]
        if i % sample_stride == offset:
            kept[i] = out[0][ys, xs]

    tracer = harness.make_tracer(cell, device) if trace else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_process
    times, window_s = harness.window(call, seconds, device, tracer, on_unit)
    n = len(times)
    harness.log_units(times)
    metrics, profile = ({}, None)
    if trace:
        metrics, profile = harness.traced(cell, tracer, call, n, device)
    else:
        metrics = {"frame_ms": window_s / n * 1e3, "frame_p95_ms": harness.p95(times) * 1e3,
                   "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    idx = sorted(kept)
    if not idx:
        raise ValueError(f"{n} frames in the window: none kept for the check "
                         f"(every {sample_stride}th from {offset})")
    chosen = [idx[k] for k in sorted(rng.choice(len(idx), min(check_frames, len(idx)),
                                                replace=False))]
    samples = [{"camera": path[(start + i) % period], "ys": ys, "xs": xs,
                "prog": kept[i].float()} for i in chosen]
    del kept, render, scene, cams
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_scene = harness.reference_scene(arrays, device)
    prog, ref = [], []
    with torch.no_grad():
        for s in samples:
            s["ref"] = reference.render_pixels(ref_scene,
                                               harness.reference_camera(s["camera"], device),
                                               h, w, ys, xs, rcfg.max_bounces)
            prog.append(s["prog"])
            ref.append(s["ref"])
    harness.sync(device)
    harness.log(f"setup {setup_s:.3f} s, window {window_s:.3f} s ({n} frames), reference "
                f"{time.perf_counter() - t_ref:.3f} s "
                f"({sum(len(s['ys']) for s in samples)} pixels)")
    values = {"bad_pixel_share": checks.bad_pixel_share(torch.cat(prog), torch.cat(ref)),
              "overflow": overflow}
    ok, judged = checks.judge(values, cell.limits)
    return {"correct": ok, "attempted": n, "failed": 0, "metrics": metrics, "peak": peak,
            "profile": profile, "checks": judged,
            "extras": {"samples": samples, "ref_scene": ref_scene, "rcfg": rcfg,
                       "times": times, "window_s": window_s}}
