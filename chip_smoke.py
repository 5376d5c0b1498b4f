#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tracer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the CUDA kernels of tracer_torch/kernels/csrc/ with nvcc
     (one process per source, all started together) and prints each
     kernel's ptxas register and spill lines;
  The tiled tier, on the bench100k frame (102,402 triangles, 1920x1080):
  3. kernels: at the frame's own shapes (its primary-ray cull and its
     shadow-segment cull; the 256 heaviest tiles plus every 16th tile), each
     traversal2.cu kernel against its plain PyTorch version on the card: slot
     ids and occlusion equal, best t bit-equal; times by CUDA events;
  4. frame: the frame through tracer_torch.api.make_render_fn on the card:
     overflow 0, a finite, lit image, every kernel of the tier launched and
     no kernel of the streamed tier;
  5. cross-device: bench100k at 480x270 on the card and on the CPU (plain
     versions), held to the golden image gate;
  6. timing: tracer_torch.api.benchmark("bench100k") with 2 warm-ups and 10
     frames;
  7. layers: the frame's layers one at a time, with a sync after each (host
     clock, median of 5 warm repetitions);
  8. profile: device time by kernel over one warm frame (torch.profiler),
     and the device's idle share in that same frame.
  The streamed tier, on the pod-1m frame (3.94M triangles, 1920x1080, 1
  bounce, 2 lights), one scene and accel shared by phases 9-11:
  9. scene: builds the scene and its accel on the card;
  10. stream kernels: at the frame's own shapes (its primary-ray cull, and
     the first light's surface-origin shadow rays from the wavefront's own
     arithmetic; the 256 heaviest tiles plus every 16th), each stream.cu
     kernel against its plain version at B = 2, as in phase 3;
  11. frame: the frame through make_render_fn: overflow 0, a finite, lit
     image, both stream kernels launched and no traversal2.cu kernel; then
     the profile of phase 8 over one warm pod-1m frame;
  12. cross-device: pod-1m at 256x144 on the card and on the CPU, held to
     the golden image gate;
  13. timing: tracer_torch.api.benchmark("pod-1m", max_bounces=1) with 1
     warm-up and 3 frames.
Each phase prints its wall time. The last lines are a JSON line of
per-kernel results, the nvidia-smi line, and {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tracer_torch import api  # noqa: E402
from tracer_torch.bvh.cluster import build_scene_accel  # noqa: E402
from tracer_torch.bvh.cull import cull_clusters_sorted2  # noqa: E402
from tracer_torch.core.camera import generate_rays  # noqa: E402
from tracer_torch.core.types import T_FAR  # noqa: E402
from tracer_torch.kernels import _build, stream as st, traversal2 as t2  # noqa: E402
from tracer_torch.kernels.traversal import _homog, generate_rays_tiled, tile_rays  # noqa: E402
from tracer_torch.render import tiled, whitted  # noqa: E402
from tracer_torch.utils.config import load_config  # noqa: E402

# Kernel -> (source, the TPU kernel it replaces).
KERNELS = {
    "closest": ("tracer_torch/kernels/csrc/traversal2.cu", "tracer/kernels/traversal2.py:186"),
    "closest_fast": ("tracer_torch/kernels/csrc/traversal2.cu",
                     "tracer/kernels/traversal2.py:252"),
    "anyhit": ("tracer_torch/kernels/csrc/traversal2.cu", "tracer/kernels/traversal2.py:286"),
    "closest_stream": ("tracer_torch/kernels/csrc/stream.cu", "tracer/kernels/stream.py:45"),
    "anyhit_stream": ("tracer_torch/kernels/csrc/stream.cu", "tracer/kernels/stream.py:116"),
}
# The kernels each tier's frame must launch; it must launch none of the others.
TIERS = {"tiled": ("closest", "closest_fast", "anyhit"),
         "streamed": ("closest_stream", "anyhit_stream")}


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn on the current stream (CUDA events), warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def select_tiles(counts: torch.Tensor) -> torch.Tensor:
    """The 256 heaviest tiles plus every 16th tile, by descending count."""
    n = counts.shape[0]
    heavy = torch.argsort(-counts, stable=True)[:256]
    every = torch.arange(0, n, 16, device=counts.device)
    sel = torch.unique(torch.cat([heavy, every]))
    return sel[torch.argsort(-counts[sel], stable=True)]


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this smoke test runs on the card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    path, compiler_log = _build.build()
    _build.load()
    log(f"[build] {path.name} from {', '.join(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def check(ok: bool, msg: str):
    if not ok:
        raise SystemExit(msg)


def count_stats(counts: torch.Tensor) -> str:
    c = counts.float()
    return f"count max {int(counts.max())}, mean {float(c.mean()):.2f}"


def compare_closest(name, kernel, plain, o4, d4, w, words, counts, results):
    check(o4.shape[0] > 0, f"{name}: the selection holds no tile of this kernel's region")
    bt_k, bid_k = kernel(o4, d4, w, words, counts)
    bt_p, bid_p = plain(o4, d4, w, words, counts)
    torch.cuda.synchronize()
    bad_bid = int((bid_k != bid_p).sum())
    bad_bt = int((bt_k.view(torch.int32) != bt_p.view(torch.int32)).sum())
    err = float((bt_k - bt_p).abs().max()) if bt_k.numel() else 0.0
    ms = cuda_ms(lambda: kernel(o4, d4, w, words, counts), 20)
    plain_ms = cuda_ms(lambda: plain(o4, d4, w, words, counts), 3)
    log(f"[kernels] {name}: {o4.shape[0]} tiles, {count_stats(counts)}: "
        f"gid mismatches {bad_bid}, bt bit mismatches {bad_bt}, max |dbt| {err:.3g}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if bad_bid or bad_bt:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def compare_anyhit(name, kernel, plain, args, results):
    """args = (o4, d4, tmax, w, words, counts) of tiles with count > 0."""
    check(args[0].shape[0] > 0, f"{name}: the selection holds no tile")
    occ_k = kernel(*args)
    occ_p = plain(*args)
    torch.cuda.synchronize()
    bad = int((occ_k != occ_p).sum())
    ms = cuda_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 3)
    log(f"[kernels] {name}: {args[0].shape[0]} tiles, {count_stats(args[5])}, "
        f"occluded {float(occ_k.float().mean()):.3f}: occ mismatches {bad}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if bad:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    results[name] = {"max_abs_err": float(bad > 0), "ms": ms, "plain_ms": plain_ms}


def anyhit_args(accel, so, sd, tmax, words, counts):
    """The selected tiles with count > 0 of a shadow pass, as the any-hit
    kernels take them (t_max 0 for rays with d == 0, as the drivers set)."""
    tmax = torch.where((sd != 0.0).any(-1), tmax, 0.0)
    sel = select_tiles(counts)
    sel = sel[counts[sel] > 0]
    so4, sd4 = _homog(so[sel], sd[sel])
    return (so4, sd4, tmax[sel].contiguous(), accel.tri_w, words[sel].contiguous(),
            counts[sel].contiguous())


def phase_kernels(results: dict, cfg, dev):
    """Each traversal2.cu kernel vs its plain version at the frame's own shapes."""
    scene, camera = api.get_scene(cfg, dev)
    with torch.inference_mode():
        accel = build_scene_accel(scene)
        w = accel.tri_w
        o_t, d_t, _ = generate_rays_tiled(camera, cfg.height, cfg.width, 64)
        words, counts, excess, _ = cull_clusters_sorted2(accel, o_t, d_t, T_FAR)
        check(int(excess) == 0, "primary cull dropped candidates")
        sel = select_tiles(counts)
        o4, d4 = _homog(o_t[sel], d_t[sel])
        w_s, c_s = words[sel].contiguous(), counts[sel].contiguous()
        gen = c_s > t2.FAST_BATCH
        one = c_s == 1
        compare_closest("closest", t2.closest_hit, t2.closest_hit_plain,
                        o4[gen], d4[gen], w, w_s[gen].contiguous(), c_s[gen].contiguous(),
                        results)
        compare_closest("closest_fast", t2.closest_fast, t2.closest_fast_plain,
                        o4[one], d4[one], w, w_s[one].contiguous(), c_s[one].contiguous(),
                        results)

        # The frame's shadow pass: segments from the light to the primary hits.
        gid, rows, _, _, _ = tiled._trace_rows(accel, o_t, d_t)
        found, p, n = tiled._surface(o_t, d_t, gid, rows, cfg.smooth_shading)
        *_, target = tiled._light_target(p, n, found, scene.lights.position[0])
        so, sd, tmax = tiled._segment_rays(scene.lights.position[0], target)
        words2, counts2, excess2, _ = cull_clusters_sorted2(accel, so, sd, tmax)
        check(int(excess2) == 0, "shadow cull dropped candidates")
        compare_anyhit("anyhit", t2.anyhit, t2.anyhit_plain,
                       anyhit_args(accel, so, sd, tmax, words2, counts2), results)


def phase_pod_scene(cfg, dev="cuda"):
    """The pod-1m scene and its accel on the card, built once for phases
    10-11."""
    t0 = time.perf_counter()
    scene, camera = api.get_scene(cfg, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.inference_mode():
        accel = build_scene_accel(scene)
    torch.cuda.synchronize()
    t_accel = time.perf_counter()
    log(f"[scene] {cfg.scene} scale {cfg.scene_arg}: {scene.num_tris} triangles, "
        f"{accel.num_clusters} clusters, {accel.super_lo.shape[0]} superclusters, "
        f"{scene.lights.count} lights; scene {t1 - t0:.2f} s, accel build {t_accel - t1:.3f} s, "
        f"tri_w {accel.tri_w.numel() * 4 / 1e6:.0f} MB, shade {accel.shade.numel() * 4 / 1e6:.0f} MB")
    return scene, camera, accel


def phase_stream_kernels(results: dict, cfg, scene, camera, accel):
    """Each stream.cu kernel vs its plain version at B = 2, at the frame's
    own shapes: its primary-ray cull, and the first light's shadow rays
    from the primary hits, as the wavefront integrator builds them."""
    with torch.inference_mode():
        rays = generate_rays(camera, cfg.height, cfg.width)
        o_t, d_t, _ = tile_rays(rays.o, rays.d, 64)
        words, counts, excess, need = cull_clusters_sorted2(accel, o_t, d_t, T_FAR)
        check(int(excess) == 0, "primary cull dropped candidates")
        log(f"[stream] primary cull: {o_t.shape[0]} tiles, {count_stats(counts)}, S {need[1]}")
        sel = select_tiles(counts)
        o4, d4 = _homog(o_t[sel], d_t[sel])
        compare_closest("closest_stream", st.closest_stream, st.closest_stream_plain, o4, d4,
                        accel.tri_w, words[sel].contiguous(), counts[sel].contiguous(),
                        results)
        del words

        trace_fn, _ = st.make_streamed_tracers_aux(scene, accel)
        hit, _ = trace_fn(rays)
        p, n, _ = whitted.shading_frame(scene, rays, hit, cfg.smooth_shading)
        sray, t_max, *_ = whitted.shadow_ray(p, n, hit.valid, scene.lights.position[0])
        so, sd, _ = tile_rays(sray.o, sray.d, 64)
        tm = st._tiled_tmax(t_max, sray, so, 64)
        words2, counts2, excess2, need2 = cull_clusters_sorted2(accel, so, sd, tm)
        check(int(excess2) == 0, "shadow cull dropped candidates")
        far = int((tm.amax(1) > 1e29).sum())
        log(f"[stream] shadow cull (light 0): {so.shape[0]} tiles, {count_stats(counts2)}, "
            f"S {need2[1]}; {far} tiles hold a ray with t_max > 1e29 (a missed receiver)")
        compare_anyhit("anyhit_stream", st.anyhit_stream, st.anyhit_stream_plain,
                       anyhit_args(accel, so, sd, tm, words2, counts2), results)


def phase_frame(cfg, dev, tier, scene=None, camera=None, accel=None) -> dict:
    """The frame through the user entry point, with every launch count set
    to 0 just before it: every kernel of its tier must launch in it, and no
    kernel of the other tier. A given accel is handed to the render fn as
    the one it built for `scene`."""
    if scene is None:
        scene, camera = api.get_scene(cfg, dev)
    run = api.make_render_fn(scene, cfg, dev)
    if accel is not None:
        run.state.update(scene=scene, accel=accel)
    torch.cuda.reset_peak_memory_stats()
    for key in t2.LAUNCHES:
        t2.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    img, aux = run(scene, camera, with_aux=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(t2.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = img.cpu().numpy()
    log(f"[frame] {cfg.scene} {cfg.width}x{cfg.height}, {cfg.max_bounces} bounce(s), {tier} "
        f"tier: {wall:.3f} s, image {img.shape}, mean {img.mean():.4f}, overflow "
        f"{aux['overflow']}, live_rays {aux.get('live_rays', 'not counted')}, launches "
        f"{launches}, needs { {k: v for k, v in aux.items() if k.startswith('need_')} }, "
        f"peak device memory {peak:.2f} GiB")
    if aux["overflow"] != 0:
        raise SystemExit(f"frame dropped {aux['overflow']} cull candidates")
    if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(img).all():
        raise SystemExit("frame is not a finite (H, W, 3) image")
    if not img.mean() > 0.01:
        raise SystemExit(f"frame is black (mean {img.mean()})")
    missing = [k for k in TIERS[tier] if launches[k] == 0]
    stray = [k for k, v in launches.items() if v and k not in TIERS[tier]]
    if missing or stray:
        raise SystemExit(f"the {tier} frame never launched {missing}, and launched {stray}")
    return {k: launches[k] for k in TIERS[tier]}


def phase_cross_device(cfg, devs=("cuda", "cpu")):
    """The frame on the card vs the CPU's plain versions, held to the golden
    gate: < 1.5% of pixels off by > 2e-3, p98 error < 2e-3."""
    imgs = {}
    for dev in devs:
        t0 = time.perf_counter()
        scene, camera = api.get_scene(cfg, dev)
        img, aux = api.make_render_fn(scene, cfg, dev)(scene, camera, with_aux=True)
        if aux["overflow"] != 0:
            raise SystemExit(f"{dev} frame dropped {aux['overflow']} cull candidates")
        imgs[dev] = img.cpu().numpy()
        log(f"[cross] {cfg.scene} {dev} {cfg.width}x{cfg.height} in "
            f"{time.perf_counter() - t0:.1f} s, live_rays {aux.get('live_rays', 'not counted')}")
    card, cpu = (imgs[d] for d in devs)
    check(np.isfinite(card).all(), "card frame is not finite")
    err = np.abs(card - cpu).max(axis=-1)
    frac = float((err > 2e-3).mean())
    p98 = float(np.percentile(err, 98))
    log(f"[cross] pixels off by > 2e-3: {frac:.4%}, p98 {p98:.3g}, max {err.max():.3g}")
    if not (frac < 0.015 and p98 < 2e-3):
        raise SystemExit("card and CPU frames disagree beyond the golden gate")


def phase_timing(smi: str, preset: str, iters: int, warmup: int, **overrides):
    res = api.benchmark(preset, iters=iters, warmup=warmup, device="cuda", **overrides)
    if res["overflow"] != 0:
        raise SystemExit(f"benchmark frame dropped {res['overflow']} cull candidates")
    live = res["live_rays_per_s"]
    cfg = res["config"]
    log(f"[timing] {preset} {cfg.width}x{cfg.height}, {cfg.max_bounces} bounce(s), "
        f"{res['num_tris']} triangles, {iters} frames after {warmup} warm-up(s), on {smi}: "
        f"{res['ms_per_frame']:.3f} ms/frame, {res['rays_per_s']:.4g} rays/s, "
        f"{res['primary_rays_per_s']:.4g} primary rays/s, "
        f"{'not counted' if live is None else f'{live:.4g}'} live rays/s")


def phase_layers(cfg, reps: int = 5):
    """Time of each layer of the frame's first bounce and first light, run
    one at a time: host clock from a synchronize before the layer to one
    after it, median of `reps` warm repetitions. A layer's time includes
    its own host syncs and launch gaps; the syncs between layers make the
    sum exceed an unsynchronised frame."""
    scene, camera = api.get_scene(cfg, "cuda")
    lpos = scene.lights.position[0]
    s = {}

    def primary_rays():
        s["o"], s["d"], _ = generate_rays_tiled(camera, cfg.height, cfg.width, 64)

    def primary_cull():
        s["words"], s["counts"], _, _ = cull_clusters_sorted2(s["accel"], s["o"], s["d"], T_FAR)

    def closest():
        _, s["gid"], _, _ = t2.trace_tiles_split(s["o"], s["d"], s["accel"], s["words"],
                                                 s["counts"])

    def shade():
        rows = s["accel"].shade[s["gid"].clamp_min(0).long()]
        found, p, n = tiled._surface(s["o"], s["d"], s["gid"], rows, cfg.smooth_shading)
        *_, s["target"] = tiled._light_target(p, n, found, lpos)

    def segment_rays():
        s["so"], s["sd"], s["tmax"] = tiled._segment_rays(lpos, s["target"])

    def shadow_cull():
        s["words2"], s["counts2"], _, _ = cull_clusters_sorted2(s["accel"], s["so"], s["sd"],
                                                                s["tmax"])

    def anyhit():
        t2.any_hit_tiles_graded(s["so"], s["sd"], s["tmax"], s["accel"], s["words2"],
                                s["counts2"])

    layers = (primary_rays, primary_cull, closest, shade, segment_rays, shadow_cull, anyhit)
    times = {fn.__name__: [] for fn in layers}
    with torch.inference_mode():
        s["accel"] = build_scene_accel(scene)
        for rep in range(reps + 1):                  # repetition 0 warms up
            for fn in layers:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if rep:
                    times[fn.__name__].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    total = sum(med.values())
    log(f"[layers] {cfg.scene} {cfg.width}x{cfg.height}, median of {reps} (ms): "
        + ", ".join(f"{k} {v:.3f} ({v / total:.1%})" for k, v in med.items())
        + f"; sum {total:.3f}")


def busy_ms(events) -> float:
    """Union of the device-activity intervals of a profile, in ms."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def phase_profile(cfg, scene=None, camera=None, accel=None):
    """Device time by kernel over one warm frame, and the device's idle
    share in that same frame: 1 - (union of its device activity) / (its own
    wall time, host clock from the call to the end of a synchronize). The
    profiler's host overhead makes the frame slower than an unprofiled one.
    A given accel is handed to the render fn as the one it built for
    `scene`."""
    from torch.profiler import ProfilerActivity, profile

    if scene is None:
        scene, camera = api.get_scene(cfg, "cuda")
    run = api.make_render_fn(scene, cfg, "cuda")
    if accel is not None:
        run.state.update(scene=scene, accel=accel)
    run(scene, camera)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(scene, camera)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    check(busy > 0.0, "the profile holds no device activity")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    log(f"[profile] one {cfg.scene} frame: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle {1.0 - busy / wall:.1%}")


def timed(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), then its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t0 = time.perf_counter()
    name, smi = timed("device", phase_device)
    timed("build", phase_build)
    results, launches = {}, {}
    bench = load_config("bench100k")
    timed("kernels", phase_kernels, results, bench, torch.device("cuda"))
    launches.update(timed("frame", phase_frame, bench, "cuda", "tiled"))
    timed("cross-device", phase_cross_device, load_config("bench100k", height=270, width=480))
    timed("timing", phase_timing, smi, "bench100k", iters=10, warmup=2)
    timed("layers", phase_layers, bench)
    timed("profile", phase_profile, bench)

    pod = load_config("pod-1m", max_bounces=1)
    scene, camera, accel = timed("pod scene", phase_pod_scene, pod)
    timed("stream kernels", phase_stream_kernels, results, pod, scene, camera, accel)
    launches.update(timed("pod frame", phase_frame, pod, "cuda", "streamed", scene, camera,
                          accel))
    timed("pod profile", phase_profile, pod, scene, camera, accel)
    del scene, camera, accel
    torch.cuda.empty_cache()
    timed("pod cross-device", phase_cross_device, pod.replace(height=144, width=256))
    timed("pod timing", phase_timing, smi, "pod-1m", iters=3, warmup=1, max_bounces=1)
    log(f"[phase] all: {time.perf_counter() - t0:.1f} s")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], **results[k]} for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
