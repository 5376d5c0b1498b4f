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
     ids and occlusion equal, best t bit-equal; times by CUDA events; for the
     any-hit kernel also the number of segments its work is cut into, the
     kernel's own device time (its wrapper's less its segment table's, by
     CUDA events behind a spin that hides the host) beside the table's, and its time on the heaviest tile alone and on the
     selection without its 256 heaviest tiles (what is left of the tail of
     long candidate lists);
  4. frame: the frame through tracer_torch.api.make_render_fn on the card:
     overflow 0, a finite, lit image, every kernel of the tier launched and
     no kernel of the streamed tier;
  5. cross-device: bench100k at 384x216 on the card and on the CPU (plain
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
  The wavefront tiers behind the (trace_fn, occlude_fn) seam, on the
  bench100k frame (1 bounce, 1 light), one scene and accel shared by phases
  14-16:
  14. wavefront kernels: the work-list kernels (traversal.cu) at tiles of 256
     rays in order, the pair kernels (traversal3.cu) at 8x8 tiles, each at
     the frame's primary rays and its first light's surface-origin shadow
     rays (the heaviest tiles plus a stride), against its plain version:
     ids, slots and occlusion equal, t, u, v bit-equal; for each work-list
     kernel also what phase 3 reports of the any-hit kernel (segments,
     kernel alone, table, heaviest tile alone, selection without its 256
     heaviest), its tests a second beside the card's issue rate (132 SMs x
     128 lanes x the SM clock nvidia-smi reports under the load), one
     comparison on every tile of the pass, untimed, and for closest hit,
     whose blocks merge by atomics, three runs that must be bit-identical;
     then, on the pair tier's shadow rays, anyhit_kernel over the two-stage cull's lists
     against pair_anyhit_kernel over the single-stage cull's, on the same
     tiles and on all tiles: occlusion equal on every ray;
  15. wavefront frames: render_wavefront over make_accel_tracers(
     use_pallas=True), make_sorted_tracers, make_pair_tracers and
     make_streamed_tracers: a finite, lit image each, its own kernels
     launched and no other tier's, no warning, the four images pairwise
     under the golden gate; each of 10 frames after 2 timed on the host
     clock, then one profiled frame's device time by kernel;
  16. routing: make_render_fn on cornell256 and bunny-grad: the wavefront
     aux {"overflow": 0}, no kernel launched, and a 64x64 frame of each on
     the card against the CPU under the golden gate; where pixels differ,
     their primary hits and first-light occlusion on both devices.
Each phase prints its wall time. The last lines are a JSON line of
per-kernel results, the nvidia-smi line, and {"ok": true, "device": {...}}.

A kernel's bound is the larger of its operations over the card's fp32 peak
and its bytes over the card's memory rate, counting what its function needs
on this run's inputs and nothing its specification lets it skip: a walk
with an early-out needs the words under the tile's final bound; a pair
kernel tests those of them that pass its slab vote against the final state,
and slab-tests all of them; an OR needs, for a ray it leaves unoccluded,
every candidate the ray can reach before its t_max, and for a ray it
occludes one triangle test.
"""
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tracer_torch import api  # noqa: E402
from tracer_torch.bvh.cluster import build_scene_accel  # noqa: E402
from tracer_torch.bvh.cull import (  # noqa: E402
    CLUSTER_BITS, cull_clusters, cull_clusters_sorted, cull_clusters_sorted2)
from tracer_torch.core.camera import generate_rays  # noqa: E402
from tracer_torch.core.types import T_FAR  # noqa: E402
from tracer_torch.kernels import (  # noqa: E402
    _build, _launch, stream as st, traversal as t1, traversal2 as t2, traversal3 as t3)
from tracer_torch.kernels.traversal import (  # noqa: E402
    _homog, generate_rays_tiled, tile_rays, tiled_tmax)
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
    "worklist_closest": ("tracer_torch/kernels/csrc/traversal.cu",
                         "tracer/kernels/traversal.py:333"),
    "worklist_anyhit": ("tracer_torch/kernels/csrc/traversal.cu",
                        "tracer/kernels/traversal.py:449"),
    "pair_closest": ("tracer_torch/kernels/csrc/traversal3.cu",
                     "tracer/kernels/traversal3.py:122"),
    "pair_anyhit": ("tracer_torch/kernels/csrc/traversal3.cu",
                    "tracer/kernels/traversal3.py:162"),
}
KERNEL_FUNCTIONS = {"closest_hit_kernel"} | {f"{k}_kernel" for k in KERNELS if k != "closest"}
# The kernels each tier's frame must launch; it must launch none of the others.
TIERS = {"tiled": ("closest", "closest_fast", "anyhit"),
         "sorted": ("closest", "closest_fast", "anyhit"),
         "streamed": ("closest_stream", "anyhit_stream"),
         "worklist": ("worklist_closest", "worklist_anyhit"),
         "pair": ("pair_closest", "pair_anyhit")}

# Published peaks of one H100 SXM at its full 700 W power limit: fp32 outside
# the tensor cores, and device memory. A kernel's bound is the larger of its
# operations over the first and its bytes over the second.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Arithmetic operations per (ray, triangle) test, compares not counted.
# tri_t (traversal2.cu, stream.cu, traversal3.cu): so 3 x (3 mul + 3 add), sd
# 3 x (3 mul + 2 add), negate, divide, u and v 2 x (mul + add), 1 - u - v.
FLOPS_TRI = 41
# _field_epilogue (field_hit of traversal.cu): so and sd 6 x (4 mul + 3 add), negate, divide, u
# and v 2 x (mul + add), u + v.
FLOPS_FIELD = 49
# _slab_enter (traversal3.cu) per (ray, box): per axis 2 subtractions, 2
# products, and 4 min/max.
FLOPS_SLAB = 24
_CL_MASK = (1 << CLUSTER_BITS) - 1


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


def bound(flops, n_tiles, tr, list_items, cluster_bytes, in_ray, out_ray):
    """The least time the card could take for a traversal kernel's work on
    this run's inputs: `flops` operations, against these bytes, each input
    once and each output once: in_ray + out_ray per ray, 4 per list item and
    per tile, and cluster_bytes of cluster data."""
    nbytes = n_tiles * tr * (in_ray + out_ray) + 4 * (list_items + n_tiles) + cluster_bytes
    ops_ms, bytes_ms = float(flops) / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


def needed_words(words, counts, final_bits):
    """Which of each tile's sorted words any front-to-back walk of this data
    must visit: those whose entry bits lie under the tile's final bound (the
    bound only falls during a walk) -> (Nt, K) bool."""
    slot = torch.arange(words.shape[1], device=words.device)[None]
    return ((words & ~_CL_MASK) < final_bits[:, None]) & (slot < counts[:, None])


def closest_bound(words, counts, final_bits, tr, c):
    """bound() of a closest-hit kernel that walks sorted words with an
    early-out and tests every ray of the tile against a visited cluster.
    Rays: o4, d4 in (32 B), bt, bid out (8 B)."""
    need = needed_words(words, counts, final_bits)
    tests = int(need.sum())
    clusters = torch.unique((words & _CL_MASK)[need]).numel()
    return (bound(tests * tr * c * FLOPS_TRI, words.shape[0], tr, tests, clusters * 48 * c,
                  32, 8), f"{tests} cluster tests x {tr} x {c} x {FLOPS_TRI}")


def open_rays(occ, tmax):
    """The rays an OR must follow to the end: not occluded, and with a
    non-empty interval (T_MIN, t_max)."""
    return ~occ & (tmax > t1.T_MIN)


def anyhit_bound(words, counts, occ, tmax, c):
    """bound() of an any-hit kernel over sorted words, per ray: a ray left
    unoccluded needs every word whose entry bits lie under its own t_max (the
    tile frustum's entry distance is a lower bound of the ray's), a ray that
    ends occluded one triangle test. Rays: o4, d4, tmax in (36 B), occ out
    (1 B)."""
    slot = torch.arange(words.shape[1], device=words.device)[None]
    valid = slot < counts[:, None]
    need = (((words & ~_CL_MASK)[:, :, None] < float_bits(tmax)[:, None, :])
            & valid[:, :, None] & open_rays(occ, tmax)[:, None, :])          # (Nt, K, TR)
    tests = int(need.sum()) * c + int(occ.sum())
    used = need.any(2)
    items = int(torch.maximum(used.sum(1), occ.any(1).long()).sum())
    clusters = torch.unique((words & _CL_MASK)[used]).numel()
    return (bound(tests * FLOPS_TRI, words.shape[0], occ.shape[1], items, clusters * 48 * c,
                  36, 1), f"{tests} (ray, triangle) tests x {FLOPS_TRI}")


def pair_enter(o4, d4, lo, hi, words, need):
    """For each needed (tile, word) pair, the entry distance of every ray of
    the tile into the word's cluster box -> (tile (P,), cluster (P,), enter
    (P, TR))."""
    t, k = torch.nonzero(need, as_tuple=True)
    cl = (words[t, k] & _CL_MASK).long()
    rt = t3._ray_rows(o4[..., :3], d4[..., :3])
    return t, cl, t3._slab_enter(rt[t], lo[cl], hi[cl])


def float_bits(x):
    return x.contiguous().view(torch.int32)


def report(name, results, n_tiles, what, ms, plain_ms, err, bnd, tests):
    log(f"[kernels] {name}: {n_tiles} tiles, {what}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.5f} ms by {bnd['bound_by']} "
        f"({tests})")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd}


def compare_closest(name, kernel, plain, o4, d4, w, words, counts, results):
    check(o4.shape[0] > 0, f"{name}: the selection holds no tile of this kernel's region")
    bt_k, bid_k = kernel(o4, d4, w, words, counts)
    bt_p, bid_p = plain(o4, d4, w, words, counts)
    torch.cuda.synchronize()
    bad_bid = int((bid_k != bid_p).sum())
    bad_bt = int((float_bits(bt_k) != float_bits(bt_p)).sum())
    err = float((bt_k - bt_p).abs().max()) if bt_k.numel() else 0.0
    ms = cuda_ms(lambda: kernel(o4, d4, w, words, counts), 20)
    plain_ms = cuda_ms(lambda: plain(o4, d4, w, words, counts), 1)
    # The fast kernel's walk is its first word, whatever the bound.
    if name == "closest_fast":
        bnd, tests = closest_bound(words[:, :1], counts.clamp_max(1),
                                   torch.full_like(counts, 2**31 - 1), o4.shape[1],
                                   w.shape[2] // 3)
    else:
        bnd, tests = closest_bound(words, counts, float_bits(bt_k).amax(1), o4.shape[1],
                                   w.shape[2] // 3)
    report(name, results, o4.shape[0],
           f"{count_stats(counts)}: gid mismatches {bad_bid}, bt bit mismatches {bad_bt}, "
           f"max |dbt| {err:.3g}", ms, plain_ms, err, bnd, tests)
    if bad_bid or bad_bt:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")


def compare_anyhit(name, kernel, plain, args, results):
    """args = (o4, d4, tmax, w, words, counts) of tiles with count > 0."""
    check(args[0].shape[0] > 0, f"{name}: the selection holds no tile")
    o4, _, tmax, w, words, counts = args
    occ_k = kernel(*args)
    occ_p = plain(*args)
    torch.cuda.synchronize()
    bad = int((occ_k != occ_p).sum())
    ms = cuda_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    bnd, tests = anyhit_bound(words, counts, occ_k, tmax, w.shape[2] // 3)
    report(name, results, o4.shape[0],
           f"{count_stats(counts)}, occluded {float(occ_k.float().mean()):.3f}: occ "
           f"mismatches {bad}", ms, plain_ms, float(bad > 0), bnd, tests)
    if bad:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn with the host's time between launches
    taken out: the stream is first held busy (a spin of some 30 ms) while the
    host enqueues all `reps` calls, so the card then runs them back to back
    and the CUDA events around them see no gap the host left."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    check(not end.query(), "device_ms: the card caught up with the host, the spin is too short")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tail_report(name, results, geometry, counts, call, table):
    """What is left of the tail of long candidate runs in a segmented
    kernel, on a selection of tiles by descending count (`counts`): how many
    segments its work is cut into, and the kernel's own device time on all
    of the selection, on the heaviest tile alone and on the selection
    without its 256 heaviest tiles. call(a, b) and table(a, b) give a
    function that runs the wrapper, and one that builds its segment table,
    on tiles a:b of the selection. The wrapper builds the table at every
    call, in eager PyTorch, so the kernel's own time is the wrapper's device
    time less the table's (device_ms of each: what is left holds the kernel
    and the fills of its scratch). Returns the kernel's own ms on all."""
    parts = ((0, None), (0, 1), (256, None))
    check(counts.shape[0] > 256, f"{name}: the selection holds no tile past the 256 heaviest")
    n_seg, seg_heavy, seg_rest = (int(table(a, b)()[1][-1]) for a, b in parts)
    table_ms = [device_ms(table(a, b), 10) for a, b in parts]
    wrap_ms = [device_ms(call(a, b), 10) for a, b in parts]
    ms_all, ms_heavy, ms_rest = (w - t for w, t in zip(wrap_ms, table_ms))
    log(f"[kernels] {name}: {n_seg} segments, {geometry}; the wrapper takes "
        f"{results[name]['ms']:.4f} ms a call "
        f"with the host's gaps, {wrap_ms[0]:.4f} ms of device time without them, of which the "
        f"segment table {table_ms[0]:.4f} ms and the kernel alone {ms_all:.4f} ms; kernel "
        f"alone on the heaviest tile (count {int(counts[0])}, {seg_heavy} segments) "
        f"{ms_heavy:.4f} ms (wrapper {wrap_ms[1]:.4f} less table {table_ms[1]:.4f}); without "
        f"the 256 heaviest tiles ({counts.shape[0] - 256} tiles, count max {int(counts[256])}, "
        f"{seg_rest} segments) {ms_rest:.4f} ms (wrapper {wrap_ms[2]:.4f} less table "
        f"{table_ms[2]:.4f})")
    return ms_all


def sorted_tail_report(name, kernel, args, results):
    """tail_report of a sorted any-hit kernel on args = (o4, d4, tmax, w,
    words, counts), tiles by descending count."""
    def cut(a, b):
        return tuple(x if x is args[3] else x[a:b].contiguous() for x in args)

    def call(a, b):
        part = cut(a, b)
        return lambda: kernel(*part)

    def table(a, b):
        part = cut(a, b)
        return lambda: _launch.run_segments(part[5], t2.SEG, part[4].shape[1])

    tail_report(name, results, f"of {t2.SEG} words, {t2.SLICES} threads a ray, "
                f"{t2.BLOCKS_PER_SM} blocks an SM", args[5], call, table)


def clock_under_load(fn, ms: float) -> int:
    """The SM clock in MHz that nvidia-smi reports while the card runs fn
    back to back: some 0.5 s of calls (ms each) are enqueued, the query runs
    beside them."""
    for _ in range(max(1, int(500.0 / max(ms, 1e-3)))):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return int(out.split()[0])


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
        args = anyhit_args(accel, so, sd, tmax, words2, counts2)
        compare_anyhit("anyhit", t2.anyhit, t2.anyhit_plain, args, results)
        sorted_tail_report("anyhit", t2.anyhit, args, results)


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
        tm = tiled_tmax(t_max, sray, so, 64)
        words2, counts2, excess2, need2 = cull_clusters_sorted2(accel, so, sd, tm)
        check(int(excess2) == 0, "shadow cull dropped candidates")
        far = int((tm.amax(1) > 1e29).sum())
        log(f"[stream] shadow cull (light 0): {so.shape[0]} tiles, {count_stats(counts2)}, "
            f"S {need2[1]}; {far} tiles hold a ray with t_max > 1e29 (a missed receiver)")
        args = anyhit_args(accel, so, sd, tm, words2, counts2)
        compare_anyhit("anyhit_stream", st.anyhit_stream, st.anyhit_stream_plain, args, results)
        sorted_tail_report("anyhit_stream", st.anyhit_stream, args, results)


def first_shadow_rays(scene, cfg, rays, trace_fn, tr):
    """The first light's shadow rays from the primary hits of trace_fn, as
    bounce_step builds them, in tiles of tr -> (so, sd, t_max (Nt, TR))."""
    hit = trace_fn(rays)
    p, n, _ = whitted.shading_frame(scene, rays, hit, cfg.smooth_shading)
    sray, t_max, *_ = whitted.shadow_ray(p, n, hit.valid, scene.lights.position[0])
    so, sd, _ = tile_rays(sray.o, sray.d, tr)
    return so, sd, tiled_tmax(t_max, sray, so, tr)


def worklist_case(accel, o_t, d_t, tmax_t, cand, counts, sel):
    """A work-list wrapper's arguments on tiles `sel` (closest hit when
    tmax_t is None, else any-hit) -> (run_k, run_p, clusters, tm): the kernel
    and its plain version as functions that return a tuple of outputs, the
    flat list of the tiles' runs, and their t_max (None for closest hit)."""
    offs, clusters = t1.tile_runs(cand[sel], counts[sel])
    o4, d4 = _homog(o_t[sel], d_t[sel])
    w, ids, k_cap = accel.tri_w, accel.tri_ids, cand.shape[1]
    if tmax_t is None:
        return (lambda: t1.worklist_closest(o4, d4, w, ids, offs, clusters, k_cap),
                lambda: t1.worklist_closest_plain(o4, d4, w, ids, offs, clusters), clusters, None)
    tm = tmax_t[sel].contiguous()
    return (lambda: (t1.worklist_anyhit(o4, d4, tm, w, offs, clusters, k_cap),),
            lambda: (t1.worklist_anyhit_plain(o4, d4, tm, w, offs, clusters),), clusters, tm)


def bit_mismatches(out_a, out_b):
    """Elements whose bits differ, per output of two tuples of outputs."""
    return [int((float_bits(x) != float_bits(y)).sum()) if x.dtype.is_floating_point
            else int((x != y).sum()) for x, y in zip(out_a, out_b)]


def compare_worklist(results, accel, o_t, d_t, tmax_t, cand, counts):
    """One work-list kernel against its plain version: closest hit when
    tmax_t is None, else any-hit. On the selected tiles: outputs bit for
    bit, times, the bound, the tail report and the achieved tests a second
    beside the card's issue rate; for closest hit three runs whose outputs
    must be bit-identical (its blocks merge by atomics, in an order that
    varies). Then once on every tile of the pass, untimed."""
    closest = tmax_t is None
    name = "worklist_closest" if closest else "worklist_anyhit"
    sel = select_tiles(counts)
    if not closest:
        sel = sel[counts[sel] > 0]
    check(sel.numel() > 0, "work-list comparison: the selection holds no tile")
    case = lambda idx: worklist_case(accel, o_t, d_t, tmax_t, cand, counts, idx)
    run_k, run_p, clusters, tm = case(sel)
    tr, c = o_t.shape[1], accel.tri_ids.shape[1]
    out_k, out_p = run_k(), run_p()
    torch.cuda.synchronize()
    bad = bit_mismatches(out_k, out_p)
    if closest:
        err = max(float((out_k[i] - out_p[i]).abs().max()) for i in (0, 2, 3))
        again = sum(sum(bit_mismatches(out_k, run_k())) for _ in range(2))
        what = (f"bit mismatches bt {bad[0]}, btri {bad[1]}, bu {bad[2]}, bv {bad[3]}, "
                f"max |d| {err:.3g}; elements that differ between three runs: {again}")
        bad.append(again)
        # No early-out: every item, every ray. Inputs o4, d4 (32 B a ray),
        # outputs bt, btri, bu, bv (16 B a ray); a cluster is its matrix plus
        # its C triangle ids.
        n_tests = clusters.numel() * tr * c
        bnd = bound(n_tests * FLOPS_FIELD, sel.numel(), tr, clusters.numel(),
                    torch.unique(clusters).numel() * 52 * c, 32, 16)
        tests = f"{clusters.numel()} cluster tests x {tr} x {c} x {FLOPS_FIELD}"
    else:
        occ_k = out_k[0]
        err = float(bad[0] > 0)
        what = f"occluded {float(occ_k.float().mean()):.3f}: occ mismatches {bad[0]}"
        # Per ray, in an unsorted list: a ray left unoccluded needs every
        # item of its tile, a ray that ends occluded one triangle test.
        # Inputs o4, d4, tmax (36 B a ray), output occ (1 B a ray).
        open_ = open_rays(occ_k, tm)
        n_items = counts[sel].long()
        n_tests = int((open_.sum(1) * n_items).sum()) * c + int(occ_k.sum())
        walked = torch.repeat_interleave(open_.any(1), n_items)
        items = int(walked.sum()) + int((occ_k.any(1) & ~open_.any(1)).sum())
        bnd = bound(n_tests * FLOPS_FIELD, sel.numel(), tr, items,
                    torch.unique(clusters[walked]).numel() * 48 * c, 36, 1)
        tests = f"{n_tests} (ray, triangle) tests x {FLOPS_FIELD}"
    ms, plain_ms = cuda_ms(run_k, 10), cuda_ms(run_p, 1)
    report(name, results, sel.numel(), f"{count_stats(counts[sel])}: {what}", ms, plain_ms,
           err, bnd, tests)
    if any(bad):
        raise SystemExit(f"{name}: kernel disagrees with its plain version, or with itself")

    k_cap = cand.shape[1]
    table = lambda a, b: (lambda n=counts[sel[a:b]].contiguous():
                          _launch.run_segments(n, t1.SEG_WL, k_cap))
    alone = tail_report(name, results, f"of {t1.SEG_WL} items, one thread a ray, "
                        f"{t1.BLOCKS_PER_SM_WL} blocks an SM", counts[sel],
                        lambda a, b: case(sel[a:b])[0], table)
    mhz = clock_under_load(run_k, ms)
    sms = _launch.sm_count(0)
    log(f"[kernels] {name}: {n_tests} tests in {alone:.4f} ms of the kernel alone, "
        f"{n_tests / alone / 1e6:.1f} G tests/s; the card issues {sms} SMs x 128 lanes x "
        f"{mhz} MHz (nvidia-smi, under this load) = {sms * 128 * mhz / 1e6:.2f} T "
        f"instructions/s, {sms * 128 * mhz * 1e3 * alone / n_tests:.1f} issue slots a test")

    t0 = time.perf_counter()
    every = torch.argsort(-counts, stable=True)   # by count, so the plain version's chunks are even
    run_k, run_p, clusters, _ = case(every)
    bad = bit_mismatches(run_k(), run_p())
    torch.cuda.synchronize()
    log(f"[kernels] {name} on every tile of the pass ({every.numel()} tiles, "
        f"{clusters.numel()} items), untimed: bit mismatches {bad} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(not any(bad), f"{name}: kernel disagrees with its plain version on the whole pass")


def compare_pairs(results, accel, o_t, d_t, tmax_t, words, counts):
    """One pair kernel against its plain version on the selected tiles:
    closest hit when tmax_t is None, else any-hit (t_max 0 for d == 0)."""
    sel = select_tiles(counts)
    if tmax_t is not None:
        sel = sel[counts[sel] > 0]
    check(sel.numel() > 0, "pair comparison: the selection holds no tile")
    w_s, c_s = words[sel].contiguous(), counts[sel].contiguous()
    offs, pwords, overflow = t3._tile_stream(w_s, c_s, None)
    check(not overflow, "an exact pair stream overflowed")
    o4, d4 = _homog(o_t[sel], d_t[sel])
    w = accel.tri_w
    lo, hi = accel.cluster_lo.contiguous(), accel.cluster_hi.contiguous()
    tr, c = o4.shape[1], w.shape[2] // 3
    if tmax_t is None:
        name = "pair_closest"
        run_k = lambda: t3.pair_closest(o4, d4, w, lo, hi, offs, pwords)
        run_p = lambda: t3.pair_closest_plain(o4, d4, w, lo, hi, offs, pwords)
        (bt_k, bid_k), (bt_p, bid_p) = run_k(), run_p()
        torch.cuda.synchronize()
        bad = [int((bid_k != bid_p).sum()), int((float_bits(bt_k) != float_bits(bt_p)).sum())]
        err = float((bt_k - bt_p).abs().max())
        what = f"gid mismatches {bad[0]}, bt bit mismatches {bad[1]}, max |dbt| {err:.3g}"
        # Every word under the tile's final bound is slab-tested by every
        # ray; those that some ray enters before its final best t are tested
        # by every ray (the vote against the final state passes only where
        # the walk's own did). Inputs o4, d4 (32 B a ray), outputs bt, bid (8 B);
        # a visited cluster's box is 24 B, a tested one's matrix 48 C.
        need = needed_words(w_s, c_s, float_bits(bt_k).amax(1))
        t, cl, enter = pair_enter(o4, d4, lo, hi, w_s, need)
        voted = (enter < bt_k[t]).any(1)
        n_vis, n_tst = int(need.sum()), int(voted.sum())
        bnd = bound(n_tst * tr * c * FLOPS_TRI + n_vis * tr * FLOPS_SLAB, sel.numel(), tr, n_vis,
                    torch.unique(cl).numel() * 24 + torch.unique(cl[voted]).numel() * 48 * c,
                    32, 8)
        tests = (f"{n_tst} cluster tests x {tr} x {c} x {FLOPS_TRI} + {n_vis} slab tests x "
                 f"{tr} x {FLOPS_SLAB}")
    else:
        name = "pair_anyhit"
        tm = torch.where((d_t[sel] != 0.0).any(-1), tmax_t[sel], 0.0).contiguous()
        run_k = lambda: t3.pair_anyhit(o4, d4, tm, w, lo, hi, offs, pwords)
        run_p = lambda: t3.pair_anyhit_plain(o4, d4, tm, w, lo, hi, offs, pwords)
        occ_k, occ_p = run_k(), run_p()
        torch.cuda.synchronize()
        bad = [int((occ_k != occ_p).sum())]
        err = float(bad[0] > 0)
        what = f"occluded {float(occ_k.float().mean()):.3f}: occ mismatches {bad[0]}"
        # Every word under the tile's final bound is slab-tested by every
        # ray. Per ray: one left unoccluded needs every such cluster it
        # enters before its t_max, one that ends occluded one triangle test.
        # Inputs o4, d4, tmax (36 B a ray), output occ (1 B a ray).
        open_ = open_rays(occ_k, tm)
        need = needed_words(w_s, c_s, float_bits(torch.where(occ_k, 0.0, tm)).amax(1))
        t, cl, enter = pair_enter(o4, d4, lo, hi, w_s, need)
        reach = (enter < tm[t]) & open_[t]
        n_vis, n_tst = int(need.sum()), int(reach.sum()) * c + int(occ_k.sum())
        items = int(torch.maximum(need.sum(1), occ_k.any(1).long()).sum())
        used = reach.any(1)
        bnd = bound(n_tst * FLOPS_TRI + n_vis * tr * FLOPS_SLAB, sel.numel(), tr, items,
                    torch.unique(cl).numel() * 24 + torch.unique(cl[used]).numel() * 48 * c,
                    36, 1)
        tests = (f"{n_tst} (ray, triangle) tests x {FLOPS_TRI} + {n_vis} slab tests x {tr} x "
                 f"{FLOPS_SLAB}")
    ms, plain_ms = cuda_ms(run_k, 10), cuda_ms(run_p, 1)
    report(name, results, sel.numel(), f"{count_stats(c_s)}: {what}", ms, plain_ms, err, bnd,
           tests)
    if any(bad):
        raise SystemExit(f"{name}: kernel disagrees with its plain version")


def phase_bench_scene(cfg, dev="cuda"):
    """The bench100k scene and its accel on the card, built once for phases
    14-15."""
    scene, camera = api.get_scene(cfg, dev)
    with torch.inference_mode():
        accel = build_scene_accel(scene)
    log(f"[scene] {cfg.scene}: {scene.num_tris} triangles, {accel.num_clusters} clusters, "
        f"{scene.lights.count} light(s), tri_w {accel.tri_w.numel() * 4 / 1e6:.1f} MB")
    return scene, camera, accel


def worklist_kernels(results: dict, cfg, scene, accel, rays):
    """The two work-list kernels vs their plain versions at the frame's own
    shapes, tiles of 256 rays in order: the primary rays, and the first
    light's shadow rays from the tier's own primary hits."""
    o_t, d_t, tiling = tile_rays(rays.o, rays.d, t1.DEFAULT_TILE)
    check(tiling.tile_hw is None, "1080 rows do not fold into 16x16 tiles")
    cand, counts, excess = cull_clusters(accel, o_t, d_t, T_FAR)
    check(int(excess) == 0, "work-list primary cull dropped candidates")
    log(f"[wavefront] work-list primary cull: {o_t.shape[0]} in-order tiles of "
        f"{o_t.shape[1]}, {count_stats(counts)}, total {int(counts.sum())}")
    compare_worklist(results, accel, o_t, d_t, None, cand, counts)
    trace_fn, _ = t1.make_accel_tracers(scene, accel, use_pallas=True)
    so, sd, tm = first_shadow_rays(scene, cfg, rays, trace_fn, t1.DEFAULT_TILE)
    cand, counts, excess = cull_clusters(accel, so, sd, tm)
    check(int(excess) == 0, "work-list shadow cull dropped candidates")
    log(f"[wavefront] work-list shadow cull (light 0): {so.shape[0]} tiles, "
        f"{count_stats(counts)}, total {int(counts.sum())}")
    compare_worklist(results, accel, so, sd, tm, cand, counts)


def pair_kernels(results: dict, cfg, scene, accel, rays):
    """The two pair kernels vs their plain versions at the frame's own
    shapes, 8x8 tiles, as worklist_kernels; then the two shadow-ray any-hit
    kernels against each other (compare_shadow_lists)."""
    o_t, d_t, _ = tile_rays(rays.o, rays.d, 64)
    words, counts, excess = cull_clusters_sorted(accel, o_t, d_t, T_FAR)
    check(int(excess) == 0, "pair primary cull dropped candidates")
    log(f"[wavefront] pair primary cull: {o_t.shape[0]} tiles of 64, {count_stats(counts)}, "
        f"total {int(counts.sum())}")
    compare_pairs(results, accel, o_t, d_t, None, words, counts)
    trace_fn, _ = t3.make_pair_tracers(scene, accel)
    so, sd, tm = first_shadow_rays(scene, cfg, rays, trace_fn, 64)
    words, counts, excess = cull_clusters_sorted(accel, so, sd, tm)
    check(int(excess) == 0, "pair shadow cull dropped candidates")
    log(f"[wavefront] pair shadow cull (light 0): {so.shape[0]} tiles, "
        f"{count_stats(counts)}, total {int(counts.sum())}")
    compare_pairs(results, accel, so, sd, tm, words, counts)
    compare_shadow_lists(accel, so, sd, tm, words, counts)


def phase_wavefront_kernels(results: dict, cfg, scene, camera, accel):
    """The four kernels of the work-list and pair tiers vs their plain
    versions at the frame's own shapes."""
    with torch.inference_mode():
        rays = generate_rays(camera, cfg.height, cfg.width)
        worklist_kernels(results, cfg, scene, accel, rays)
        pair_kernels(results, cfg, scene, accel, rays)


def compare_shadow_lists(accel, so, sd, tm, words, counts):
    """On the pair tier's surface-origin shadow rays: anyhit_kernel over the
    two-stage cull's lists against pair_anyhit_kernel over the single-stage
    cull's (words, counts), on the pair comparison's tiles and on all tiles;
    timed in turns. Both are exact: their occlusion must be equal on every
    ray (on all tiles this is the any-hit kernel's one run over a whole
    frame's lists that is held against another kernel)."""
    words2, counts2, excess, _ = cull_clusters_sorted2(accel, so, sd, tm)
    check(int(excess) == 0, "shadow cull dropped candidates")
    tmz = torch.where((sd != 0.0).any(-1), tm, 0.0)
    lo, hi = accel.cluster_lo.contiguous(), accel.cluster_hi.contiguous()
    sel = select_tiles(counts)
    sel = sel[counts[sel] > 0]
    every = torch.arange(counts.shape[0], device=counts.device)
    for what, idx in (("the pair comparison's tiles", sel), ("all tiles", every)):
        o4, d4 = _homog(so[idx], sd[idx])
        t_m = tmz[idx].contiguous()
        w2, c2 = words2[idx].contiguous(), counts2[idx].contiguous()
        offs, pwords, overflow = t3._tile_stream(words[idx].contiguous(),
                                                 counts[idx].contiguous(), None)
        check(not overflow, "an exact pair stream overflowed")
        run_a = lambda: t2.anyhit(o4, d4, t_m, accel.tri_w, w2, c2)
        run_p = lambda: t3.pair_anyhit(o4, d4, t_m, accel.tri_w, lo, hi, offs, pwords)
        differ = int((run_a() != run_p()).sum())
        check(differ == 0, f"anyhit_kernel and pair_anyhit_kernel differ on {differ} rays of "
                           f"{what}")
        ms_a, ms_p = [], []
        for run, ms in ((run_a, ms_a), (run_p, ms_p), (run_p, ms_p), (run_a, ms_a)):
            ms.append(cuda_ms(run, 5))
        log(f"[wavefront] surface-origin shadow rays, {what} ({idx.numel()}): anyhit_kernel "
            f"over the two-stage cull's lists ({count_stats(c2)}, total {int(c2.sum())}) "
            f"{np.mean(ms_a):.4f} ms {[round(x, 4) for x in ms_a]}; pair_anyhit_kernel over "
            f"the single-stage cull's ({count_stats(counts[idx])}, total "
            f"{int(counts[idx].sum())}) {np.mean(ms_p):.4f} ms {[round(x, 4) for x in ms_p]}; "
            f"rays on which their occlusion differs: {differ}")


def golden_gate(a, b, what: str):
    """< 1.5% of pixels off by > 2e-3 and p98 error < 2e-3, or exit."""
    err = np.abs(a - b).max(axis=-1)
    frac = float((err > 2e-3).mean())
    p98 = float(np.percentile(err, 98))
    log(f"[gate] {what}: pixels off by > 2e-3: {frac:.4%}, p98 {p98:.3g}, max {err.max():.3g}")
    if not (frac < 0.015 and p98 < 2e-3):
        raise SystemExit(f"{what}: the frames disagree beyond the golden gate")


def phase_wavefront_frames(smi: str, cfg, scene, camera, accel) -> dict:
    """The frame through render_wavefront over each tracer factory. For each
    tier the launch counts are set to 0 just before its first frame and read
    just after: its own kernels must have launched, and no other tier's. The
    tracers' lists hold every candidate; any warning is an error. Then 10
    frames, each timed on the host clock around a synchronize, after one
    more warm-up; then one profiled frame's device time, by kernel of the
    port (the four tiers trace the same rays, so these compare). Returns the
    launches of the work-list and pair tiers."""
    from torch.profiler import ProfilerActivity, profile

    wcfg = whitted.WhittedConfig(max_bounces=cfg.max_bounces,
                                 smooth_shading=cfg.smooth_shading)
    factories = {"worklist": lambda: t1.make_accel_tracers(scene, accel, use_pallas=True),
                 "sorted": lambda: t2.make_sorted_tracers(scene, accel),
                 "pair": lambda: t3.make_pair_tracers(scene, accel),
                 "streamed": lambda: st.make_streamed_tracers(scene, accel)}
    images, launched = {}, {}
    for tier, factory in factories.items():
        tracers = factory()

        def frame():
            with torch.inference_mode():
                rays = generate_rays(camera, cfg.height, cfg.width)
                return whitted.render_wavefront(scene, rays, wcfg, *tracers)

        torch.cuda.reset_peak_memory_stats()
        for key in t2.LAUNCHES:
            t2.LAUNCHES[key] = 0
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            img = frame()
            torch.cuda.synchronize()
            launches = dict(t2.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            frame()
            torch.cuda.synchronize()
            ms = []
            for _ in range(10):
                t0 = time.perf_counter()
                frame()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            frame()
            torch.cuda.synchronize()
        by_kernel = device_ms_by_kernel(prof.events())
        img = img.cpu().numpy()
        log(f"[wavefront] {tier} tier, {cfg.scene} {cfg.width}x{cfg.height}, "
            f"{cfg.max_bounces} bounce(s), on {smi}: ms/frame over 10 frames after 2: mean "
            f"{np.mean(ms):.3f}, median {np.median(ms):.3f}, min {min(ms):.3f}, max "
            f"{max(ms):.3f}; one profiled frame: device busy {busy_ms(prof.events()):.3f} ms, "
            f"of it { {k: round(v, 3) for k, v in by_kernel.items()} }; "
            f"image mean {img.mean():.4f}, launches { {k: v for k, v in launches.items() if v} }, "
            f"peak device memory {peak:.2f} GiB, no warning")
        check(img.shape == (cfg.height, cfg.width, 3) and bool(np.isfinite(img).all()),
              f"{tier}: the frame is not a finite (H, W, 3) image")
        check(img.mean() > 0.01, f"{tier}: the frame is black (mean {img.mean()})")
        missing = [k for k in TIERS[tier] if launches[k] == 0]
        stray = [k for k, v in launches.items() if v and k not in TIERS[tier]]
        check(not missing and not stray,
              f"the {tier} frame never launched {missing}, and launched {stray}")
        images[tier], launched[tier] = img, launches
    tiers = list(images)
    for i, a in enumerate(tiers):
        for b in tiers[i + 1:]:
            golden_gate(images[a], images[b], f"{a} vs {b}")
    return {k: launched[tier][k] for tier in ("worklist", "pair") for k in TIERS[tier]}


def phase_routing(preset: str):
    """make_render_fn on a preset that is not use_bvh + use_pallas: the
    wavefront aux, no kernel launched, and a 64x64 card-vs-CPU gate."""
    cfg = load_config(preset)
    scene, camera = api.get_scene(cfg, "cuda")
    for key in t2.LAUNCHES:
        t2.LAUNCHES[key] = 0
    img, aux = api.make_render_fn(scene, cfg, "cuda")(scene, camera, with_aux=True)
    torch.cuda.synchronize()
    img = img.cpu().numpy()
    log(f"[routing] {preset} {cfg.width}x{cfg.height} (use_bvh {cfg.use_bvh}, use_pallas "
        f"{cfg.use_pallas}): aux {aux}, image mean {img.mean():.4f}, launches "
        f"{sum(t2.LAUNCHES.values())}")
    check(aux == {"overflow": 0}, f"{preset}: not the wavefront integrator's aux: {aux}")
    check(not any(t2.LAUNCHES.values()), f"{preset} launched a kernel: {t2.LAUNCHES}")
    check(bool(np.isfinite(img).all()) and img.mean() > 0.01, f"{preset}: frame not lit")
    small = cfg.replace(height=64, width=64)
    card, cpu = phase_cross_device(small)
    log_flips(small, np.abs(card - cpu).max(axis=-1) > 2e-3)


def log_flips(cfg, flipped):
    """Where the card's and the CPU's frame differ: what every trace and
    every occlusion pass of the frame, in its order, returns for those
    pixels on each device, through the config's own tracers."""
    ys, xs = np.nonzero(flipped)
    if not len(ys):
        return
    log(f"[flips] {cfg.scene} {cfg.width}x{cfg.height}: pixels (y, x) "
        f"{list(zip(ys.tolist(), xs.tolist()))}")
    wcfg = whitted.WhittedConfig(max_bounces=cfg.max_bounces,
                                 smooth_shading=cfg.smooth_shading)
    for dev in ("cuda", "cpu"):
        scene, camera = api.get_scene(cfg, dev)
        trace_fn, occlude_fn = api.build_tracers(scene, cfg)

        def trace(ray):
            hit = trace_fn(ray)
            log(f"[flips]   {dev} trace: tri {hit.tri[ys, xs].tolist()}, t "
                f"{hit.t[ys, xs].tolist()}")
            return hit

        def occlude(ray, t_max):
            occ = occlude_fn(ray, t_max)
            log(f"[flips]   {dev} occlude: {occ[ys, xs].tolist()}, t_max "
                f"{t_max[ys, xs].tolist()}")
            return occ

        with torch.inference_mode():
            whitted.render_wavefront(scene, generate_rays(camera, cfg.height, cfg.width), wcfg,
                                     trace, occlude)


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
    golden_gate(card, cpu, f"{cfg.scene} {devs[0]} vs {devs[1]}")
    return card, cpu


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


def device_ms_by_kernel(events) -> dict:
    """Device ms of each kernel of the port in a profile, by the name of its
    __global__ function."""
    from torch.autograd import DeviceType

    out = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        for fn in re.findall(r"\w+_kernel", e.name):
            if fn in KERNEL_FUNCTIONS:
                out[fn] = out.get(fn, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


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
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    # The profiler now and then loses device events; the frame itself is
    # checked by the frame phases, so an empty trace only leaves no reading.
    idle = f"idle {1.0 - busy / wall:.1%}" if busy > 0.0 else "idle share not measured"
    log(f"[profile] one {cfg.scene} frame: wall {wall:.3f} ms, device busy {busy:.3f} ms, {idle}")


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
    timed("cross-device", phase_cross_device, load_config("bench100k", height=216, width=384))
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

    scene, camera, accel = timed("bench scene", phase_bench_scene, bench)
    timed("wavefront kernels", phase_wavefront_kernels, results, bench, scene, camera, accel)
    launches.update(timed("wavefront frames", phase_wavefront_frames, smi, bench, scene, camera,
                          accel))
    del scene, camera, accel
    for preset in ("cornell256", "bunny-grad"):
        timed(f"routing {preset}", phase_routing, preset)
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
