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
     ids and occlusion equal, best t bit-equal; times by CUDA events; for
     each also the kernel's own device time (its wrapper's less its segment
     table's, by CUDA events behind a spin that hides the host), its time on
     the heaviest tile alone and on the selection without its 256 heaviest
     tiles (what is left of the tail of long candidate lists), and for the
     segmented ones the number of segments; the two closest-hit kernels also
     on every tile of their region (9,675 generic and 12,461 count-1 tiles):
     bits, three identical runs, time, bound and tests a second;
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
     pair_closest_kernel's tail report and its whole primary pass: bt bits
     and bid against the plain version and a replay of its walk, three
     identical runs, time, bound, tests a second beside the issue rate, its
     edge pairs (a ray with a hit below its best t in a cluster whose
     rounded slab entry is not) and its tiles of one origin (where it
     computes the origin's products once a warp); pair_closest_kernel on the
     first light's shadow rays (many origins: its general path), bits;
     pair_anyhit_kernel's tail report and its whole shadow pass: occlusion
     against the plain version and a replay of its walk, three identical
     runs, time, bound, and its edge pairs (a ray with a hit under t_max in
     a cluster whose rounded slab entry is not, which only another ray's
     vote gets tested);
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
  The grad step (tracer_torch.api.make_grad_step_fn: the tiled tier's three
  traversal2.cu kernels on detached inputs under autograd, or the plain
  cluster tier with each candidate slot checkpointed), phase 17:
  17. (a, b) bunny-grad at 64x64 with use_pallas, target a CPU frame + 0.05:
     one SGD(1.0) step on the card and on the CPU for verts, albedo and
     cam_pos through the tiled tier ("auto") and the jnp tier ("off"): loss
     to rtol 1e-5, each gradient nonzero and to rtol 2e-3 + atol 2e-6 of
     its largest entry; (c) one tiled bunny512 step launches
     closest_hit_kernel, closest_fast_kernel (where the frame has count-1
     tiles) and anyhit_kernel, and nothing else (counts printed); (d)
     bench_torch.py's three grad steps, each with its peak device memory,
     overflow and launches (the jnp tier none), the jnp tier's peak without
     the checkpoint at 128x128 and at full size (out of memory is logged,
     not fatal), and the tiled bunny512 step split into accel build, render
     and loss, backward and optimizer (host clock, a sync after each part,
     median of 5), then one profiled step (device time by operation, idle
     share); (e) bench_torch.py's JSON line (the frame of phase 6 and
     the steps of (d)).
  The fit and the command lines (tracer_torch.diff.fit, bin/trace_torch),
  phase 18, after a check that TF32 products are off:
  18. (a) each of make_loss_fn's five modes at 64x64 on the card against the
     CPU, one CPU target, the camera 0.0123 and 0.0071 off the preset's
     point: tiled (bunny-grad with use_pallas), edge-aware accel and jnp
     (bunny-grad), edge-aware brute and replay (cornell256); the grad gate
     of 17 for vert_offset and albedo; the tiled mode launches
     closest_hit_kernel and anyhit_kernel, no mode another kernel; (b)
     the fits bin/fit_torch runs, at the presets' full size (verts, Adam
     5e-3, a target moved by its seeded offset): bunny-grad jnp and
     edge-aware accel, cornell256 replay and edge-aware brute, 10 steps
     each, bunny512 tiled, 5 steps: the loss falls, ms a step (host clock,
     mean after the first), peak device memory, launches (tiled: one of
     each traversal2.cu kernel a step; the others none); (c) a 6-step fit
     checkpointed every 3, resumed to 9: exactly 3 more steps; (d)
     bin/trace_torch as a subprocess on cornell256, bench100k and
     sponza1080 (3 bounces, 2 lights): exit 0, the PNG read back of the
     right shape, neither blank nor saturated, overflow 0, no non-finite
     value, its steady-state frame time; sponza1080 at 128x72 on the card
     against the CPU under the golden gate; then bench_torch.py's line of
     sponza1080 (BENCH_PRESET=sponza1080 BENCH_GRAD=0; not the last line).
  The rest of the one-card surface, phase 19, each part with its seconds:
  19. (a) trace_tiles_sorted and any_hit_tiles_sorted over bench100k's
     1080p primary tiles and shadow-segment tiles: bit-equal to
     trace_tiles_split and any_hit_tiles_graded and, on select_tiles'
     subset, to the plain versions; one launch each of closest_hit_kernel
     and anyhit_kernel (counts set to 0 just before each pass); each pass's
     ms beside the split passes'; (b) goldens against the fp64 C++ oracle
     (tracer_torch.refcpu.cpp, built from cpp/oracle.cpp; a build failure
     fails the phase) at the reference's full sizes, under the golden gate
     ("[gate] <what>: pixels off by > 2e-3: <share> (gate <limit>), p98
     <p98>, max <max>"): bunny512 512x512 through make_render_fn (tiled
     tier), the 4x3 hall 256x256 with 2 bounces through render_tiled, rows
     640-768 of sponza1080's 1080p frame (3 bounces, 2 lights, gate 2.5%)
     through generate_rays_band and render_wavefront over tracers built on
     (a)'s wrappers, cornell256 256x256 through render_image (brute) in both
     shadings, tests/golden/test_phong.py's scene 96x96 brute and tiled;
     (c) bunny512 512x512 through render_image over make_lbvh_tracers,
     gated against (b)'s tiled frame and the oracle: build ms, each pass's
     ms, loop iterations, peak memory; (d) bunny512's geometry through
     save_obj, load_obj's native and Python parsers field for field, the
     obj: scene through make_render_fn against the oracle, and
     bin/trace_torch on it; (e) bin/bench_torch --preset bench100k --iters 3
     --no-grad: overflow 0, ms_per_frame within half to twice phase 6's;
     (f) utils.debug.checked(render_image): a clean cornell frame passes,
     NaN vertices raise CheckError; benchmark("cornell256", profile=True)
     writes trace.json; seeded jittered rays card vs CPU to 2^-22; (g)
     cornell256 64x64 stage by stage on the card against the CPU, from the
     same inputs and each from its own, in units of 2^-23 (the first stage
     past 4 is named with its operations), and where the replay-mode loss
     gap of phase 18 (a) comes from.
  The distributed paths (tracer_torch.dist), phase 20, in a world of one
  rank (NCCL on the card, a file:// store), each part with its seconds:
  20. (a) make_sharded_accel_render_fn at data = 1 over build_tracers on
     bench100k 1080p: bit-equal to render_wavefront over build_tracers,
     launching exactly closest_hit_kernel, closest_fast_kernel and
     anyhit_kernel (counts set to 0 just before the frame), its ms a frame
     beside phase 6's; (b) the same on pod-1m 1080p, 1 bounce: bit-equal,
     exactly the two stream kernels; (c) reshard_bounces=True on
     sponza1080 1080p, 3 bounces: under the golden gate of the frame
     without the re-shard, one all_to_all_single each way a bounce after
     the first; (d) make_ring_render_fn over the shard accel (k_cap None,
     with_aux), ring and reduce, on bench100k 1080p, 1 bounce: overflow 0,
     exactly the two work-list kernels, under the golden gate of (a)'s
     image, with the shard accel's build time and the peak memory; (e) the
     brute ring and reduce on cornell256 256x256 against make_render_fn's
     frame, no kernel; (f) make_sharded_grad_fn and make_overlapped_grad_fn
     (4 buckets) on cornell256 256x256 and the overlapped step over
     build_tracers on bunny-grad, from phase 18's off-centre camera against
     a zeros target, on the card against the CPU (a world of one gloo rank
     in a spawned process, run while the card works) under the grad gate of
     17; (g) scaling_sweep on bench100k (one row) and bin/bench_torch
     --scaling (the measured row, two pending); (h) dryrun.
Each phase prints its wall time. The run adopts its orphans and, when it
ends, reaps its children: a process it started that is still running
then is killed and fails the run. The last lines are a JSON line of
per-kernel results (launches: on the main paths of phases 4, 11 and 15;
dist_launches: on phase 20's (a), (b) and (d) ring frame), the nvidia-smi
line, and {"ok": true, "device": {...}}.

A kernel's bound is the larger of its operations over the card's fp32 peak
and its bytes over the card's memory rate, counting what its function needs
on this run's inputs and nothing its specification lets it skip: a walk
with an early-out needs the words under the tile's final bound; a pair
kernel tests those of them that pass its slab vote against the final state,
and slab-tests all of them; an OR needs, for a ray it leaves unoccluded,
every candidate the ray can reach before its t_max, and for a ray it
occludes one triangle test.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from tracer_torch import api  # noqa: E402
from tracer_torch.bvh import lbvh  # noqa: E402
from tracer_torch.bvh.cluster import build_scene_accel  # noqa: E402
from tracer_torch.bvh.cull import (  # noqa: E402
    CLUSTER_BITS, cull_clusters, cull_clusters_sorted, cull_clusters_sorted2)
from tracer_torch.core.camera import Camera, generate_rays, generate_rays_band  # noqa: E402
from tracer_torch.core.types import T_FAR  # noqa: E402
from tracer_torch.diff.fit import (  # noqa: E402
    FitConfig, fit, init_params, latest_checkpoint, make_loss_fn)
from tracer_torch.kernels import (  # noqa: E402
    _build, _launch, stream as st, traversal as t1, traversal2 as t2, traversal3 as t3)
from tracer_torch.kernels.traversal import (  # noqa: E402
    _homog, generate_rays_tiled, tile_rays, tiled_tmax, untile)
from tracer_torch.refcpu import cpp as cpp_oracle  # noqa: E402
from tracer_torch.render import tiled, whitted  # noqa: E402
from tracer_torch.scene import cpp_loader, procedural  # noqa: E402
from tracer_torch.scene.io import load_obj, save_obj  # noqa: E402
from tracer_torch.scene.types import make_vertex_normal_fn  # noqa: E402
from tracer_torch.utils.config import load_config  # noqa: E402
from tracer_torch.utils.debug import CheckError, checked  # noqa: E402
from tracer_torch.utils.image import read_png  # noqa: E402

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
KERNEL_FUNCTIONS = ({"closest_hit_kernel", "closest_hit_finish_kernel"}
                    | {f"{k}_kernel" for k in KERNELS if k != "closest"})
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


def become_subreaper():
    """Adopt this run's orphans (Linux prctl PR_SET_CHILD_SUBREAPER): a
    process whose parent ended before it, such as a helper of a subprocess,
    becomes this process's child, where stop_children finds it."""
    import ctypes

    if ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _children() -> dict[int, str]:
    """This process's live children -> their command lines."""
    me, out = os.getpid(), {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if int(ppid) == me and state != "Z":
            out[int(pid)] = cmd
    return out


def _reap():
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                return
        except ChildProcessError:
            return


def stop_children(grace: float = 5.0) -> list[str]:
    """Reap this run's children; kill those still running after `grace`
    seconds -> the command lines of the killed ones."""
    deadline = time.monotonic() + grace
    while True:
        _reap()
        left = _children()
        if not left or time.monotonic() >= deadline:
            break
        time.sleep(0.1)
    for pid in left:
        try:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return list(left.values())


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


def sorted_closest_bound(name, words, counts, bt, tr, c):
    """closest_bound of the sorted closest-hit kernel `name` on its output bt
    -> (bound, its text, the (ray, triangle) tests it counts). The fast
    kernel's walk is its first word, whatever the bound."""
    if name == "closest_fast":
        words, counts = words[:, :1], counts.clamp_max(1)
        final = torch.full_like(counts, 2**31 - 1)
    else:
        final = float_bits(bt).amax(1)
    bnd, tests = closest_bound(words, counts, final, tr, c)
    return bnd, tests, int(needed_words(words, counts, final).sum()) * tr * c


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
    bnd, tests, _ = sorted_closest_bound(name, words, counts, bt_k, o4.shape[1], w.shape[2] // 3)
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
    """What is left of the tail of long candidate runs in a kernel, on a
    selection of tiles by descending count (`counts`): how many segments
    its work is cut into, and the kernel's own device time on all of the
    selection, on the heaviest tile alone and on the selection without its
    256 heaviest tiles. call(a, b) and table(a, b) give a function that runs
    the wrapper, and one that builds its segment table, on tiles a:b of the
    selection (table None: a kernel that walks a tile in one block, which
    builds no table). The wrapper builds the table at every call, in eager
    PyTorch, so the kernel's own time is the wrapper's device time less the
    table's (device_ms of each: what is left holds the kernel and the fills
    of its scratch). Returns the kernel's own ms on all."""
    parts = ((0, None), (0, 1), (256, None))
    check(counts.shape[0] > 256, f"{name}: the selection holds no tile past the 256 heaviest")
    if table is None:
        n_seg = seg_heavy = seg_rest = "no"
        table_ms = [0.0, 0.0, 0.0]
    else:
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


def closest_table(name, counts, k_cap):
    """The segment table the sorted closest-hit wrapper `name` builds at
    every call, as a function of no arguments; None for closest_stream,
    which walks a tile in one block and builds none."""
    if name != "closest":
        return None
    return lambda: _launch.run_segments(counts, t2.SEG, k_cap)


def closest_tail_report(name, kernel, args, results):
    """tail_report of a sorted closest-hit kernel on args = (o4, d4, w,
    words, counts), tiles by descending count."""
    def cut(a, b):
        return tuple(x if x is args[2] else x[a:b].contiguous() for x in args)

    def call(a, b):
        part = cut(a, b)
        return lambda: kernel(*part)

    def table(a, b):
        part = cut(a, b)
        return closest_table(name, part[4], part[3].shape[1])

    geometry = {"closest": f"of {t2.SEG} words, {t2.SLICES_CLOSEST} threads a ray, "
                           f"{t2.BLOCKS_PER_SM_CLOSEST} blocks an SM",
                "closest_fast": f"{t2.SLICES_FAST} threads a ray, blocks of up to "
                                f"{t2.FAST_THREADS} threads",
                "closest_stream": "one block a tile, one thread a ray"}[name]
    tail_report(name, results, geometry, args[4], call, None if name != "closest" else table)


def closest_whole_pass(name, kernel, plain, args, what):
    """A sorted closest-hit kernel on every tile of its pass, args = (o4, d4,
    w, words, counts): bt and bid bit for bit against the plain version
    (untimed), three runs bit-identical (blocks meet in an order that
    varies), the kernel's own device time (device_ms of the wrapper less its
    segment table's), the bound on these tiles (closest_bound), and the
    cluster tests a second that the bound counts beside the SM clock under
    the load. Returns (kernel-alone ms, bound ms)."""
    o4, _, w, words, counts = args
    tr, c = o4.shape[1], w.shape[2] // 3
    t0 = time.perf_counter()
    out_k, out_p = kernel(*args), plain(*args)
    bad = bit_mismatches(out_k, out_p)
    again = sum(sum(bit_mismatches(out_k, kernel(*args))) for _ in range(2))
    torch.cuda.synchronize()
    cmp_s = time.perf_counter() - t0
    table = closest_table(name, counts, words.shape[1])
    wrap = device_ms(lambda: kernel(*args), 10)
    tab = 0.0 if table is None else device_ms(table, 10)
    alone = wrap - tab
    bnd, tests, n_tests = sorted_closest_bound(name, words, counts, out_k[0], tr, c)
    mhz = clock_under_load(lambda: kernel(*args), wrap)
    sms = _launch.sm_count(0)
    log(f"[kernels] {name} on every tile of its pass ({what}: {counts.shape[0]} tiles, "
        f"{count_stats(counts)}): bit mismatches bt {bad[0]}, bid {bad[1]}, elements that "
        f"differ between three runs {again} ({cmp_s:.1f} s, untimed); wrapper {wrap:.4f} ms "
        f"of device time, segment table {tab:.4f}, kernel alone {alone:.4f} ms; bound "
        f"{bnd['bound_ms']:.5f} ms by {bnd['bound_by']} ({tests}), kernel alone / bound "
        f"{alone / bnd['bound_ms']:.2f}; {n_tests / alone / 1e6:.1f} G (ray, triangle) tests/s "
        f"of those the bound counts, beside {sms} SMs x 128 lanes x {mhz} MHz (nvidia-smi, "
        f"under this load) = {sms * 128 * mhz / 1e6:.2f} T instructions/s")
    check(not any(bad) and not again,
          f"{name}: kernel disagrees with its plain version, or with itself, on the whole pass")
    return alone, bnd["bound_ms"]


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
        gen_args = (o4[gen], d4[gen], w, w_s[gen].contiguous(), c_s[gen].contiguous())
        compare_closest("closest", t2.closest_hit, t2.closest_hit_plain, *gen_args, results)
        closest_tail_report("closest", t2.closest_hit, gen_args, results)
        fast_args = (o4[one], d4[one], w, w_s[one].contiguous(), c_s[one].contiguous())
        compare_closest("closest_fast", t2.closest_fast, t2.closest_fast_plain, *fast_args,
                        results)
        closest_tail_report("closest_fast", t2.closest_fast, fast_args, results)
        # The frame's generic and fast regions: the tiles with count > 1 and
        # those with count 1, by descending count, as trace_tiles_split hands
        # them to the kernels.
        order = torch.argsort(-counts, stable=True)
        n_gen, n_fast = int((counts > t2.FAST_BATCH).sum()), int((counts > 0).sum())
        for name, kernel, plain, region, what in (
                ("closest", t2.closest_hit, t2.closest_hit_plain, order[:n_gen],
                 "the generic region"),
                ("closest_fast", t2.closest_fast, t2.closest_fast_plain, order[n_gen:n_fast],
                 "the fast region")):
            closest_whole_pass(name, kernel, plain,
                               (*_homog(o_t[region], d_t[region]), w,
                                words[region].contiguous(), counts[region].contiguous()), what)

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
        sel_args = (o4, d4, accel.tri_w, words[sel].contiguous(), counts[sel].contiguous())
        compare_closest("closest_stream", st.closest_stream, st.closest_stream_plain, *sel_args,
                        results)
        closest_tail_report("closest_stream", st.closest_stream, sel_args, results)
        closest_whole_pass("closest_stream", st.closest_stream, st.closest_stream_plain,
                           (*_homog(o_t, d_t), accel.tri_w, words.contiguous(),
                            counts.contiguous()),
                           "the primary pass, in tile order")
        del words, sel_args

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


def pair_case(accel, o_t, d_t, tmax_t, words, counts, idx):
    """A pair wrapper's arguments on tiles idx (closest hit when tmax_t is
    None, else any-hit with t_max 0 for d == 0), as the tile passes build
    them."""
    offs, pwords, overflow = t3._tile_stream(words[idx].contiguous(), counts[idx].contiguous(),
                                             None)
    check(not overflow, "an exact pair stream overflowed")
    o4, d4 = _homog(o_t[idx], d_t[idx])
    lo, hi = accel.cluster_lo.contiguous(), accel.cluster_hi.contiguous()
    if tmax_t is None:
        return o4, d4, accel.tri_w, lo, hi, offs, pwords
    tm = torch.where((d_t[idx] != 0.0).any(-1), tmax_t[idx], 0.0).contiguous()
    return o4, d4, tm, accel.tri_w, lo, hi, offs, pwords


def pair_closest_bound(o4, d4, w, lo, hi, words, counts, bt):
    """bound() of pair_closest_kernel on its output bt: every word under the
    tile's final bound is slab-tested by every ray; those that some ray
    enters before its final best t are tested by every ray (the vote against
    the final state passes only where the walk's own did). Inputs o4, d4 (32
    B a ray), outputs bt, bid (8 B); a visited cluster's box is 24 B, a
    tested one's matrix 48 C. Returns (bound, its text, the (ray, triangle)
    tests it counts)."""
    tr, c = o4.shape[1], w.shape[2] // 3
    need = needed_words(words, counts, float_bits(bt).amax(1))
    t, cl, enter = pair_enter(o4, d4, lo, hi, words, need)
    voted = (enter < bt[t]).any(1)
    n_vis, n_tst = int(need.sum()), int(voted.sum())
    bnd = bound(n_tst * tr * c * FLOPS_TRI + n_vis * tr * FLOPS_SLAB, o4.shape[0], tr, n_vis,
                torch.unique(cl).numel() * 24 + torch.unique(cl[voted]).numel() * 48 * c, 32, 8)
    return bnd, (f"{n_tst} cluster tests x {tr} x {c} x {FLOPS_TRI} + {n_vis} slab tests x "
                 f"{tr} x {FLOPS_SLAB}"), n_tst * tr * c


def pair_anyhit_bound(o4, d4, tm, w, lo, hi, words, counts, occ):
    """bound() of pair_anyhit_kernel on its output occ: every word under the
    tile's final bound is slab-tested by every ray. Per ray: one left
    unoccluded needs every such cluster it enters before its t_max, one that
    ends occluded one triangle test. Inputs o4, d4, tmax (36 B a ray), output
    occ (1 B a ray)."""
    tr, c = o4.shape[1], w.shape[2] // 3
    open_ = open_rays(occ, tm)
    need = needed_words(words, counts, float_bits(torch.where(occ, 0.0, tm)).amax(1))
    t, cl, enter = pair_enter(o4, d4, lo, hi, words, need)
    reach = (enter < tm[t]) & open_[t]
    n_vis, n_tst = int(need.sum()), int(reach.sum()) * c + int(occ.sum())
    items = int(torch.maximum(need.sum(1), occ.any(1).long()).sum())
    used = reach.any(1)
    bnd = bound(n_tst * FLOPS_TRI + n_vis * tr * FLOPS_SLAB, o4.shape[0], tr, items,
                torch.unique(cl).numel() * 24 + torch.unique(cl[used]).numel() * 48 * c, 36, 1)
    return bnd, (f"{n_tst} (ray, triangle) tests x {FLOPS_TRI} + {n_vis} slab tests x {tr} x "
                 f"{FLOPS_SLAB}")


def compare_pairs(results, accel, o_t, d_t, tmax_t, words, counts):
    """One pair kernel against its plain version on the selected tiles:
    closest hit when tmax_t is None, else any-hit (t_max 0 for d == 0)."""
    sel = select_tiles(counts)
    if tmax_t is not None:
        sel = sel[counts[sel] > 0]
    check(sel.numel() > 0, "pair comparison: the selection holds no tile")
    args = pair_case(accel, o_t, d_t, tmax_t, words, counts, sel)
    w_s, c_s = words[sel], counts[sel]
    if tmax_t is None:
        name = "pair_closest"
        run_k, run_p = (lambda: t3.pair_closest(*args)), (lambda: t3.pair_closest_plain(*args))
        (bt_k, bid_k), (bt_p, bid_p) = run_k(), run_p()
        torch.cuda.synchronize()
        bad = [int((bid_k != bid_p).sum()), int((float_bits(bt_k) != float_bits(bt_p)).sum())]
        err = float((bt_k - bt_p).abs().max())
        what = f"gid mismatches {bad[0]}, bt bit mismatches {bad[1]}, max |dbt| {err:.3g}"
        bnd, tests, _ = pair_closest_bound(*args[:5], w_s, c_s, bt_k)
    else:
        name = "pair_anyhit"
        run_k, run_p = (lambda: t3.pair_anyhit(*args)), (lambda: t3.pair_anyhit_plain(*args))
        occ_k, occ_p = run_k(), run_p()
        torch.cuda.synchronize()
        bad = [int((occ_k != occ_p).sum())]
        err = float(bad[0] > 0)
        what = f"occluded {float(occ_k.float().mean()):.3f}: occ mismatches {bad[0]}"
        bnd, tests = pair_anyhit_bound(*args[:6], w_s, c_s, occ_k)
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


def worklist_cluster_size(cfg, scene, rays, c: int = 32):
    """The two work-list kernels at clusters of c triangles (an accel of its
    own), tiles of 256 rays in order, against their plain versions on a
    reduced selection (the 64 heaviest tiles and every 64th): the primary
    rays, and the first light's shadow rays from the tier's own primary hits
    at that size; outputs bit for bit, untimed."""
    accel = build_scene_accel(scene, c)
    o_t, d_t, _ = tile_rays(rays.o, rays.d, t1.DEFAULT_TILE)
    trace_fn, _ = t1.make_accel_tracers(scene, accel, use_pallas=True)
    so, sd, tm = first_shadow_rays(scene, cfg, rays, trace_fn, t1.DEFAULT_TILE)
    for what, (ro, rd, rt) in (("primary", (o_t, d_t, None)), ("shadow", (so, sd, tm))):
        cand, counts, excess = cull_clusters(accel, ro, rd, T_FAR if rt is None else rt)
        check(int(excess) == 0, f"work-list {what} cull at C = {c} dropped candidates")
        n = counts.shape[0]
        sel = torch.unique(torch.cat([torch.argsort(-counts, stable=True)[:64],
                                      torch.arange(0, n, 64, device=counts.device)]))
        if rt is not None:
            sel = sel[counts[sel] > 0]
        run_k, run_p, clusters, _ = worklist_case(accel, ro, rd, rt, cand, counts, sel)
        bad = bit_mismatches(run_k(), run_p())
        torch.cuda.synchronize()
        log(f"[wavefront] work-list kernels at C = {c} ({accel.num_clusters} clusters), {what} "
            f"rays: {sel.numel()} of {n} tiles, {count_stats(counts[sel])}, {clusters.numel()} "
            f"items: bit mismatches {bad}")
        check(not any(bad), f"work-list kernel at C = {c} disagrees with its plain version "
                            f"({what} rays)")


def pair_kernels(results: dict, cfg, scene, accel, rays):
    """The two pair kernels vs their plain versions at the frame's own
    shapes, 8x8 tiles, as worklist_kernels, each also over its whole pass,
    and the closest-hit kernel on the shadow rays; then the two shadow-ray
    any-hit kernels against each other (compare_shadow_lists)."""
    o_t, d_t, _ = tile_rays(rays.o, rays.d, 64)
    words, counts, excess = cull_clusters_sorted(accel, o_t, d_t, T_FAR)
    check(int(excess) == 0, "pair primary cull dropped candidates")
    log(f"[wavefront] pair primary cull: {o_t.shape[0]} tiles of 64, {count_stats(counts)}, "
        f"total {int(counts.sum())}")
    compare_pairs(results, accel, o_t, d_t, None, words, counts)
    pair_closest_pass(results, accel, o_t, d_t, words, counts)
    trace_fn, _ = t3.make_pair_tracers(scene, accel)
    so, sd, tm = first_shadow_rays(scene, cfg, rays, trace_fn, 64)
    words, counts, excess = cull_clusters_sorted(accel, so, sd, tm)
    check(int(excess) == 0, "pair shadow cull dropped candidates")
    log(f"[wavefront] pair shadow cull (light 0): {so.shape[0]} tiles, "
        f"{count_stats(counts)}, total {int(counts.sum())}")
    pair_closest_general(accel, so, sd, words, counts)
    compare_pairs(results, accel, so, sd, tm, words, counts)
    pair_anyhit_pass(results, accel, so, sd, tm, words, counts)
    compare_shadow_lists(accel, so, sd, tm, words, counts)


def shared_origin_tiles(o4, d4) -> int:
    """Tiles whose live rays (some d != 0) all start at ray 0's origin, bit
    for bit: those on which pair_closest_kernel computes the origin's
    products once a cluster."""
    live = (d4[..., :3] != 0.0).any(-1)
    same = (float_bits(o4[..., :3]) == float_bits(o4[:, :1, :3])).all(-1) | ~live
    return int(same.all(1).sum())


def pair_closest_walk(o4, d4, w, lo, hi, offs, pwords):
    """pair_closest_plain's walk, replayed to count edge pairs: (ray, cluster)
    with a hit below the ray's best t at the step where the word is visited
    whose rounded slab entry is not below it. Such a ray gets the hit only
    if another ray votes for the cluster, so its result depends on the other
    rays' state at that step -> (bt, bid, clusters the walk tests, edge
    pairs of those clusters, edge pairs of every word under the tile's
    first bound, which is what a walk from other start states may test;
    past a tile's stop the best t is the final one)."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[2] // 3
    bt_all = o4.new_full((n_tiles, tr), T_FAR)
    bid_all = torch.full((n_tiles, tr), -1, dtype=torch.int32, device=o4.device)
    lanes = torch.arange(c, dtype=torch.int32, device=o4.device)
    walked = tested = reached = 0
    for a, b in t1._tile_chunks(n_tiles, tr, c):
        o4c, d4c, bt, bid = o4[a:b], d4[a:b], bt_all[a:b], bid_all[a:b]
        rt = t3._ray_rows(o4c[..., :3], d4c[..., :3])
        first = float_bits(bt).amax(1)
        bnd = first.clone()
        start, runs = offs[a:b].long(), (offs[a + 1:b + 1] - offs[a:b]).long()
        for j in range(int(runs.max()) if runs.numel() else 0):
            t = torch.nonzero(runs > j)[:, 0]
            word = pwords[start[t] + j]
            under = (word & ~_CL_MASK) < first[t]
            t, word = t[under], word[under]
            cl = (word & _CL_MASK).clamp_max(n_cl - 1).long()
            enter = t3._slab_enter(rt[t], lo[cl], hi[cl])
            tv = t2._cluster_t(o4c[t], d4c[t], w[cl], T_FAR)
            tmin = tv.amin(-1)
            edge = (tmin < bt[t]) & (enter >= bt[t])
            reached += int(edge.sum())
            test = ((word & ~_CL_MASK) < bnd[t]) & (enter < bt[t]).any(1)
            tested += int(edge[test].sum())
            walked += int(test.sum())
            t, cl, tv, tmin = t[test], cl[test], tv[test], tmin[test]
            lane = torch.where(tv == tmin[..., None], lanes, c).amin(-1)
            better = tmin < bt[t]
            bid[t] = torch.where(better, cl[:, None].to(torch.int32) * c + lane, bid[t])
            bt[t] = torch.where(better, tmin, bt[t])
            bnd[t] = float_bits(bt[t]).amax(1)
    return bt_all, bid_all, walked, tested, reached


def pair_closest_pass(results, accel, o_t, d_t, words, counts):
    """pair_closest_kernel's tail report on the comparison tiles, then the
    kernel on every tile of the pair tier's primary pass: bt bits and bid
    against its plain version and against pair_closest_walk's replay, three
    runs identical, the kernel-alone time, the bound on these tiles, the
    (ray, triangle) tests a second that the bound counts beside the SM clock
    under the load, the edge pairs of the pass and its shared-origin
    tiles."""
    sel = select_tiles(counts)

    def call(a, b):
        part = pair_case(accel, o_t, d_t, None, words, counts, sel[a:b])
        return lambda: t3.pair_closest(*part)

    tail_report("pair_closest", results, f"one block a tile, {t3.SLICES_PAIR_CLOSEST} threads "
                f"a ray, windows of {t3.WINDOW} words, a ring of {t3.NBUF_PAIR_CLOSEST} stages",
                counts[sel], call, None)
    args = pair_case(accel, o_t, d_t, None, words, counts, torch.arange(counts.shape[0],
                                                                         device=counts.device))
    t0 = time.perf_counter()
    out_k, out_p = t3.pair_closest(*args), t3.pair_closest_plain(*args)
    walk_bt, walk_bid, walked, tested, reached = pair_closest_walk(*args)
    bad = bit_mismatches(out_k, out_p)
    bad_walk = bit_mismatches((walk_bt, walk_bid), out_p)
    again = sum(sum(bit_mismatches(out_k, t3.pair_closest(*args))) for _ in range(2))
    torch.cuda.synchronize()
    cmp_s = time.perf_counter() - t0
    alone = device_ms(lambda: t3.pair_closest(*args), 10)
    bnd, tests, n_tests = pair_closest_bound(*args[:5], words, counts, out_k[0])
    mhz = clock_under_load(lambda: t3.pair_closest(*args), alone)
    sms = _launch.sm_count(0)
    log(f"[kernels] pair_closest on every tile of its pass (the primary rays: "
        f"{counts.shape[0]} tiles, {count_stats(counts)}, total {int(counts.sum())}; "
        f"{shared_origin_tiles(*args[:2])} tiles of one origin): bit mismatches bt {bad[0]}, "
        f"bid {bad[1]}, elements that differ between three runs {again}, the replayed walk "
        f"against the plain version {bad_walk} ({cmp_s:.1f} s, untimed), the walk tests "
        f"{walked} clusters; edge pairs (a hit "
        f"below the ray's best t, a slab entry not below it) in the clusters the walk tests "
        f"{tested}, in every word under a tile's first bound {reached}; kernel alone "
        f"{alone:.4f} ms; bound {bnd['bound_ms']:.5f} ms by {bnd['bound_by']} ({tests}), "
        f"kernel alone / bound {alone / bnd['bound_ms']:.2f}; {n_tests / alone / 1e6:.1f} G "
        f"(ray, triangle) tests/s of those the bound counts, beside {sms} SMs x 128 lanes x "
        f"{mhz} MHz (nvidia-smi, under this load) = {sms * 128 * mhz / 1e6:.2f} T "
        f"instructions/s")
    check(not any(bad) and not again and not any(bad_walk),
          "pair_closest: kernel disagrees with its plain version, or with itself, on the whole "
          "pass")


def pair_closest_general(accel, so, sd, words, counts):
    """pair_closest_kernel on the first light's shadow rays (origins on the
    surfaces, so the kernel's general path, which computes every ray's own
    origin products), every tile: bt bits and bid against its plain
    version."""
    args = pair_case(accel, so, sd, None, words, counts, torch.arange(counts.shape[0],
                                                                       device=counts.device))
    bad = bit_mismatches(t3.pair_closest(*args), t3.pair_closest_plain(*args))
    torch.cuda.synchronize()
    log(f"[kernels] pair_closest on the first light's shadow rays ({counts.shape[0]} tiles, "
        f"{shared_origin_tiles(*args[:2])} of them of one origin or none live, "
        f"{count_stats(counts)}): bit mismatches bt {bad[0]}, bid {bad[1]}")
    check(not any(bad), "pair_closest: kernel disagrees with its plain version on rays of "
                        "many origins")


def pair_anyhit_walk(o4, d4, tm, w, lo, hi, offs, pwords):
    """pair_anyhit_plain's walk, replayed to count edge pairs: (ray, cluster)
    with a hit at t < t_max whose rounded slab entry is >= t_max. Such a ray
    is occluded by the cluster only if another ray votes for it, so its
    result depends on the other rays' state when the word is visited ->
    (occ, edge pairs of the clusters the walk tests, edge pairs of every
    word under the tile's first bound, which is what a walk from other
    start states may test)."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[2] // 3
    occ_all = torch.zeros((n_tiles, tr), dtype=torch.bool, device=o4.device)
    tested = reached = 0
    for a, b in t1._tile_chunks(n_tiles, tr, c):
        o4c, d4c, tmc, occ = o4[a:b], d4[a:b], tm[a:b], occ_all[a:b]
        rt = t3._ray_rows(o4c[..., :3], d4c[..., :3])
        first = float_bits(tmc).amax(1)
        bnd = first.clone()
        start, runs = offs[a:b].long(), (offs[a + 1:b + 1] - offs[a:b]).long()
        for j in range(int(runs.max()) if runs.numel() else 0):
            t = torch.nonzero(runs > j)[:, 0]
            entry = pwords[start[t] + j] & ~_CL_MASK
            under = entry < first[t]
            t, entry = t[under], entry[under]
            cl = (pwords[start[t] + j] & _CL_MASK).clamp_max(n_cl - 1).long()
            enter = t3._slab_enter(rt[t], lo[cl], hi[cl])
            hit = t2._cluster_t(o4c[t], d4c[t], w[cl], tmc[t][..., None]).amin(-1) < T_FAR
            edge = hit & (enter >= tmc[t])
            reached += int(edge.sum())
            test = (entry < bnd[t]) & ((enter < tmc[t]) & ~occ[t]).any(1)
            tested += int(edge[test].sum())
            tt = t[test]
            occ[tt] |= hit[test]
            bnd[tt] = float_bits(torch.where(occ[tt], 0.0, tmc[tt])).amax(1)
    return occ_all, tested, reached


def pair_anyhit_pass(results, accel, so, sd, tm, words, counts):
    """pair_anyhit_kernel's tail report on the comparison tiles, then the
    kernel on every tile of the pair tier's shadow pass: occlusion against
    its plain version and against pair_anyhit_walk's replay, three runs
    identical, kernel-alone time, the bound on these tiles, and the edge
    pairs of the pass."""
    sel = select_tiles(counts)
    sel = sel[counts[sel] > 0]
    def call(a, b):
        part = pair_case(accel, so, sd, tm, words, counts, sel[a:b])
        return lambda: t3.pair_anyhit(*part)

    tail_report("pair_anyhit", results, f"one block a tile, {t3.SLICES_PAIR} threads a ray, "
                f"windows of {t3.WINDOW} words, a ring of {t3.NBUF_PAIR} stages", counts[sel],
                call, None)
    args = pair_case(accel, so, sd, tm, words, counts, torch.arange(counts.shape[0],
                                                                    device=counts.device))
    t0 = time.perf_counter()
    occ_k, occ_p = t3.pair_anyhit(*args), t3.pair_anyhit_plain(*args)
    walk, tested, reached = pair_anyhit_walk(*args)
    again = sum(int((occ_k != t3.pair_anyhit(*args)).sum()) for _ in range(2))
    bad, bad_walk = int((occ_k != occ_p).sum()), int((walk != occ_p).sum())
    cmp_s = time.perf_counter() - t0
    alone = device_ms(lambda: t3.pair_anyhit(*args), 10)
    bnd, tests = pair_anyhit_bound(*args[:6], words, counts, occ_k)
    log(f"[kernels] pair_anyhit on every tile of its pass (the first light's shadow rays: "
        f"{counts.shape[0]} tiles, {count_stats(counts)}, total {int(counts.sum())}): occ "
        f"mismatches {bad}, elements that differ between three runs {again}, the replayed "
        f"walk against the plain version {bad_walk} ({cmp_s:.1f} s, untimed); edge pairs "
        f"(a hit under t_max, a slab entry at or past it) in the clusters the walk tests "
        f"{tested}, in every word under a tile's first bound {reached}; kernel alone "
        f"{alone:.4f} ms; bound {bnd['bound_ms']:.5f} ms by {bnd['bound_by']} ({tests}), "
        f"kernel alone / bound {alone / bnd['bound_ms']:.2f}")
    check(not bad and not again and not bad_walk,
          "pair_anyhit: kernel disagrees with its plain version, or with itself, on the whole "
          "pass")


def phase_wavefront_kernels(results: dict, cfg, scene, camera, accel):
    """The four kernels of the work-list and pair tiers vs their plain
    versions at the frame's own shapes."""
    with torch.inference_mode():
        rays = generate_rays(camera, cfg.height, cfg.width)
        worklist_kernels(results, cfg, scene, accel, rays)
        worklist_cluster_size(cfg, scene, rays)
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


def golden_gate(a, b, what: str, frac_tol: float = 0.015):
    """< frac_tol (1.5%) of pixels off by > 2e-3 and p98 error < 2e-3, or
    exit (tests/golden/test_golden_cpp.py:_golden_check)."""
    err = np.abs(a - b).max(axis=-1)
    frac = float((err > 2e-3).mean())
    p98 = float(np.percentile(err, 98))
    log(f"[gate] {what}: pixels off by > 2e-3: {frac:.4%} (gate {frac_tol:.1%}), p98 "
        f"{p98:.3g}, max {err.max():.3g}")
    if not (frac < frac_tol and p98 < 2e-3):
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
    return res


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


GRAD_FAMILIES = ("verts", "albedo", "cam_pos")
TIERED = ("closest", "closest_fast", "anyhit")


def zero_launches():
    for key in t2.LAUNCHES:
        t2.LAUNCHES[key] = 0


def sgd_grads(cfg, mode: str, dev: str, target):
    """One SGD(1.0) step of make_grad_step_fn(tiled=mode) on `dev` -> (loss,
    {family: gradient}), the gradient read as params_before - params_after."""
    scene, camera = api.get_scene(cfg, dev)
    p = api.grad_params(scene, camera, GRAD_FAMILIES)
    before = {k: v.detach().clone() for k, v in p.items()}
    step = api.make_grad_step_fn(cfg, scene, camera, mode, device=dev)
    loss, p, _, aux = step(scene, camera, torch.as_tensor(target, device=dev), p,
                           torch.optim.SGD(p.values(), lr=1.0))
    check(aux == {"overflow": 0}, f"{dev} {mode} grad step: aux {aux}")
    return float(loss), {k: (before[k] - p[k].detach()).cpu().numpy() for k in p}


def phase_grad_devices(cfg, devs=("cuda", "cpu")):
    """(a, b): the grad step on the card against the CPU, through the tiled
    tier ("auto" with use_pallas) and the jnp tier ("off"), with a real
    target (a CPU frame + 0.05). Gate: loss to rtol 1e-5; each gradient
    nonzero on both and within rtol 2e-3 + atol 2e-6 of its largest."""
    scene, camera = api.get_scene(cfg, "cpu")
    target = api.make_render_fn(scene, cfg, "cpu")(scene, camera).numpy() + np.float32(0.05)
    for mode in ("auto", "off"):
        tier = "tiled" if api.use_tiled_grad(scene, cfg, mode) else "jnp"
        (la, ga), (lb, gb) = (sgd_grads(cfg, mode, dev, target) for dev in devs)
        rel = abs(la - lb) / abs(lb)
        parts = []
        for k in GRAD_FAMILIES:
            a, b = ga[k], gb[k]
            tol = 2e-3 * np.abs(b) + 2e-6 * np.abs(b).max() + 1e-10
            worst = float((np.abs(a - b) / tol).max())
            parts.append(f"{k} max|g| {np.abs(b).max():.4g}, max|diff| "
                         f"{np.abs(a - b).max():.3g} ({worst:.3f} of the tolerance)")
            check(np.abs(a).max() > 0 and np.abs(b).max() > 0, f"{tier} tier: {k} gradient 0")
            check(worst <= 1.0, f"{tier} tier: {k} gradients differ, {devs[0]} vs {devs[1]}")
        log(f"[grad] {cfg.scene} {cfg.width}x{cfg.height}, {tier} tier, {devs[0]} vs {devs[1]}: "
            f"loss {la:.9g} vs {lb:.9g} (rel {rel:.3g}); " + "; ".join(parts))
        check(rel <= 1e-5, f"{tier} tier: loss {la} vs {lb}")


def phase_grad_launches(dev="cuda"):
    """(c): one tiled bunny512 grad step launches the tiled tier's kernels
    (closest_fast only where the frame has count-1 tiles) and no other."""
    cfg = load_config("bunny512")
    scene, camera = api.get_scene(cfg, dev)
    _, aux = api.make_render_fn(scene, cfg, dev)(scene, camera, with_aux=True)
    want = ["closest", "anyhit"] + (["closest_fast"] if aux["need_zero"] > aux["need_split"]
                                    else [])
    p = api.grad_params(scene, camera, GRAD_FAMILIES)
    step = api.make_grad_step_fn(cfg, scene, camera, device=dev)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    opt = torch.optim.Adam(p.values(), lr=1e-3)
    step(scene, camera, target, p, opt)                   # warm
    torch.cuda.synchronize()
    zero_launches()
    step(scene, camera, target, p, opt)
    torch.cuda.synchronize()
    launches = dict(t2.LAUNCHES)
    log(f"[grad] one tiled bunny512 step ({aux['need_split']} generic and "
        f"{aux['need_zero'] - aux['need_split']} count-1 primary tiles): launches {launches}")
    missing = [k for k in want if launches[k] == 0]
    stray = [k for k, v in launches.items() if v and k not in want]
    check(not missing and not stray,
          f"the tiled grad step never launched {missing}, and launched {stray}")


def grad_run(what: str, dev="cuda", **kw) -> dict:
    """benchmark_grad_step(**kw) on `dev` with its peak device memory and
    launches; None for a run that ran out of device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        res = api.benchmark_grad_step(**kw, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        res, why = None, str(e).splitlines()[0][:160]
    if res is None:                  # the failed step's tensors are released by now
        torch.cuda.empty_cache()
        log(f"[grad] {what}: out of device memory ({why})")
        return None
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["launches"] = dict(t2.LAUNCHES)
    cfg = res["config"]
    log(f"[grad] {what}: {cfg.scene} {cfg.width}x{cfg.height}, {kw.get('iters', 5)} steps after "
        f"{kw.get('warmup', 1)}, params {kw.get('params', ('verts',))}, tiled "
        f"{kw.get('tiled', 'auto')}: {res['grad_step_ms']:.3f} ms/step, loss {res['loss']:.6g}, "
        f"overflow {res['overflow']}, peak device memory {res['peak_gib']:.3f} GiB, "
        f"launches {sum(res['launches'].values())}")
    check(res["overflow"] == 0, f"{what}: overflow {res['overflow']}")
    return res


def without_checkpoint(fn, *args, **kwargs):
    """fn with the plain tier's per-slot checkpoint replaced by a direct call."""
    real = t1.checkpoint
    t1.checkpoint = lambda step, *a, **kw: step(*a)
    try:
        return fn(*args, **kwargs)
    finally:
        t1.checkpoint = real


def phase_grad_split(reps: int = 5, dev="cuda"):
    """The tiled bunny512 step (verts, albedo, cam_pos; Adam) in parts, a
    sync after each, host clock, median of `reps` after one warm-up: the
    params put in (normals by the gather) and the accel built; the frame and
    the loss; backward; the optimizer."""
    cfg = load_config("bunny512")
    scene, camera = api.get_scene(cfg, dev)
    p = api.grad_params(scene, camera, GRAD_FAMILIES)
    opt = torch.optim.Adam(p.values(), lr=1e-3)
    normal_fn = make_vertex_normal_fn(scene.tris.cpu().numpy(), scene.verts.shape[0], device=dev)
    wcfg = whitted.WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    s = {}

    def accel_build():
        s["scene"], s["camera"] = api._apply_grad_params(scene, camera, p, normal_fn)
        s["accel"] = build_scene_accel(s["scene"])

    def render_loss():
        img = tiled.render_tiled(s["scene"], s["accel"], s["camera"], cfg.height, cfg.width, wcfg)
        s["loss"] = torch.mean((img - target) ** 2)

    def backward():
        s["loss"].backward()

    def optimizer():
        opt.step()
        opt.zero_grad(set_to_none=True)

    parts = (accel_build, render_loss, backward, optimizer)
    times = {fn.__name__: [] for fn in parts}
    for rep in range(reps + 1):
        for fn in parts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rep:
                times[fn.__name__].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    total = sum(med.values())
    log(f"[grad] tiled bunny512 step in parts, median of {reps} (ms): "
        + ", ".join(f"{k} {v:.3f} ({v / total:.1%})" for k, v in med.items())
        + f"; sum {total:.3f}")
    if dev != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fn in parts:
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=20))
    idle = f"idle {1.0 - busy / wall:.1%}" if busy > 0.0 else "idle share not measured"
    log(f"[grad] one profiled tiled bunny512 step: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, {idle}")


def phase_grad(smi: str, frame: dict, dev="cuda", mem_hw: int = 128):
    """Phase 17: the grad step on the card (see the module docstring); the
    jnp tier's memory with and without the checkpoint also at mem_hw^2."""
    phase_grad_devices(load_config("bunny-grad", height=64, width=64, use_pallas=True),
                       (dev, "cpu"))
    phase_grad_launches(dev)
    grads = {}
    for key, kw in bench_torch.GRAD_RUNS.items():
        res = grad_run(key, dev, **kw)
        check(res is not None, f"{key}: out of device memory")
        cfg = res["config"]
        tiled_tier = kw.get("tiled", "auto") != "off" and cfg.use_bvh and cfg.use_pallas
        stray = [k for k, v in res["launches"].items()
                 if v and not (tiled_tier and k in TIERED)]
        check(not stray and (not tiled_tier or res["launches"]["closest"] > 0),
              f"{key}: launches {res['launches']}")
        grads[key] = res
    jnp_kw = bench_torch.GRAD_RUNS["grad_step_bunny512_jnp_ms"]
    small = dict(jnp_kw, height=mem_hw, width=mem_hw)
    grad_run(f"bunny512 jnp tier at {mem_hw}x{mem_hw}, checkpointed", dev, **small)
    without_checkpoint(grad_run, f"bunny512 jnp tier at {mem_hw}x{mem_hw}, no checkpoint", dev,
                       **small)
    without_checkpoint(grad_run, "bunny512 jnp tier, no checkpoint", dev, **jnp_kw)
    phase_grad_split(dev=dev)
    rc, line = bench_torch.bench_line("bench100k", frame, grads)
    log(f"[grad] bench_torch.py line, on {smi}:")
    print(json.dumps(line), flush=True)
    check(rc == 0, f"bench_torch.py's line says exit code {rc}")


# Phase 18: the fit's five loss modes, (mode, preset, config overrides,
# edge_aware), in diff.fit.make_loss_fn's order, and the presets' full-size
# fits in the modes bin/fit_torch reaches: (mode, preset, steps).
FIT_MODES = (("tiled", "bunny-grad", {"use_pallas": True}, False),
             ("edge accel", "bunny-grad", {}, True),
             ("edge brute", "cornell256", {}, True),
             ("replay", "cornell256", {}, False),
             ("jnp", "bunny-grad", {}, False))
FIT_RUNS = (("jnp", "bunny-grad", 10), ("edge accel", "bunny-grad", 10),
            ("replay", "cornell256", 10), ("edge brute", "cornell256", 10),
            ("tiled", "bunny512", 5))
FIT_LR = 5e-3  # bin/fit_torch's default


def fit_scene(cfg, dev, off_center: bool = False):
    """The preset's (scene, camera) on `dev`. With off_center the camera
    looks 0.0123 and 0.0071 off the preset's point, so that no pixel centre
    lies on a projected edge, where the last bit of a direction decides
    which of two walls a ray hits (ROADMAP Queue 3)."""
    scene, camera = api.get_scene(cfg, dev)
    if off_center:
        camera = dataclasses.replace(camera, look_at=camera.look_at + torch.tensor(
            [0.0123, 0.0071, 0.0], device=dev))
    return scene, camera


def scene_frame(cfg, dev) -> np.ndarray:
    """make_render_fn's frame of fit_scene(cfg, dev, off_center=True)."""
    scene, camera = fit_scene(cfg, dev, off_center=True)
    return api.make_render_fn(scene, cfg, dev)(scene, camera).cpu().numpy()


def fit_target(cfg, dev, off_center: bool = False):
    """(scene, camera, target) on `dev`: the target is the frame
    (make_render_fn) of the scene with its vertices moved by bin/fit_torch's
    seeded offset (stddev 0.02)."""
    scene, camera = fit_scene(cfg, dev, off_center)
    off = np.random.default_rng(0).normal(0, 0.02, tuple(scene.verts.shape)).astype(np.float32)
    s_true = dataclasses.replace(scene, verts=scene.verts + torch.as_tensor(off, device=dev))
    return scene, camera, api.make_render_fn(s_true, cfg, dev)(s_true, camera).clone()


def fit_loss_grads(cfg, fcfg, dev, target_cpu):
    """make_loss_fn's loss and gradients (vert_offset, albedo) at the
    initial parameters on `dev`, and the launches of that one loss and
    backward."""
    scene, camera = fit_scene(cfg, dev, off_center=True)
    loss_fn = make_loss_fn(scene, camera, torch.as_tensor(target_cpu, device=dev), cfg, fcfg)
    params = init_params(scene, fcfg)
    zero_launches()
    loss, overflow = loss_fn(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    if dev == "cuda":
        torch.cuda.synchronize()
    check(int(overflow) == 0, f"{dev}: overflow {overflow}")
    return (float(loss.detach()), {k: g.cpu().numpy() for k, g in zip(params, grads)},
            dict(t2.LAUNCHES))


def phase_fit_devices(size: int = 64, devs=("cuda", "cpu")):
    """(a): each of the fit's five loss modes at size x size on the card
    against the CPU, from one target (a CPU frame), held to the grad gate:
    loss to rtol 1e-5; each gradient (vert_offset, albedo) nonzero and
    within rtol 2e-3 + atol 2e-6 of its largest entry. The tiled mode
    launches the three traversal2.cu kernels on the card, the others
    none."""
    for mode, preset, over, edge_aware in FIT_MODES:
        cfg = load_config(preset, height=size, width=size, **over)
        fcfg = FitConfig(optimize_albedo=True, edge_aware=edge_aware)
        _, _, target = fit_target(cfg, "cpu", off_center=True)
        (la, ga, launches), (lb, gb, _) = (fit_loss_grads(cfg, fcfg, dev, target.numpy())
                                           for dev in devs)
        rel = abs(la - lb) / abs(lb)
        parts = []
        for k in gb:
            a, b = ga[k], gb[k]
            tol = 2e-3 * np.abs(b) + 2e-6 * np.abs(b).max() + 1e-10
            worst = float((np.abs(a - b) / tol).max())
            parts.append(f"{k} max|g| {np.abs(b).max():.4g}, max|diff| {np.abs(a - b).max():.3g} "
                         f"({worst:.3f} of the tolerance)")
            check(np.abs(a).max() > 0 and np.abs(b).max() > 0, f"fit {mode}: {k} gradient 0")
            check(worst <= 1.0, f"fit {mode}: {k} gradients differ, {devs[0]} vs {devs[1]}")
        frames = [scene_frame(cfg, dev) for dev in devs]
        err = np.abs(frames[0] - frames[1]).max(axis=-1)
        log(f"[fit] {mode} mode, {preset} {size}x{size}, {devs[0]} vs {devs[1]}: loss {la:.9g} "
            f"vs {lb:.9g} (rel {rel:.3g}); " + "; ".join(parts) + f"; launches {launches}; "
            f"the scene's frames differ in {int((err > 1e-4).sum())} pixels by more than 1e-4 "
            f"(max {err.max():.3g})")
        check(rel <= 1e-5, f"fit {mode}: loss {la} vs {lb}")
        tiled_card = mode == "tiled" and devs[0] == "cuda"
        check((not tiled_card or launches["closest"] > 0 and launches["anyhit"] > 0)
              and not any(v for k, v in launches.items() if not (tiled_card and k in TIERED)),
              f"fit {mode}: launches {launches}")


class StepClock:
    """A MetricsLogger stand-in for fit: the host clock at each step's
    record (fit reads each step's loss back first, which waits for the
    device)."""

    def __init__(self):
        self.times = []

    def log(self, **_fields):
        self.times.append(time.perf_counter())

    def ms_per_step(self) -> float:
        """Mean ms of a step after the first (the warm-up)."""
        return float(np.mean(np.diff(self.times))) * 1e3


def phase_fit_runs(dev="cuda"):
    """(b): bin/fit_torch's fits at the presets' full size (verts, Adam
    5e-3): the loss falls (last < first), per-step launches (the tiled mode
    one of each traversal2.cu kernel a step, closest_fast_kernel where the
    frame has count-1 tiles; the others none), ms a step (mean after the
    first, host clock between the steps' loss read-backs) and peak device
    memory."""
    for mode, preset, steps in FIT_RUNS:
        cfg = load_config(preset)
        scene, camera, target = fit_target(cfg, dev)
        want = ()
        if mode == "tiled":
            _, aux = api.make_render_fn(scene, cfg, dev)(scene, camera, with_aux=True)
            want = ("closest", "anyhit") + (("closest_fast",)
                                            if aux["need_zero"] > aux["need_split"] else ())
        check(api.use_tiled_grad(scene, cfg, "auto") == (mode == "tiled"),
              f"{preset}: the fit's mode is not {mode}")
        clock = StepClock()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        _, losses = fit(scene, camera, target, cfg,
                        FitConfig(steps=steps, learning_rate=FIT_LR,
                                  edge_aware=mode.startswith("edge")), metrics=clock)
        torch.cuda.synchronize()
        launches = dict(t2.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[fit] {mode} mode, {preset} {cfg.width}x{cfg.height}, {steps} steps: loss "
            f"{losses[0]:.6g} -> {losses[-1]:.6g} (min {min(losses):.6g}), "
            f"{clock.ms_per_step():.3f} ms/step after the first, peak device memory "
            f"{peak:.3f} GiB, "
            f"launches {launches} ({sum(launches.values()) / steps:g} a step)")
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"fit {mode} on {preset}: the loss did not fall: {losses}")
        check(all(launches[k] == steps for k in want)
              and not any(v for k, v in launches.items() if k not in want),
              f"fit {mode} on {preset}: launches {launches}, want one of {want} a step")


def phase_fit_resume(dev="cuda"):
    """(c): a 6-step fit (cornell256 at 64x64, replay mode) checkpointed
    every 3 steps, then resumed to 9: exactly 3 more steps, finite."""
    cfg = load_config("cornell256", height=64, width=64)
    scene, camera, target = fit_target(cfg, dev)
    with tempfile.TemporaryDirectory() as ck:
        _, first = fit(scene, camera, target, cfg, FitConfig(
            steps=6, learning_rate=FIT_LR, checkpoint_every=3, checkpoint_dir=ck))
        saved = latest_checkpoint(ck)[0]
        _, more = fit(scene, camera, target, cfg, FitConfig(
            steps=9, learning_rate=FIT_LR, checkpoint_every=3, checkpoint_dir=ck))
        last = latest_checkpoint(ck)[0]
    log(f"[fit] checkpoint/resume on {dev}: 6 steps {first[0]:.6g} -> {first[-1]:.6g}, "
        f"checkpoint at step {saved}; resumed: {len(more)} steps, {more}, checkpoint at {last}")
    check(saved == 5 and len(more) == 3 and last == 8 and np.isfinite(more).all(),
          "the resumed fit did not run exactly the 3 steps left")


def trace_cli(preset: str, out_dir: str) -> float:
    """bin/trace_torch --preset <preset> as a subprocess on the card: exit
    0, its PNG read back with read_png of the right shape, neither blank nor
    saturated, overflow 0 and no non-finite value in the frame -> its
    steady-state frame's ms."""
    cfg = load_config(preset)
    png = os.path.join(out_dir, f"{preset}.png")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bin", "trace_torch"), "--preset",
                           preset, "-o", png], capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    log(f"[trace] bin/trace_torch --preset {preset} ({wall:.1f} s, exit {proc.returncode}):\n"
        + proc.stdout.strip())
    check(proc.returncode == 0, f"bin/trace_torch {preset} failed:\n{proc.stderr[-4000:]}")
    m = re.search(r"steady-state frame: ([0-9.]+) ms .*overflow (\d+), non-finite values (\d+)",
                  proc.stdout)
    check(m is not None, f"bin/trace_torch {preset}: no steady-state line")
    img = read_png(png)
    lit = float((img > 0).mean())
    log(f"[trace] {png}: {img.shape}, mean {img.mean():.2f}, {lit:.1%} of values above 0, "
        f"{float((img == 255).mean()):.1%} at 255")
    check(img.shape == (cfg.height, cfg.width, 3), f"{preset}: PNG of shape {img.shape}")
    check(int(m.group(2)) == 0 and int(m.group(3)) == 0,
          f"{preset}: overflow {m.group(2)}, non-finite values {m.group(3)}")
    check(2.0 < img.mean() < 250.0 and lit > 0.05 and (img == 255).mean() < 0.9,
          f"{preset}: the frame is blank or saturated (mean {img.mean()})")
    return float(m.group(1))


def phase_fit(smi: str):
    """Phase 18: the fit and the command lines (see the module docstring)."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 products are on: intersect_packed "
          "would misclassify hits")
    phase_fit_devices()
    phase_fit_runs()
    phase_fit_resume()
    with tempfile.TemporaryDirectory() as out_dir:
        for preset in ("cornell256", "bench100k", "sponza1080"):
            ms = trace_cli(preset, out_dir)
            log(f"[trace] {preset}: steady-state frame {ms:.3f} ms on {smi}")
    phase_cross_device(load_config("sponza1080", height=72, width=128))
    rc, line = bench_torch.run("sponza1080", 10, grad=False)
    log(f"[trace] bench_torch.py line of sponza1080 (BENCH_PRESET=sponza1080 BENCH_GRAD=0), "
        f"on {smi}:")
    print(json.dumps(line), flush=True)
    check(rc == 0, f"sponza1080's bench line says exit code {rc}")


# ---------------------------------------------------------------------------
# Phase 19
# ---------------------------------------------------------------------------

# A stage's largest difference between the devices, in units of 2^-23 of its
# scale, above which it is the one that departs (ROADMAP Queue 3).
STAGE_ULPS = 4
# What each stage of a Whitted bounce computes, by the stage's name.
STAGE_OPS = {
    "rays": "generate_rays: tan of the half angle, the NDC products, normalize's rsqrt",
    "hit": "intersect_brute: the products o4 @ w and d4 @ w (a float32 matmul), "
           "t = -so / sd, u and v",
    "shading frame": "shading_frame: p = o + t d, the flat normal cross(v1 - v0, v2 - v0) "
                     "and normalize's rsqrt",
    "shadow ray": "shadow_ray: dist2 = dot(to_l, to_l), sqrt, wi = to_l / dist, cos",
    "phong": "phong_specular: the reflection, dot, base ** shininess",
    "direct": "direct_lighting: the occlusion, vis / dist2, albedo / pi * cos",
    "radiance": "bounce_step: emission + albedo * ambient + direct, the mirror weights",
}


def to_dev(x, dev):
    """A tensor, or a dataclass of tensors (Ray, Hit), moved to `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).to(dev)
                                     for f in dataclasses.fields(x)})


def ulps(a, b, scale, mask=None) -> float:
    """The largest |a - b| / scale over the entries `mask` selects, in units
    of 2^-23 (the spacing of float32 numbers just above 1)."""
    a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
            for x in (a, b))
    err = np.abs(a - b) / np.maximum(np.broadcast_to(scale, a.shape), 1e-30)
    if mask is not None:
        err = err[np.broadcast_to(np.asarray(mask), err.shape[:np.asarray(mask).ndim])]
    return float(err.max()) / 2.0 ** -23 if err.size else 0.0


def norm_scale(x):
    """Each entry's scale: the length of its vector along the last axis."""
    x = np.asarray(x.cpu(), np.float64)
    return np.linalg.norm(x, axis=-1, keepdims=True)


def bounce_stages(dev, scene, camera, size, cfg, feed=None) -> dict:
    """The stages of one Whitted bounce of (scene, camera) on `dev` ->
    {stage: (outputs on the CPU)}. With `feed` (another device's result of
    this function) each stage takes its inputs from feed's earlier stages,
    so that only its own arithmetic differs; without, from its own."""
    trace_fn, occlude_fn = whitted.make_brute_tracers(scene)
    src = {}
    out = {}

    def get(stage):
        return tuple(to_dev(x, dev) for x in (feed or src)[stage])

    def put(stage, *xs):
        src[stage] = xs
        out[stage] = tuple(to_dev(x, "cpu") for x in xs)

    ray = generate_rays(camera, size, size)
    put("rays", ray)
    (ray,) = get("rays")
    put("hit", trace_fn(ray))
    (hit,) = get("hit")
    p, n, mat = whitted.shading_frame(scene, ray, hit, cfg.smooth_shading)
    put("shading frame", p, n, mat)
    p, n, mat = get("shading frame")
    _, tm, d2, wi, cos = whitted.shadow_ray(p, n, hit.valid, scene.lights.position[0])
    put("shadow ray", tm, d2, wi, cos)
    _, _, wi, _ = get("shadow ray")
    alb, emi, mir, spec, shin = whitted.material_rows(scene.materials, mat)
    put("phong", whitted.phong_specular(ray.d, n, wi, spec, shin))
    put("direct", whitted.direct_lighting(scene, p, n, ray.d, alb, spec, shin, hit.valid,
                                          occlude_fn))
    (direct,) = get("direct")
    local = emi + alb * whitted.WhittedConfig.ambient + direct
    put("radiance", torch.where(hit.valid[..., None], local * (1.0 - mir), 0.0))
    return out


def stage_ulps(a: dict, b: dict) -> tuple[dict, np.ndarray, np.ndarray]:
    """Each stage's largest difference between two bounce_stages results,
    in units of 2^-23 of its scale (unit vectors and barycentrics: 1; t,
    points, distances: their own size; colours: the colour's length), over
    the pixels whose hit is the same triangle in both -> ({stage: ulps},
    same hit, compared)."""
    (ha,), (hb,) = a["hit"], b["hit"]
    same = (ha.tri == hb.tri).numpy()
    valid = same & hb.valid.numpy()
    mag = lambda x: np.abs(x.numpy())  # noqa: E731
    err = {"rays": ulps(a["rays"][0].d, b["rays"][0].d, 1.0),
           "hit": max(ulps(ha.t, hb.t, mag(hb.t), valid), ulps(ha.uv, hb.uv, 1.0, valid))}
    (pa, na, _), (pb, nb, _) = a["shading frame"], b["shading frame"]
    err["shading frame"] = max(ulps(pa, pb, norm_scale(pb), valid), ulps(na, nb, 1.0, valid))
    (tma, d2a, wia, cosa), (tmb, d2b, wib, cosb) = a["shadow ray"], b["shadow ray"]
    err["shadow ray"] = max(ulps(tma, tmb, mag(tmb), valid), ulps(d2a, d2b, mag(d2b), valid),
                            ulps(wia, wib, 1.0, valid), ulps(cosa, cosb, 1.0, valid))
    err["phong"] = ulps(a["phong"][0], b["phong"][0], mag(b["phong"][0]), valid)
    for k in ("direct", "radiance"):
        err[k] = ulps(a[k][0], b[k][0], norm_scale(b[k][0]), valid)
    return err, same, valid


def phase_cornell_stages(size: int = 64, devs=("cuda", "cpu")):
    """cornell256 at size x size, with phase 18 (a)'s camera, one Whitted
    bounce stage by stage on devs[0] against devs[1] (bounce_stages,
    stage_ulps): first each stage from the same inputs, devs[1]'s outputs
    of the stages before it, so that its difference is its own arithmetic's;
    then each device from its own. Prints both and the first stage past
    STAGE_ULPS in each, with the operations it runs. Then the loss of phase
    18 (a)'s replay mode on each device, in float32 on the device and in
    float64 on the host from each device's frame, and which pixels carry
    the float64 gap: those off by more than 1e-4, and the fewest that carry
    half of it, with their radiance against the frame's. Returns the
    isolated {stage: ulps}."""
    cfg = load_config("cornell256", height=size, width=size)
    a_dev, b_dev = devs
    (sa, ca), (sb, cb) = (fit_scene(cfg, dev, off_center=True) for dev in devs)
    with torch.inference_mode():
        ref = bounce_stages(b_dev, sb, cb, size, cfg)
        runs = {"from the same inputs": bounce_stages(a_dev, sa, ca, size, cfg, feed=ref),
                "each from its own": bounce_stages(a_dev, sa, ca, size, cfg)}
    isolated = None
    for what, got in runs.items():
        err, same, valid = stage_ulps(got, ref)
        isolated = isolated or err
        first = next((k for k, v in err.items() if v > STAGE_ULPS), None)
        log(f"[cornell] cornell256 {size}x{size} stages, {a_dev} vs {b_dev} {what}: largest "
            f"difference in 2^-23 of its scale over the {int(valid.sum())} pixels with the same "
            f"hit ({int((~same).sum())} differ): "
            + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
            + f"; first stage past {STAGE_ULPS}: "
            + (f"{first}, which runs {STAGE_OPS[first]}" if first else "none"))
    fcfg = FitConfig(optimize_albedo=True)
    _, _, target = fit_target(cfg, b_dev, off_center=True)
    target = target.cpu().numpy()
    loss32 = {dev: fit_loss_grads(cfg, fcfg, dev, target)[0] for dev in devs}
    frames = {dev: scene_frame(cfg, dev).astype(np.float64) for dev in devs}
    sq = {dev: ((frames[dev] - target) ** 2) for dev in devs}
    loss64 = {dev: float(sq[dev].mean()) for dev in devs}
    gap = (sq[a_dev] - sq[b_dev]).sum(axis=-1) / sq[a_dev].size
    off = np.abs(frames[a_dev] - frames[b_dev]).max(axis=-1) > 1e-4
    rest = np.where(off, 0.0, gap)
    order = np.argsort(-np.abs(rest), axis=None)
    carried = ""
    if rest.sum():
        half = int(np.searchsorted(np.cumsum(rest.ravel()[order]) / rest.sum(), 0.5) + 1)
        top = np.unravel_index(order[:half], rest.shape)
        lum = np.linalg.norm(frames[b_dev], axis=-1)
        carried = (f"; of the rest, {rest.sum():.3g}, {half} pixels carry half, of radiance "
                   f"length {lum[top].mean():.3g} on average against the frame's "
                   f"{lum.mean():.3g}, and differ there by "
                   f"{np.abs(frames[a_dev] - frames[b_dev])[top].max():.3g} at most")
    log(f"[cornell] replay-mode loss, float32 on the device: {a_dev} {loss32[a_dev]:.9g}, "
        f"{b_dev} {loss32[b_dev]:.9g} (rel "
        f"{abs(loss32[a_dev] - loss32[b_dev]) / loss32[b_dev]:.3g}); float64 on the host from "
        f"each device's frame: {loss64[a_dev]:.12g} vs {loss64[b_dev]:.12g} (rel "
        f"{abs(gap.sum()) / loss64[b_dev]:.3g}); the {int(off.sum())} pixels off by more than "
        f"1e-4 carry {gap[off].sum():.3g} of the gap {gap.sum():.3g}" + carried)
    return isolated


def golden_oracle(img, scene, camera, height, width, cfg_whitted, what,
                  frac_tol: float = 0.015):
    """The frame against the fp64 C++ oracle (refcpu.cpp, built from
    cpp/oracle.cpp) on the same scene and camera, under the golden gate
    (frac_tol: the reference's 2.5% for a 3-bounce, 2-light band); the
    frame must be lit (max > 0.05). Returns the oracle's frame."""
    t0 = time.perf_counter()
    ref = cpp_oracle.cpp_render(scene, camera, height, width, max_bounces=cfg_whitted.max_bounces,
                                smooth_shading=cfg_whitted.smooth_shading)
    log(f"[golden] {what}: the C++ oracle's {width}x{height} frame in "
        f"{time.perf_counter() - t0:.1f} s")
    check(np.isfinite(img).all() and img.max() > 0.05, f"{what}: frame not finite and lit "
          f"(max {img.max()})")
    golden_gate(img, ref, what, frac_tol)
    return ref


def whole_set_tracers(scene, accel, tr: int = 64):
    """(trace_fn, occlude_fn) of make_sorted_tracers' pipeline with the
    whole-set passes trace_tiles_sorted and any_hit_tiles_sorted in place
    of the split ones."""

    def trace_fn(ray):
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        words, counts, _, _ = cull_clusters_sorted2(accel, o_t, d_t, T_FAR)
        bt, gid = t2.trace_tiles_sorted(o_t, d_t, accel, words, counts)
        return t2.recover_hit(scene, ray, untile(bt, tiling), untile(gid, tiling), accel)

    def occlude_fn(ray, t_max):
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        t_max_t = tiled_tmax(t_max, ray, o_t, tr)
        words, counts, _, _ = cull_clusters_sorted2(accel, o_t, d_t, t_max_t)
        return untile(t2.any_hit_tiles_sorted(o_t, d_t, t_max_t, accel, words, counts), tiling)

    return trace_fn, occlude_fn


def launched(fn, *args, **kwargs):
    """(fn's result, the launches it made): every count set to 0 just
    before, read just after a synchronize."""
    zero_launches()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, {k: v for k, v in t2.LAUNCHES.items() if v}


def phase_sorted(smi: str, dev="cuda") -> dict:
    """(a) trace_tiles_sorted and any_hit_tiles_sorted over bench100k's
    primary tiles and its shadow-segment tiles at 1920x1080: bit-equal to
    trace_tiles_split and any_hit_tiles_graded on the same inputs and to the
    plain versions on select_tiles' subset; their launches (counts set to 0
    just before each pass) and each pass's ms (CUDA events, 10 passes)
    beside the split passes'. Returns the launches of the two passes."""
    cfg = load_config("bench100k")
    scene, camera = api.get_scene(cfg, dev)
    with torch.inference_mode():
        accel = build_scene_accel(scene)
        o_t, d_t, _ = generate_rays_tiled(camera, cfg.height, cfg.width, 64)
        words, counts, excess, _ = cull_clusters_sorted2(accel, o_t, d_t, T_FAR)
        check(int(excess) == 0, "primary cull dropped candidates")
        (bt, gid), l_trace = launched(t2.trace_tiles_sorted, o_t, d_t, accel, words, counts)
        s_bt, s_gid, _, _ = t2.trace_tiles_split(o_t, d_t, accel, words, counts)
        sel = select_tiles(counts)
        p_bt, p_gid = t2.closest_hit_plain(*_homog(o_t[sel], d_t[sel]), accel.tri_w,
                                           words[sel], counts[sel])
        check(torch.equal(float_bits(bt), float_bits(s_bt)) and torch.equal(gid, s_gid),
              "trace_tiles_sorted differs from trace_tiles_split")
        check(torch.equal(float_bits(bt[sel]), float_bits(p_bt)) and torch.equal(gid[sel], p_gid),
              "trace_tiles_sorted differs from closest_hit_plain")
        ms = cuda_ms(lambda: t2.trace_tiles_sorted(o_t, d_t, accel, words, counts), 10)
        ms_split = cuda_ms(lambda: t2.trace_tiles_split(o_t, d_t, accel, words, counts), 10)
        log(f"[sorted] trace_tiles_sorted, bench100k {counts.shape[0]} primary tiles "
            f"({count_stats(counts)}): bit-equal to trace_tiles_split and, on {sel.shape[0]} "
            f"tiles, to closest_hit_plain; launches {l_trace}; {ms:.3f} ms a pass against "
            f"trace_tiles_split's {ms_split:.3f}, on {smi}")
        check(l_trace == {"closest": 1}, f"trace_tiles_sorted launched {l_trace}")

        rows_gid, rows, _, _, _ = tiled._trace_rows(accel, o_t, d_t)
        found, p, n = tiled._surface(o_t, d_t, rows_gid, rows, cfg.smooth_shading)
        *_, target = tiled._light_target(p, n, found, scene.lights.position[0])
        so, sd, tmax = tiled._segment_rays(scene.lights.position[0], target)
        words2, counts2, excess2, _ = cull_clusters_sorted2(accel, so, sd, tmax)
        check(int(excess2) == 0, "shadow cull dropped candidates")
        occ, l_occ = launched(t2.any_hit_tiles_sorted, so, sd, tmax, accel, words2, counts2)
        g_occ, _, _ = t2.any_hit_tiles_graded(so, sd, tmax, accel, words2, counts2)
        sel2 = select_tiles(counts2)
        tm = torch.where((sd != 0.0).any(-1), tmax, 0.0)
        p_occ = t2.anyhit_plain(*_homog(so[sel2], sd[sel2]), tm[sel2], accel.tri_w,
                                words2[sel2], counts2[sel2])
        check(torch.equal(occ, g_occ), "any_hit_tiles_sorted differs from any_hit_tiles_graded")
        check(torch.equal(occ[sel2], p_occ), "any_hit_tiles_sorted differs from anyhit_plain")
        ms2 = cuda_ms(lambda: t2.any_hit_tiles_sorted(so, sd, tmax, accel, words2, counts2), 10)
        ms2_g = cuda_ms(lambda: t2.any_hit_tiles_graded(so, sd, tmax, accel, words2, counts2),
                        10)
        log(f"[sorted] any_hit_tiles_sorted, bench100k {counts2.shape[0]} shadow tiles "
            f"({count_stats(counts2)}), {float(occ.float().mean()):.1%} occluded: equal to "
            f"any_hit_tiles_graded and, on {sel2.shape[0]} tiles, to anyhit_plain; launches "
            f"{l_occ}; {ms2:.3f} ms a pass against any_hit_tiles_graded's {ms2_g:.3f}, "
            f"on {smi}")
        check(l_occ == {"anyhit": 1}, f"any_hit_tiles_sorted launched {l_occ}")
    return {"closest": l_trace.get("closest", 0), "anyhit": l_occ.get("anyhit", 0)}


def phase_goldens(dev="cuda") -> dict:
    """(b) the reference's goldens against the port's binding to the fp64
    C++ oracle, at the reference's full sizes, on the card. Returns
    {"bunny512": (scene, camera, tiled frame, oracle frame)} for (c)."""
    check(cpp_oracle.available(), f"the C++ oracle did not build: {cpp_oracle._load()[1]}")
    out = {}
    cfg = load_config("bunny512")
    scene, camera = api.get_scene(cfg, dev)
    wcfg = whitted.WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    (img, aux), l_bunny = launched(api.make_render_fn(scene, cfg, dev), scene, camera,
                                   with_aux=True)
    img = img.cpu().numpy()
    check(aux["overflow"] == 0, f"bunny512 overflow {aux['overflow']}")
    ref = golden_oracle(img, scene, camera, cfg.height, cfg.width, wcfg,
                        f"bunny512 {cfg.width}x{cfg.height}, tiled tier (launches {l_bunny})")
    check(set(l_bunny) <= set(TIERS["tiled"]) and l_bunny.get("closest", 0) > 0
          and l_bunny.get("anyhit", 0) > 0, f"bunny512 launched {l_bunny}")
    out["bunny512"] = (scene, camera, img, ref)

    hall, cam = procedural.columned_hall(cols_x=4, cols_z=3, blob_subdiv=3, device=dev)
    hall_cam = Camera.make(**cam, device=dev)
    wcfg2 = whitted.WhittedConfig(max_bounces=2, smooth_shading=True)
    with torch.inference_mode():
        (img, aux), l_hall = launched(tiled.render_tiled, hall, build_scene_accel(hall), hall_cam,
                                      256, 256, wcfg2, with_aux=True)
    check(aux["overflow"] == 0, f"hall overflow {aux['overflow']}")
    golden_oracle(img.cpu().numpy(), hall, hall_cam, 256, 256, wcfg2,
                  f"hall 4x3 256x256, 2 bounces, render_tiled (launches {l_hall})")

    cfg = load_config("sponza1080")
    scene, camera = api.get_scene(cfg, dev)
    wcfg3 = whitted.WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    y0, hb = cfg.height * 16 // 27, cfg.height * 16 // 135   # rows 640-768 of 1080
    with torch.inference_mode():
        tracers = whole_set_tracers(scene, build_scene_accel(scene))
        rays = generate_rays_band(camera, cfg.height, cfg.width, y0, hb)
        img, l_band = launched(whitted.render_wavefront, scene, rays, wcfg3, *tracers)
    t0 = time.perf_counter()
    ref = cpp_oracle.cpp_render(scene, camera, cfg.height, cfg.width,
                                max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    log(f"[golden] sponza1080: the C++ oracle's {cfg.width}x{cfg.height} frame in "
        f"{time.perf_counter() - t0:.1f} s")
    img = img.cpu().numpy()
    check(np.isfinite(img).all() and img.max() > 0.05, "sponza1080 band not lit")
    golden_gate(img, ref[y0:y0 + hb], f"sponza1080 rows {y0}-{y0 + hb} of {cfg.height}, "
                f"{scene.num_tris} triangles, 3 bounces, 2 lights, render_wavefront over "
                f"trace_tiles_sorted / any_hit_tiles_sorted (launches {l_band})", 0.025)
    check(set(l_band) == {"closest", "anyhit"}, f"the sponza band launched {l_band}")

    cfg = load_config("cornell256")
    scene, camera = api.get_scene(cfg, dev)
    for smooth in (False, True):
        wc = whitted.WhittedConfig(max_bounces=1, smooth_shading=smooth)
        with torch.inference_mode():
            img = whitted.render_image(scene, camera, 256, 256, wc).cpu().numpy()
        golden_oracle(img, scene, camera, 256, 256, wc,
                      f"cornell256 256x256, render_image (brute), smooth_shading {smooth}")

    scene, camera = phong_scene(dev)
    wc = whitted.WhittedConfig(max_bounces=1, smooth_shading=False)
    with torch.inference_mode():
        brute = whitted.render_image(scene, camera, 96, 96, wc).cpu().numpy()
        tiled_img = tiled.render_tiled(scene, build_scene_accel(scene), camera, 96, 96,
                                       wc).cpu().numpy()
    golden_oracle(brute, scene, camera, 96, 96, wc, "Phong scene 96x96, render_image (brute)")
    golden_oracle(tiled_img, scene, camera, 96, 96, wc, "Phong scene 96x96, render_tiled")
    return out


def phong_scene(dev):
    """tests/golden/test_phong.py's scene: a glossy floor and a matte back
    wall, the light on the camera's mirror direction about the floor."""
    from tracer_torch.scene.types import Lights, Materials, Scene

    verts = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2],
                      [-2, 0, -2], [-2, 2, -2], [2, 2, -2], [2, 0, -2]], np.float32)
    tris = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    mats = Materials.make(albedo=[[0.3, 0.3, 0.35], [0.6, 0.55, 0.5]], specular=[0.8, 0.0],
                          shininess=[24.0, 32.0], device=dev)
    lights = Lights.make(position=[[0.0, 0.6, -0.9]], intensity=[[4.0, 4.0, 4.0]], device=dev)
    scene = Scene.make(verts, tris, np.array([0, 0, 1, 1], np.int32), mats, lights, device=dev)
    return scene, Camera.make(position=(0.0, 1.0, 2.8), look_at=(0.0, 0.4, 0.0), fov_y_deg=50.0,
                              device=dev)


def phase_lbvh(smi: str, bunny):
    """(c) bunny512 at 512x512 through render_image over make_lbvh_tracers:
    the frame against (b)'s tiled frame and the oracle's, under the golden
    gate; the build's ms, each traversal's ms (host clock around a
    synchronize), its loop iterations, and the peak device memory."""
    scene, camera, tiled_img, ref = bunny
    h, w = tiled_img.shape[:2]
    wcfg = whitted.WhittedConfig(max_bounces=1, smooth_shading=True)
    stats, times = {"trace": {}, "occlude": {}}, {"trace": [], "occlude": []}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bvh = lbvh.build_lbvh(scene.verts, scene.tris)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3

    def clocked(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    trace = clocked("trace", lambda ray: lbvh.trace_rays_lbvh(ray, bvh, scene.verts, scene.tris,
                                                              stats=stats["trace"]))
    occlude = clocked("occlude", lambda ray, t_max: lbvh.any_hit_lbvh(
        ray, t_max, bvh, scene.verts, scene.tris, stats=stats["occlude"]))
    with torch.inference_mode():
        img, l_lbvh = launched(whitted.render_image, scene, camera, h, w, wcfg, trace, occlude)
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = img.cpu().numpy()
    log(f"[lbvh] bunny512 {w}x{h} ({scene.num_tris} triangles), render_image over the LBVH on "
        f"{smi}: build {build_ms:.1f} ms; "
        + "; ".join(f"{k} pass {times[k][0]:.1f} ms, {stats[k]['iterations']} loop iterations run "
                    f"({stats[k]['needed']} with an active lane)" for k in times)
        + f"; peak device memory {peak:.2f} GiB, launches {l_lbvh}")
    check(not l_lbvh, f"the LBVH frame launched {l_lbvh}")
    golden_gate(img, tiled_img, "bunny512 LBVH vs the tiled tier")
    golden_gate(img, ref, "bunny512 LBVH vs the C++ oracle")


def phase_obj(tmp: str, dev="cuda"):
    """(d) bunny512's geometry through save_obj, then obj:<path> through
    get_scene and make_render_fn on the card against the oracle on the same
    loaded scene; load_obj's native and Python parsers field for field;
    bin/trace_torch on the obj: scene."""
    cfg = load_config("bunny512")
    src, _ = api.get_scene(cfg, dev)
    path = os.path.join(tmp, "bunny512.obj")
    save_obj(path, src.verts, src.tris)
    t0 = time.perf_counter()
    check(cpp_loader.available(), f"the native OBJ parser did not build: {cpp_loader._load()[1]}")
    log(f"[obj] the native parser built and loaded in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    native = load_obj(path, native=True, device=dev)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = load_obj(path, native=False, device=dev)
    t_python = time.perf_counter() - t0
    for name, a, b in (("verts", native.verts, python.verts), ("tris", native.tris, python.tris),
                       ("mat_id", native.mat_id, python.mat_id),
                       ("normals", native.normals, python.normals),
                       ("albedo", native.materials.albedo, python.materials.albedo),
                       ("lights", native.lights.position, python.lights.position)):
        check(torch.equal(a, b), f"load_obj: native and Python parsers differ in {name}")
    cfg = cfg.replace(scene=f"obj:{path}")
    scene, camera = api.get_scene(cfg, dev)
    wcfg = whitted.WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    (img, aux), l_obj = launched(api.make_render_fn(scene, cfg, dev), scene, camera,
                                 with_aux=True)
    check(aux["overflow"] == 0, f"obj frame overflow {aux['overflow']}")
    golden_oracle(img.cpu().numpy(), scene, camera, cfg.height, cfg.width, wcfg,
                  f"obj:{os.path.basename(path)} ({scene.num_tris} triangles) "
                  f"{cfg.width}x{cfg.height}, tiled "
                  f"tier (launches {l_obj}); parsed natively in {t_native:.2f} s, in Python in "
                  f"{t_python:.2f} s, the same scene")
    png = os.path.join(tmp, "obj.png")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bin", "trace_torch"), "--preset",
                           "bunny512", "--scene", f"obj:{path}", "-o", png],
                          capture_output=True, text=True, timeout=300)
    log(f"[obj] bin/trace_torch --scene obj:{os.path.basename(path)} (exit "
        f"{proc.returncode}):\n" + proc.stdout.strip())
    check(proc.returncode == 0, f"bin/trace_torch obj: failed:\n{proc.stderr[-4000:]}")
    check(read_png(png).shape == (cfg.height, cfg.width, 3),
          "bin/trace_torch's obj: PNG has the wrong shape")


def phase_bench_cli(frame: dict):
    """(e) bin/bench_torch --preset bench100k --iters 3 --no-grad as a
    subprocess: exit 0, its line's overflow 0, and its ms_per_frame within
    half to twice phase 6's (the frame is host-bound and wanders)."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bin", "bench_torch"), "--preset",
                           "bench100k", "--iters", "3", "--no-grad"], capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"bin/bench_torch failed:\n{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    ms, ref = line["detail"]["ms_per_frame"], frame["ms_per_frame"]
    log(f"[bench] bin/bench_torch --preset bench100k --iters 3 --no-grad: {json.dumps(line)}")
    log(f"[bench] ms_per_frame {ms:.3f} against phase 6's {ref:.3f}")
    check(line["detail"]["overflow"] == 0, "bin/bench_torch: overflow")
    check(ref / 2 <= ms <= ref * 2, f"bin/bench_torch's frame {ms} ms, phase 6's {ref} ms")


def phase_guard_profile(tmp: str, dev="cuda"):
    """(f) checked(render_image): a clean cornell frame passes on the card,
    NaN vertices raise CheckError; benchmark("cornell256", profile=True)
    writes trace.json under TRACER_PROFILE_DIR; generate_rays with a seeded
    jitter on the card against the CPU to 2^-22."""
    scene, camera = api.get_scene(load_config("cornell256"), dev)
    wc = whitted.WhittedConfig(max_bounces=1)
    run = checked(lambda s, c: whitted.render_image(s, c, 64, 64, wc))
    img = run(scene, camera)
    check(bool(torch.isfinite(img).all()) and img.device.type == dev, "checked: bad frame")
    verts = scene.verts.clone()
    verts[0, 0] = float("nan")
    try:
        run(dataclasses.replace(scene, verts=verts), camera)
        raised = None
    except CheckError as e:
        raised = str(e)
    log(f"[guard] checked(render_image) on the card: a clean 64x64 cornell frame passes; NaN "
        f"vertices raise CheckError: {raised}")
    check(raised is not None, "checked did not raise on NaN vertices")

    prof_dir = os.path.join(tmp, "profile")
    before = os.environ.get("TRACER_PROFILE_DIR")
    os.environ["TRACER_PROFILE_DIR"] = prof_dir
    try:
        res = api.benchmark("cornell256", iters=2, warmup=1, device=dev, profile=True)
    finally:
        if before is None:
            del os.environ["TRACER_PROFILE_DIR"]
        else:
            os.environ["TRACER_PROFILE_DIR"] = before
    trace = os.path.join(prof_dir, "trace.json")
    check(os.path.exists(trace) and res["overflow"] == 0, "benchmark(profile=True) wrote no trace")
    log(f"[guard] benchmark('cornell256', profile=True): {res['ms_per_frame']:.3f} ms/frame "
        f"profiled, trace.json {os.path.getsize(trace)} bytes")

    jit = np.random.default_rng(0).uniform(0.0, 1.0, (64, 96, 2)).astype(np.float32)
    rays = {}
    for d in (dev, "cpu"):
        _, cam = api.get_scene(load_config("cornell256"), d)
        rays[d] = generate_rays(cam, 64, 96, jitter=torch.as_tensor(jit, device=d)).d.cpu()
    err = float((rays[dev] - rays["cpu"]).abs().max())
    log(f"[guard] jittered rays, card vs CPU: largest difference {err:.3g} (gate 2^-22)")
    check(err <= 2.0 ** -22, "jittered rays differ between the card and the CPU")


def phase_19(smi: str, frame: dict) -> dict:
    """Phase 19: the rest of the one-card surface (see the module
    docstring). Returns the launches of (a)'s passes."""
    launches = timed("19 (a) sorted wrappers", phase_sorted, smi)
    bunny = timed("19 (b) goldens", phase_goldens)
    timed("19 (c) lbvh", phase_lbvh, smi, bunny["bunny512"])
    del bunny
    with tempfile.TemporaryDirectory() as tmp:
        timed("19 (d) obj", phase_obj, tmp)
        timed("19 (e) bench_torch", phase_bench_cli, frame)
        timed("19 (f) guard, profile, jitter", phase_guard_profile, tmp)
    timed("19 (g) cornell256 stages", phase_cornell_stages)
    return launches


# ---------------------------------------------------------------------------
# Phase 20: the distributed paths (tracer_torch.dist) in a world of one rank
# ---------------------------------------------------------------------------

GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-6  # the grad gate of phase 17


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_tier(what: str, launches: dict, tier: str | None, need=None):
    """Every kernel of `tier` launched, or those of `need` where the data
    decides whether the others run (none for tier None), and no kernel
    outside the tier."""
    allowed = TIERS[tier] if tier else ()
    want = allowed if need is None else need
    missing = [k for k in want if not launches.get(k)]
    stray = [k for k in launches if k not in allowed]
    check(not missing and not stray, f"{what} never launched {missing}, and launched {stray}")


def host_ms(dev, fn, reps: int) -> float:
    """Mean host-clock ms of fn over reps calls after one, a sync at each end."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def dist_tile_dp(mesh, smi, preset, tier, dev="cuda", reps: int = 5, **overrides):
    """(a), (b): make_sharded_accel_render_fn at data = 1 over build_tracers:
    bit-equal to render_wavefront over build_tracers of the same scene,
    launching exactly the kernels of `tier`; its ms a frame (host clock)."""
    from tracer_torch.dist.ray_dp import make_sharded_accel_render_fn

    cfg = load_config(preset, **overrides)
    scene, camera = api.get_scene(cfg, dev)
    run = make_sharded_accel_render_fn(scene, cfg, mesh)
    img, l_run = launched(run, scene, camera)
    wcfg = whitted.WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    with torch.inference_mode():
        ref = whitted.render_wavefront(scene, generate_rays(camera, cfg.height, cfg.width), wcfg,
                                       *api.build_tracers(scene, cfg))
    ms = host_ms(dev, lambda: run(scene, camera), reps)
    log(f"[dist] (tile DP) {preset} {cfg.width}x{cfg.height}, {cfg.max_bounces} bounce(s), "
        f"data = 1: bit-equal to render_wavefront over build_tracers: {torch.equal(img, ref)}; "
        f"launches {l_run}; {ms:.3f} ms a frame ({reps} after 1, accel built each frame), on "
        f"{smi}")
    check(torch.equal(img, ref), f"tile DP {preset}: not bit-equal to render_wavefront")
    check(img.mean() > 0.01, f"tile DP {preset}: frame not lit")
    check_tier(f"tile DP {preset}", l_run, tier)
    return img, ms, l_run


class CountingAllToAll:
    """torch.distributed.all_to_all_single, counted, while installed."""

    def __init__(self):
        self.calls = 0
        self.inner = torch.distributed.all_to_all_single

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)

    def __enter__(self):
        torch.distributed.all_to_all_single = self
        return self

    def __exit__(self, *exc):
        torch.distributed.all_to_all_single = self.inner


def dist_reshard(mesh, smi, dev="cuda", preset="sponza1080"):
    """(c): reshard_bounces=True against the same frame without the re-shard,
    under the golden gate; one exchange each way a bounce after the first."""
    from tracer_torch.dist.ray_dp import make_sharded_accel_render_fn

    cfg = load_config(preset)
    scene, camera = api.get_scene(cfg, dev)
    plain = make_sharded_accel_render_fn(scene, cfg, mesh)
    resh = make_sharded_accel_render_fn(scene, cfg, mesh, reshard_bounces=True)
    img_p = plain(scene, camera)
    with CountingAllToAll() as a2a:
        img_r, l_run = launched(resh, scene, camera)
    ms_p = host_ms(dev, lambda: plain(scene, camera), 2)
    ms_r = host_ms(dev, lambda: resh(scene, camera), 2)
    log(f"[dist] (re-shard) {preset} {cfg.width}x{cfg.height}, {cfg.max_bounces} bounces: "
        f"all_to_all_single {a2a.calls} calls, bit-equal to the plain frame "
        f"{torch.equal(img_r, img_p)}, launches {l_run}; {ms_r:.3f} ms a frame against "
        f"{ms_p:.3f} without the re-shard, on {smi}")
    check(a2a.calls == 2 * (cfg.max_bounces - 1),
          f"re-shard: {a2a.calls} exchanges for {cfg.max_bounces} bounces")
    # The sorted tracers. closest_fast runs only on tiles of at most FAST_BATCH
    # candidates (trace_tiles_split), so the frame's data decides whether it runs.
    check_tier(f"re-shard {preset}", l_run, "sorted", need=("closest", "anyhit"))
    golden_gate(img_r.cpu().numpy(), img_p.cpu().numpy(), f"{preset} re-sharded vs plain")
    return l_run


def dist_ring(mesh, smi, ref_img, dev="cuda", preset="bench100k"):
    """(d): make_ring_render_fn over the accel (k_cap None, with_aux), ring
    and reduce: overflow 0, kernels 6-7 launched and no other, the image
    under the golden gate of (a)'s; the shard accel's build and peak memory."""
    from tracer_torch.dist import ring

    cfg = load_config(preset, max_bounces=1)
    scene, camera = api.get_scene(cfg, dev)
    with torch.inference_mode():
        rows = ring.pack_tri_rows(scene)
        build_ms = host_ms(dev, lambda: ring.build_rows_accel(rows), 3)
        accel = ring.build_rows_accel(rows)
    log(f"[dist] (ring) {preset}: shard accel of {rows.shape[0]} rows, {accel.num_clusters} "
        f"clusters: built in {build_ms:.3f} ms (host clock, mean of 3), on {smi}")
    out = {}
    for use_ring in (True, False):
        what = f"{'ring' if use_ring else 'reduce'} accel {preset}"
        run = ring.make_ring_render_fn(scene, cfg, mesh, use_ring=use_ring, use_accel=True,
                                       with_aux=True, k_cap=None)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        (img, aux), l_run = launched(run, scene, camera)
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else 0.0
        ms = host_ms(dev, lambda: run(scene, camera), 2)
        log(f"[dist] ({what}) {cfg.width}x{cfg.height}: overflow {aux['overflow']}, launches "
            f"{l_run}, peak device memory {peak:.2f} GiB, {ms:.3f} ms a frame, on {smi}")
        check(aux["overflow"] == 0, f"{what}: overflow {aux['overflow']}")
        check_tier(what, l_run, "worklist")
        golden_gate(img.cpu().numpy(), ref_img.cpu().numpy(), f"{what} vs tile DP")
        out[use_ring] = l_run
    return out[True]


def dist_brute_ring(mesh, smi, dev="cuda", preset="cornell256"):
    """(e): the brute ring and reduce against make_render_fn's frame, no
    kernel launched."""
    from tracer_torch.dist import ring

    cfg = load_config(preset)
    scene, camera = api.get_scene(cfg, dev)
    ref = api.make_render_fn(scene, cfg, dev)(scene, camera).cpu().numpy()
    for use_ring in (True, False):
        what = f"{'ring' if use_ring else 'reduce'} brute {preset}"
        run = ring.make_ring_render_fn(scene, cfg, mesh, use_ring=use_ring, use_accel=False)
        img, l_run = launched(run, scene, camera)
        ms = host_ms(dev, lambda: run(scene, camera), 3)
        log(f"[dist] ({what}) {cfg.width}x{cfg.height}: {ms:.3f} ms a frame, launches {l_run}, "
            f"on {smi}")
        check_tier(what, l_run, None)
        golden_gate(img.cpu().numpy(), ref, f"{what} vs make_render_fn")


GRAD_CASES = (("sharded", "cornell256"), ("overlapped", "cornell256"),
              ("overlapped accel", "bunny-grad"))


def dist_grads(mesh, dev):
    """Each of GRAD_CASES on `dev`: make_sharded_grad_fn, or
    make_overlapped_grad_fn with 4 buckets (over build_tracers of the
    config for "accel"), from fit_scene's off-centre camera against a zeros
    target -> {case: (loss, grads, host ms)}."""
    from functools import partial

    from tracer_torch.dist.grad_overlap import make_overlapped_grad_fn
    from tracer_torch.dist.ray_dp import make_sharded_grad_fn

    out = {}
    for kind, preset in GRAD_CASES:
        cfg = load_config(preset)
        scene, camera = fit_scene(cfg, dev, off_center=True)
        target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
        if kind == "sharded":
            fn = make_sharded_grad_fn(scene, cfg, mesh)
        else:
            builder = partial(api.build_tracers, cfg=cfg) if "accel" in kind else None
            fn = make_overlapped_grad_fn(cfg, mesh, n_buckets=4, tracer_builder=builder)
        sync(dev)
        t0 = time.perf_counter()
        loss, grads = fn(scene, camera, target)
        sync(dev)
        out[kind] = (float(loss), grads.cpu().numpy(), (time.perf_counter() - t0) * 1e3)
    return out


def dist_grads_world(rank):
    """The CPU side of (f), in a world of one gloo rank."""
    from tracer_torch.dist.mesh import make_render_mesh

    return dist_grads(make_render_mesh(data=1, device="cpu"), "cpu")


def dist_grad_gate(card: dict, cpu: dict, smi: str):
    """(f): each case on the card against the CPU: loss to rtol 1e-5, the
    vertex gradient nonzero and to rtol 2e-3 + atol 2e-6 of its largest."""
    for (kind, preset) in GRAD_CASES:
        (lc, gc, ms), (lh, gh, ms_cpu) = card[kind], cpu[kind]
        scale = float(np.abs(gh).max())
        excess = np.abs(gc - gh) - (GRAD_ATOL * scale + GRAD_RTOL * np.abs(gh))
        rel = abs(lc - lh) / abs(lh)
        log(f"[dist] (grad) {kind} {preset}: loss {lc:.8g} card, {lh:.8g} CPU (relative "
            f"{rel:.3g}, gate 1e-5); gradient largest {scale:.4g}, worst excess over the gate "
            f"{excess.max():.3g}; {ms:.1f} ms on the card (first call), {ms_cpu:.1f} on the "
            f"CPU, on {smi}")
        check(rel <= 1e-5, f"{kind} grad: card and CPU losses differ by {rel:.3g}")
        check(scale > 0 and excess.max() <= 0, f"{kind} grad: gradients outside the grad gate")


def dist_scaling(smi, frame_ms: float):
    """(g): scaling_sweep on bench100k (one card: one row), then
    bin/bench_torch --scaling: the measured row and two pending ones."""
    from tracer_torch.dist.scaling import scaling_sweep

    rows = scaling_sweep(load_config("bench100k"), iters=3)
    log(f"[dist] (scaling) scaling_sweep bench100k: {json.dumps(rows)} (phase 6: "
        f"{frame_ms:.3f} ms/frame), on {smi}")
    check(len(rows) == 1 and rows[0]["devices"] == 1 and rows[0]["efficiency"] == 1.0,
          f"scaling_sweep rows {rows}")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bin", "bench_torch"), "--scaling",
                           "--preset", "bench100k", "--iters", "3"], capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"bin/bench_torch --scaling failed:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        log(f"[dist] (scaling) {line}")
    check(len(lines) == 5 and lines[2].startswith("| 1 card (") and "measured" in lines[2]
          and all("pending" in line for line in lines[3:]),
          "bin/bench_torch --scaling: not the one-card table")


def phase_20(smi: str, frame: dict, dev="cuda") -> dict:
    """Phase 20: the distributed paths in a world of one rank (NCCL on the
    card), see the module docstring. Returns each kernel's launches over the
    dist paths (a), (b) and (d)'s ring frame."""
    from concurrent.futures import ThreadPoolExecutor
    from datetime import timedelta

    import torch.distributed as dist

    from tracer_torch.dist.mesh import (backend_for, make_render_mesh, spawn_world,
                                        stop_fork_server)
    from tracer_torch.dist.ray_dp import dryrun

    launches = {}

    def add(l_run):
        for k, v in l_run.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        # The CPU side of (f) runs in its own world while the card works.
        cpu_grads = pool.submit(spawn_world, dist_grads_world, 1, device="cpu")
        dist.init_process_group(backend_for(dev), init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, timeout=timedelta(seconds=60),
                                device_id=torch.device(dev, 0) if dev == "cuda" else None)
        try:
            mesh = make_render_mesh(data=1, geom=1, device=dev)
            img, ms, l_run = timed("20 (a) tile DP bench100k", dist_tile_dp, mesh, smi,
                                   "bench100k", "sorted", dev)
            log(f"[dist] (tile DP) bench100k {ms:.3f} ms a frame against phase 6's "
                f"{frame['ms_per_frame']:.3f} (make_render_fn's tiled tier)")
            add(l_run)
            add(timed("20 (b) tile DP pod-1m", dist_tile_dp, mesh, smi, "pod-1m", "streamed",
                      dev, reps=2, max_bounces=1)[2])
            timed("20 (c) re-shard", dist_reshard, mesh, smi, dev)
            add(timed("20 (d) ring accel", dist_ring, mesh, smi, img, dev))
            del img
            timed("20 (e) brute ring", dist_brute_ring, mesh, smi, dev)
            card = timed("20 (f) grads, card", dist_grads, mesh, dev)
            dist_grad_gate(card, cpu_grads.result(timeout=600)[0], smi)
            if dev == "cuda":
                timed("20 (g) scaling", dist_scaling, smi, frame["ms_per_frame"])
            timed("20 (h) dryrun", dryrun, dev)
        finally:
            dist.destroy_process_group()
    stop_fork_server()
    return launches


def timed(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), then its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def run_phases() -> tuple[str, str, list]:
    """Phases 1-20 -> (the card's name, its nvidia-smi line, the kernels)."""
    t0 = time.perf_counter()
    name, smi = timed("device", phase_device)
    timed("build", phase_build)
    results, launches = {}, {}
    bench = load_config("bench100k")
    timed("kernels", phase_kernels, results, bench, torch.device("cuda"))
    launches.update(timed("frame", phase_frame, bench, "cuda", "tiled"))
    timed("cross-device", phase_cross_device, load_config("bench100k", height=216, width=384))
    frame = timed("timing", phase_timing, smi, "bench100k", iters=10, warmup=2)
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
    timed("grad", phase_grad, smi, frame)
    timed("fit", phase_fit, smi)
    t19 = time.perf_counter()
    phase_19(smi, frame)
    log(f"[phase] 19: {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    dist_launches = phase_20(smi, frame)
    log(f"[phase] 20: {time.perf_counter() - t20:.1f} s")
    log(f"[phase] all: {time.perf_counter() - t0:.1f} s")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "dist_launches": dist_launches.get(k, 0),
                **results[k]} for k, (src, rep) in KERNELS.items()]
    return name, smi, kernels


def main() -> int:
    become_subreaper()
    try:
        name, smi, kernels = run_phases()
    finally:
        stray = stop_children()
    check(not stray, f"processes still running at the end of the run (killed): {stray}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
