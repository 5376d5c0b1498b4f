"""Streamed traversal: closest-hit and any-hit for scenes whose accel does
not fit in L2 (torch counterpart of tracer/kernels/stream.py).

The same per-tile sorted front-to-back candidate walk as kernels/traversal2,
at STREAM_BATCH = 2 candidate clusters a step, with the cluster blocks
streamed from device memory through an NBUF-deep ring of asynchronous
copies in shared memory (csrc/stream.cu). The any-hit kernel works, as
traversal2's does, on segments of a tile's run (_launch.run_segments),
and its ring runs on across the segments a block walks. Each kernel has:
  * a plain version, closest_stream_plain / anyhit_stream_plain: the plain
    versions of kernels/traversal2.py at batch=STREAM_BATCH;
  * a wrapper, closest_stream / anyhit_stream: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors, or it raises;
  * a launch counter, traversal2.LAUNCHES["closest_stream" / "anyhit_stream"].

The reference's k_cap / s_cap / k_occ caps have no counterpart: the cull
(bvh/cull.py) runs at the exact run-time sizes, so every pass has excess 0
by construction; the excess is still computed and reported.
"""
from __future__ import annotations

import functools

import torch

from tracer_torch.bvh.cull import cull_clusters_sorted2
from tracer_torch.core.types import T_FAR, Hit, Ray
from tracer_torch.kernels.traversal import _homog, tile_rays, tiled_tmax, untile
from tracer_torch.kernels.traversal2 import (
    _check_cuda, _closest_out, _launch, _launch_anyhit, anyhit_plain, closest_hit_plain,
    recover_hit)

# Ring stages of cluster blocks in flight per tile (kNBuf of csrc/stream.cu).
NBUF = 4
# Candidate clusters per step (kBatch of csrc/stream.cu, which builds the
# kernels for this B only).
STREAM_BATCH = 2

closest_stream_plain = functools.partial(closest_hit_plain, batch=STREAM_BATCH)
anyhit_stream_plain = functools.partial(anyhit_plain, batch=STREAM_BATCH)


def _check_stream(w):
    """What the stream kernels take beyond _check_cuda: 16-byte loads of 4
    triangles' coefficients need C % 4 == 0 and an aligned matrix."""
    c = w.shape[2] // 3
    if c % 4 or w.data_ptr() % 16:
        raise ValueError(f"the stream kernels take C % 4 == 0 and a 16-byte aligned w, "
                         f"got C = {c}, address {w.data_ptr():#x}")


def closest_stream(o4, d4, w, words, counts):
    """closest_stream_plain on CPU tensors; the CUDA kernel
    closest_stream_kernel on CUDA tensors."""
    if o4.device.type == "cpu":
        return closest_stream_plain(o4, d4, w, words, counts)
    _check_cuda(o4, d4, w, words, counts)
    _check_stream(w)
    bt, bid = _closest_out(o4)
    if o4.shape[0]:
        _launch("closest_stream", "st_closest", o4.device, words, counts, o4.shape[0],
                words.shape[1], o4.shape[1], o4, d4, w, w.shape[0], w.shape[2] // 3, bt, bid)
    return bt, bid


def anyhit_stream(o4, d4, tmax, w, words, counts):
    """anyhit_stream_plain on CPU tensors; the CUDA kernel
    anyhit_stream_kernel on CUDA tensors."""
    if o4.device.type == "cpu":
        return anyhit_stream_plain(o4, d4, tmax, w, words, counts)
    _check_cuda(o4, d4, w, words, counts, (tmax, torch.float32))
    _check_stream(w)
    return _launch_anyhit("anyhit_stream", "st_anyhit", o4, d4, tmax, w, words, counts)


def trace_tiles_streamed(o_t, d_t, accel, words, counts):
    """Closest hit over every tile in its own order (a tile with count 0
    gives T_FAR / -1) -> (bt (Nt, TR), gid (Nt, TR) slot cl*C + lane or -1)."""
    o4, d4 = _homog(o_t, d_t)
    return closest_stream(o4, d4, accel.tri_w, words.contiguous(), counts.contiguous())


def any_hit_tiles_streamed(o_t, d_t, t_max_t, accel, words, counts):
    """Occlusion over every tile in its own order -> (Nt, TR) bool. Padding
    and dead rays (d == 0) get t_max = 0 so they cannot raise a tile's
    early-out bound (they never hit: den == 0); the kernel's segment table
    puts the heaviest tiles first."""
    valid = (d_t != 0.0).any(-1)
    tmax = torch.where(valid, t_max_t, 0.0)
    o4, d4 = _homog(o_t, d_t)
    return anyhit_stream(o4, d4, tmax, accel.tri_w, words.contiguous(), counts.contiguous())


def make_streamed_tracers_aux(scene, accel, tr: int = 64):
    """(trace_fn, occlude_fn) over the streamed kernels, each also returning
    its cull's aux {"excess", "need_k", "need_s"}:
      trace_fn(ray) -> (Hit, aux);  occlude_fn(ray, t_max) -> (occ, aux)."""

    def trace_fn(ray: Ray):
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        words, counts, excess, need = cull_clusters_sorted2(accel, o_t, d_t, T_FAR)
        bt, gid = trace_tiles_streamed(o_t, d_t, accel, words, counts)
        hit = recover_hit(scene, ray, untile(bt, tiling), untile(gid, tiling), accel)
        return hit, {"excess": excess, "need_k": need[0], "need_s": need[1]}

    def occlude_fn(ray: Ray, t_max):
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        t_max_t = tiled_tmax(t_max, ray, o_t, tr)
        words, counts, excess, need = cull_clusters_sorted2(accel, o_t, d_t, t_max_t)
        occ = any_hit_tiles_streamed(o_t, d_t, t_max_t, accel, words, counts)
        return untile(occ, tiling), {"excess": excess, "need_k": need[0], "need_s": need[1]}

    return trace_fn, occlude_fn


def make_streamed_tracers(scene, accel, tr: int = 64):
    """(trace_fn, occlude_fn) over the streamed kernels, without the aux:
    trace_fn(ray) -> Hit;  occlude_fn(ray, t_max) -> occ."""
    trace_aux, occlude_aux = make_streamed_tracers_aux(scene, accel, tr)

    def trace_fn(ray: Ray) -> Hit:
        return trace_aux(ray)[0]

    def occlude_fn(ray: Ray, t_max) -> torch.Tensor:
        return occlude_aux(ray, t_max)[0]

    return trace_fn, occlude_fn
