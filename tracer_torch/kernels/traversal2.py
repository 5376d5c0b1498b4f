"""Sorted front-to-back traversal: closest-hit and any-hit over per-tile
candidate clusters (torch counterpart of tracer/kernels/traversal2.py).

Each of the three kernels of the pass has three pieces here:
  * a plain PyTorch version (closest_hit_plain, closest_fast_plain,
    anyhit_plain) that computes the same function, vectorized over tiles in
    chunks and exhaustive over each tile's candidate words in batches of
    the same B (the kernels' early-out cannot change a result: a skipped
    cluster cannot give a strictly smaller t, nor any t below an unoccluded
    ray's t_max);
  * a wrapper (closest_hit, closest_fast, anyhit) that runs the plain
    version for CPU tensors and launches the CUDA kernel of
    csrc/traversal2.cu for CUDA tensors, or raises. The generic closest-hit
    kernel and the any-hit kernel do not walk a tile in one block: their
    unit of work is a segment of a tile's candidate run
    (_launch.run_segments). Occlusion is
    an OR over the candidates, in any order; closest hits merge through a
    64-bit key a ray (pack_closest_key) under an atomic minimum, exact
    because the walk's tie rule is the lexicographic minimum of (t, step,
    slot), and a finishing pass (closest_finish_plain is its plain version)
    turns the keys into (bt, bid);
  * a launch counter, LAUNCHES[name] (kernels/_launch.py), raised by one per
    kernel launch.

trace_tiles_split sorts tiles by candidate count and sets the partition
points at run time from the counts (P = tiles with count > 1, Z = tiles
with count > 0), so every tile lands in a region that is exact for it;
any_hit_tiles_graded hands every tile to the one any-hit launch, whose
segment table does the sorting. The reference's static partitions could
leave an excess; here it is 0 by construction. trace_tiles_sorted and
any_hit_tiles_sorted make one pass of the generic closest-hit and the
any-hit kernel over the whole tile set, unsorted. recover_hit maps a
selected slot back to a full Hit.
"""
from __future__ import annotations

import torch

from tracer_torch.bvh.cull import CLUSTER_BITS, cull_clusters_sorted2
from tracer_torch.core.intersect import moller_trumbore
from tracer_torch.core.types import T_FAR, Hit, Ray
from tracer_torch.kernels._launch import (  # noqa: F401 (LAUNCHES is read through this module)
    LAUNCHES, check_dense, check_rays, launch as _launch, run_segments, sm_count)
from tracer_torch.kernels.traversal import (
    _homog, KEY_MISS, T_MIN, tile_rays, tiled_tmax, untile)

_CL_MASK = (1 << CLUSTER_BITS) - 1
_INT_MAX = 2147483647

# Candidate clusters per step of the generic closest-hit and any-hit loops
# (shared-memory stage of B * 6 KB at C = 128; kBatch of csrc/traversal2.cu,
# which builds the kernels for this B only), and of the fast tier.
BATCH = 4
FAST_BATCH = 1

# The segmented kernels' (closest_hit_kernel, anyhit_kernel,
# anyhit_stream_kernel) unit of work is a segment, SEG consecutive candidate
# words of one tile, a whole number of steps of B words, and several threads
# serve one ray of it, each with its share of a cluster's triangles (kSeg,
# kSlices of csrc/common.cuh). The any-hit kernels take SLICES threads a ray,
# a block of 256 for a tile of 64 rays, in a grid of BLOCKS_PER_SM persistent
# blocks for every SM of the card, 32 of the 64 warps an SM holds (of
# anyhit_stream_kernel, at 80 registers a thread, three blocks fit at a time;
# its fourth starts when the counter has run out and ends at once).
# closest_hit_kernel takes SLICES_CLOSEST threads a ray (kSlicesClosest of
# csrc/traversal2.cu), a block of 128, in a grid of BLOCKS_PER_SM_CLOSEST blocks
# an SM, of which 4 fit at a time.
SEG = 8
SLICES = 4
BLOCKS_PER_SM = 4
SLICES_CLOSEST = 2
BLOCKS_PER_SM_CLOSEST = 8
# Rays a block of the segmented kernels holds state for in shared memory
# (kMaxRays of csrc/common.cuh).
MAX_RAYS = 1024 // SLICES
# closest_fast_kernel serves a ray with SLICES_FAST threads, each with every
# SLICES_FAST-th quad of 4 lanes of the tile's one cluster, and puts
# FAST_THREADS // (SLICES_FAST * TR) tiles (at least one) in a block
# (kSlicesFast, kFastThreads of csrc/traversal2.cu).
SLICES_FAST = 2
FAST_THREADS = 256

# Bytes of (tiles, B, TR, 3C) temporaries a plain version holds at once.
_PLAIN_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _cluster_t(o4, d4, w, t_max):
    """Rays (..., TR, 4) x clusters (..., 4, 3C) -> tv (..., TR, C): t, or
    T_FAR where the pair misses. Products in the reference's order
    (_products): so = ((w3 + o0*w0) + o1*w1) + o2*w2, sd = (d0*w0 + d1*w1)
    + d2*w2, each step a separate rounding, as the kernels compute it."""
    c = w.shape[-1] // 3
    wr = [w[..., r:r + 1, :] for r in range(4)]
    oc = [o4[..., i:i + 1] for i in range(3)]
    dc = [d4[..., i:i + 1] for i in range(3)]
    so = ((wr[3] + oc[0] * wr[0]) + oc[1] * wr[1]) + oc[2] * wr[2]
    sd = (dc[0] * wr[0] + dc[1] * wr[1]) + dc[2] * wr[2]
    den = sd[..., :c]
    t = -so[..., :c] / den
    u = so[..., c:2 * c] + t * sd[..., c:2 * c]
    v = so[..., 2 * c:] + t * sd[..., 2 * c:]
    ok = ((torch.minimum(torch.minimum(u, v), 1.0 - u - v) >= 0.0)
          & (t > T_MIN) & (t < t_max) & (den.abs() > 1e-12))
    return torch.where(ok, t, T_FAR)


def _batch_best(tv, cl, c: int, bt_prev, bid_prev):
    """Fold one batch: tv (Nt, B, TR, C) in candidate order, cl (Nt, B)
    cluster ids. Per lane the earliest candidate wins; across lanes the
    smallest t, on equal t the smaller slot cl*C + lane; the running best
    is replaced only on a strict <."""
    m = tv.amin(1)                                   # (Nt, TR, C)
    j_first = (tv == m[:, None]).to(torch.uint8).argmax(1)
    lane = torch.arange(c, dtype=torch.int32, device=tv.device)
    bid_lane = torch.gather(cl, 1, j_first.flatten(1)).view_as(j_first) * c + lane
    tmin = m.amin(-1)                                # (Nt, TR)
    bid_new = torch.where(m == tmin[..., None], bid_lane, _INT_MAX).amin(-1)
    better = tmin < bt_prev
    return torch.where(better, tmin, bt_prev), torch.where(better, bid_new, bid_prev)


def _chunks(n_tiles: int, batch: int, tr: int, c: int):
    per_tile = 16 * batch * tr * 3 * c * 4
    step = max(1, _PLAIN_BYTES // per_tile)
    return [(a, min(a + step, n_tiles)) for a in range(0, n_tiles, step)]


def _live_tiles(counts, a: int, b: int, k: int):
    """Indices of the tiles in [a, b) with a candidate left at word k; the
    others' batch would be all T_FAR, which changes no result."""
    return a + torch.nonzero(counts[a:b] > k)[:, 0]


def _candidates(words, counts, k: int, batch: int, n_cl: int):
    """Words k .. k+batch-1 of each tile (clamped reads replay the last
    word) -> (cluster ids (Nt, B), live (Nt, B))."""
    j = k + torch.arange(batch, device=words.device)
    word = words[:, torch.clamp_max(j, words.shape[1] - 1)]
    cl = torch.clamp_max(word & _CL_MASK, n_cl - 1)
    return cl, j[None] < counts[:, None]


def closest_hit_plain(o4, d4, w, words, counts, batch: int = BATCH):
    """Closest hit: o4, d4 (Nt, TR, 4) f32, w (Ncl, 4, 3C) f32, words
    (Nt, K) i32 sorted, counts (Nt,) i32 -> (bt (Nt, TR) f32 best t or
    T_FAR, bid (Nt, TR) i32 slot cl*C + lane or -1)."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[-1] // 3
    bt = torch.full((n_tiles, tr), T_FAR, dtype=torch.float32, device=o4.device)
    bid = torch.full((n_tiles, tr), -1, dtype=torch.int32, device=o4.device)
    for a, b in _chunks(n_tiles, batch, tr, c):
        for k in range(0, int(counts[a:b].max()), batch):
            t = _live_tiles(counts, a, b, k)
            cl, live = _candidates(words[t], counts[t], k, batch, n_cl)
            tv = _cluster_t(o4[t, None], d4[t, None], w[cl.long()], T_FAR)
            tv = torch.where(live[..., None, None], tv, T_FAR)
            bt[t], bid[t] = _batch_best(tv, cl, c, bt[t], bid[t])
    return bt, bid


def closest_fast_plain(o4, d4, w, words, counts):
    """closest_hit_plain for tiles with count <= 1: one step over the first
    word only, live iff count > 0 (a heavier tile gets its first candidate
    only)."""
    return closest_hit_plain(o4, d4, w, words[:, :1], torch.clamp_max(counts, 1), batch=1)


def anyhit_plain(o4, d4, tmax, w, words, counts, batch: int = BATCH):
    """Occlusion: as closest_hit_plain plus tmax (Nt, TR) f32 per-ray upper
    bound -> occ (Nt, TR) bool, True iff some candidate triangle has t in
    (T_MIN, tmax)."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[-1] // 3
    occ = torch.zeros((n_tiles, tr), dtype=torch.bool, device=o4.device)
    for a, b in _chunks(n_tiles, batch, tr, c):
        for k in range(0, int(counts[a:b].max()), batch):
            t = _live_tiles(counts, a, b, k)
            cl, live = _candidates(words[t], counts[t], k, batch, n_cl)
            tv = _cluster_t(o4[t, None], d4[t, None], w[cl.long()], tmax[t, None, :, None])
            hit = (tv < T_FAR) & live[..., None, None]
            occ[t] |= hit.any(-1).any(1)
    return occ


# ---------------------------------------------------------------------------
# The closest-hit key: bits(t) << 32 | step << (log2 B + lane bits) | rank <<
# lane bits | lane, where step is the word index over B, and rank the place of
# the lane's cluster among the step's live clusters by id (csrc/traversal2.cu).
# Within a step (rank, lane) orders as the slot cl*C + lane does, so keys
# order as the walk's tie rule: (t, step, slot).
# ---------------------------------------------------------------------------

def closest_key_bits(c: int, batch: int):
    """(lane bits, step shift) of the closest-hit key for clusters of c
    triangles and steps of batch words (batch a power of two)."""
    lane_bits = max(0, (c - 1).bit_length())
    return lane_bits, (batch - 1).bit_length() + lane_bits


def check_closest_key(c: int, k_cap: int, batch: int):
    """Raise unless every step of a list of up to k_cap words fits the
    closest-hit key beside its rank and lane."""
    shift = closest_key_bits(c, batch)[1]
    steps = -(-k_cap // batch)
    if steps > 1 << (32 - shift):
        raise ValueError(f"lists of up to {k_cap} words in steps of {batch} over clusters of {c} "
                         f"triangles do not fit the closest-hit key: at most "
                         f"{1 << (32 - shift)} steps")


def pack_closest_key(t, step, rank, lane, c: int, batch: int):
    """The closest-hit key of hits with t (f32, > 0), step, rank and lane
    (int tensors) -> int64."""
    lane_bits, shift = closest_key_bits(c, batch)
    return ((t.contiguous().view(torch.int32).long() << 32) | (step.long() << shift)
            | (rank.long() << lane_bits) | lane.long())


def unpack_closest_key(key, c: int, batch: int):
    """int64 keys -> (t f32, step, rank, lane i64); t == T_FAR for KEY_MISS."""
    lane_bits, shift = closest_key_bits(c, batch)
    low = key & 0xFFFFFFFF
    return ((key >> 32).to(torch.int32).view(torch.float32), low >> shift,
            (low >> lane_bits) & (batch - 1), low & ((1 << lane_bits) - 1))


def step_ranks(cl, live):
    """Each word's rank among its step's live clusters by id: cl, live (...,
    B) -> (..., B) i64, the number of live words of the step with a lower
    id."""
    below = (cl[..., None, :] < cl[..., :, None]) & live[..., None, :]
    return below.sum(-1)


def closest_finish_plain(key, words, counts, n_cl: int, c: int, batch: int):
    """The plain version of the closest-hit finishing pass: key (Nt, TR)
    int64, the minimum of pack_closest_key over each ray's hits or KEY_MISS
    -> (bt (Nt, TR) f32, bid (Nt, TR) i32): the key's t, and the slot cl*C +
    lane of its (step, rank, lane), or -1 for a miss."""
    bt, step, rank, lane = unpack_closest_key(key, c, batch)
    hit = bt < T_FAR
    k0 = torch.where(hit, step, 0) * batch                                  # (Nt, TR)
    j = k0[..., None] + torch.arange(batch, device=key.device)              # (Nt, TR, B)
    n = counts.long()[:, None, None]
    word = torch.gather(words.long(), 1, torch.minimum(j, n - 1).clamp(0, words.shape[1] - 1)
                        .flatten(1)).view_as(j)
    cl = torch.clamp_max(word & _CL_MASK, n_cl - 1)
    live = j < n
    pick = (step_ranks(cl, live) == rank[..., None]) & live
    slot = torch.gather(cl, -1, pick.to(torch.uint8).argmax(-1, keepdim=True))[..., 0] * c + lane
    return bt, torch.where(hit, slot, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, CUDA kernel on CUDA tensors
# ---------------------------------------------------------------------------

def _check_cuda(o4, d4, w, words, counts, *extra):
    """Raise unless the arguments are what the CUDA kernels take."""
    check_dense(o4.device, (o4, torch.float32), (d4, torch.float32), (w, torch.float32),
                (words, torch.int32), (counts, torch.int32), *extra)
    check_rays(o4, d4, w)
    n_tiles = o4.shape[0]
    if words.ndim != 2 or words.shape[0] != n_tiles or words.shape[1] < 1:
        raise ValueError(f"words must be (Nt, K>=1), got {tuple(words.shape)}")
    if counts.shape != (n_tiles,):
        raise ValueError(f"counts must be (Nt,), got {tuple(counts.shape)}")


def _closest_out(o4):
    n_tiles, tr, _ = o4.shape
    return (torch.empty((n_tiles, tr), dtype=torch.float32, device=o4.device),
            torch.empty((n_tiles, tr), dtype=torch.int32, device=o4.device))


def check_quads(w):
    """What the kernels that read a cluster as quads of 4 triangles
    (closest_hit_kernel, closest_fast_kernel, the two of csrc/stream.cu and
    the two of csrc/traversal3.cu) take beyond _check_cuda: 16-byte loads of 4
    triangles' coefficients need C % 4 == 0 and an aligned matrix."""
    c = w.shape[2] // 3
    if c % 4 or w.data_ptr() % 16:
        raise ValueError(f"the quad-reading kernels take C % 4 == 0 and a 16-byte aligned w, "
                         f"got C = {c}, address {w.data_ptr():#x}")


def _launch_closest(o4, d4, w, words, counts):
    """One launch of closest_hit_kernel and its finishing pass over checked
    CUDA tensors -> (bt, bid) (Nt, TR). The key starts as KEY_MISS; the
    segment table (run_segments), the counter and the key are its scratch."""
    n_tiles, tr = o4.shape[:2]
    if tr > MAX_RAYS:
        raise ValueError(f"tile of {tr} rays: the closest-hit kernel folds its slices' keys "
                         f"in shared memory for at most {MAX_RAYS} rays a block")
    check_quads(w)
    c, k_cap = w.shape[2] // 3, words.shape[1]
    check_closest_key(c, k_cap, BATCH)
    bt, bid = _closest_out(o4)
    if n_tiles:
        dev = o4.device
        order, ends = run_segments(counts, SEG, k_cap)
        next_seg = torch.zeros(1, dtype=torch.int32, device=dev)
        key = torch.full((n_tiles, tr), KEY_MISS, dtype=torch.int64, device=dev)
        _launch("closest", "tt_closest", dev, words, counts, n_tiles, k_cap, tr, o4, d4, w,
                w.shape[0], c, order, ends, ends.shape[0], next_seg,
                sm_count(dev.index) * BLOCKS_PER_SM_CLOSEST, key, bt, bid)
    return bt, bid


def closest_hit(o4, d4, w, words, counts):
    """closest_hit_plain on CPU tensors; on CUDA tensors the kernels
    closest_hit_kernel and, behind it on the stream, closest_hit_finish_kernel
    (one call of the C entry point, counted as one launch)."""
    if o4.device.type == "cpu":
        return closest_hit_plain(o4, d4, w, words, counts)
    _check_cuda(o4, d4, w, words, counts)
    return _launch_closest(o4, d4, w, words, counts)


def closest_fast(o4, d4, w, words, counts):
    """closest_fast_plain on CPU tensors; the CUDA kernel
    closest_fast_kernel on CUDA tensors (C % 4 == 0 and an aligned w, as
    check_quads)."""
    if o4.device.type == "cpu":
        return closest_fast_plain(o4, d4, w, words, counts)
    _check_cuda(o4, d4, w, words, counts)
    check_quads(w)
    if o4.shape[1] * SLICES_FAST > 1024:
        raise ValueError(f"tile of {o4.shape[1]} rays: the fast kernel takes {SLICES_FAST} "
                         f"threads a ray and at most 1024 a block")
    bt, bid = _closest_out(o4)
    if o4.shape[0]:
        _launch("closest_fast", "tt_closest_fast", o4.device, words, counts, o4.shape[0],
                words.shape[1], o4.shape[1], o4, d4, w, w.shape[0], w.shape[2] // 3, bt, bid)
    return bt, bid


def _launch_anyhit(name: str, entry: str, o4, d4, tmax, w, words, counts):
    """One launch of a segmented any-hit kernel (anyhit_kernel or
    anyhit_stream_kernel) over checked CUDA tensors -> occ (Nt, TR) bool.
    The kernel only ever sets flags, so occ starts as zeros; the segment
    table (run_segments) and the segment counter are its scratch."""
    n_tiles, tr = o4.shape[:2]
    if tmax.shape != (n_tiles, tr):
        raise ValueError(f"tmax must be (Nt, TR), got {tuple(tmax.shape)}")
    if tr * SLICES > 1024:
        raise ValueError(f"tile of {tr} rays: the any-hit kernels take {SLICES} threads a ray "
                         f"and at most 1024 a block")
    dev = o4.device
    occ = torch.zeros((n_tiles, tr), dtype=torch.uint8, device=dev)
    if n_tiles:
        order, ends = run_segments(counts, SEG, words.shape[1])
        next_seg = torch.zeros(1, dtype=torch.int32, device=dev)
        _launch(name, entry, dev, words, counts, words.shape[1], tr, o4, d4, tmax, w,
                w.shape[0], w.shape[2] // 3, order, ends, ends.shape[0], next_seg,
                sm_count(dev.index) * BLOCKS_PER_SM, occ)
    return occ.bool()


def anyhit(o4, d4, tmax, w, words, counts):
    """anyhit_plain on CPU tensors; the CUDA kernel anyhit_kernel on CUDA
    tensors."""
    if o4.device.type == "cpu":
        return anyhit_plain(o4, d4, tmax, w, words, counts)
    _check_cuda(o4, d4, w, words, counts, (tmax, torch.float32))
    return _launch_anyhit("anyhit", "tt_anyhit", o4, d4, tmax, w, words, counts)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _count_sort(counts):
    """Tile order by descending count (stable) and its inverse."""
    order = torch.argsort(-counts, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv


def trace_tiles_split(o_t, d_t, accel, words, counts):
    """Closest hit over count-sorted tiles in three regions:

      [0, P)   generic kernel (count > 1), P = #tiles with count > FAST_BATCH;
      [P, Z)   straight-line fast kernel (count == 1), Z = #tiles with count > 0;
      [Z, Nt)  no kernel: miss constants (count == 0).

    Returns (bt (Nt, TR), gid (Nt, TR) slot cl*C + lane or -1, excess,
    (need_split, need_zero)) with need_split = P and need_zero = Z."""
    n_tiles, tr, _ = o_t.shape
    order, inv = _count_sort(counts)
    o4, d4 = _homog(o_t[order], d_t[order])
    words_s = words[order].contiguous()
    counts_s = counts[order].contiguous()
    w = accel.tri_w
    P, Z = (int(x) for x in torch.stack(
        [(counts > FAST_BATCH).sum(), (counts > 0).sum()]).tolist())
    excess = (counts_s[P:Z] > FAST_BATCH).sum() + (counts_s[Z:] > 0).sum()
    parts_bt, parts_bid = [], []
    if P > 0:
        bt_g, bid_g = closest_hit(o4[:P], d4[:P], w, words_s[:P], counts_s[:P])
        parts_bt.append(bt_g)
        parts_bid.append(bid_g)
    if Z > P:
        bt_f, bid_f = closest_fast(o4[P:Z], d4[P:Z], w, words_s[P:Z], counts_s[P:Z])
        parts_bt.append(bt_f)
        parts_bid.append(bid_f)
    if n_tiles > Z:
        parts_bt.append(o4.new_full((n_tiles - Z, tr), T_FAR))
        parts_bid.append(counts.new_full((n_tiles - Z, tr), -1))
    bt = torch.cat(parts_bt)[inv]
    bid = torch.cat(parts_bid)[inv]
    return bt, bid, excess, (P, Z)


def trace_tiles_sorted(o_t, d_t, accel, words, counts, t_min=T_MIN):
    """Closest hit of every tile in one closest_hit pass (the generic
    kernel on every tile, whatever its count; a tile with count 0 has no
    segment and keeps the miss constants): (bt (Nt, TR), gid (Nt, TR) slot
    cl*C + lane or -1). Bit-equal to trace_tiles_split's (bt, gid). The
    reference's group, batch, shared_o and interpret answer to its Mosaic
    lowering and are not taken; B is BATCH, the kernel's."""
    _check_t_min(t_min)
    o4, d4 = _homog(o_t, d_t)
    return closest_hit(o4, d4, accel.tri_w, words.contiguous(), counts.contiguous())


def any_hit_tiles_sorted(o_t, d_t, t_max_t, accel, words, counts, t_min=T_MIN):
    """Occlusion of every tile in ONE any-hit launch -> (Nt, TR) bool; a
    tile with count 0 has no segment and stays unoccluded. Padding rays
    (d == 0) get t_max = 0 so they cannot raise a tile's early-out bound.
    The reference's group, batch, shared_o and interpret are not taken, as
    for trace_tiles_sorted."""
    _check_t_min(t_min)
    valid = (d_t != 0.0).any(-1)
    tmax = torch.where(valid, t_max_t, 0.0)
    o4, d4 = _homog(o_t, d_t)
    return anyhit(o4, d4, tmax, accel.tri_w, words.contiguous(), counts.contiguous())


def _check_t_min(t_min):
    if t_min != T_MIN:
        raise ValueError(f"the traversal2 kernels are built for t_min = {T_MIN}, got {t_min}")


def any_hit_tiles_graded(o_t, d_t, t_max_t, accel, words, counts):
    """any_hit_tiles_sorted, with the reference's bookkeeping. (The
    reference sorts the tiles and grades the kernel region into B=4 and B=1
    parts because its lockstep groups of 8 tiles step to the group's max
    count; the kernel here works through segments, heaviest tiles first, in
    whatever order the tiles lie.)

    Returns (occ (Nt, TR) bool, excess, (need_b1, need_zero)) with need_b1
    = #tiles with count > 1, need_zero = #tiles with count > 0, and excess
    0: no tile lies outside a region that is exact for it."""
    need = tuple(int(x) for x in torch.stack(
        [(counts > 1).sum(), (counts > 0).sum()]).tolist())
    occ = any_hit_tiles_sorted(o_t, d_t, t_max_t, accel, words, counts)
    return occ, torch.zeros((), dtype=torch.int64, device=o_t.device), need


def recover_hit(scene, ray: Ray, bt, gid, accel, t_min=T_MIN) -> Hit:
    """Kernel output (best t, slot cl*C + lane or -1) -> a full Hit: the
    original triangle through accel.tri_ids, and (t, u, v) from one
    Moller-Trumbore per ray (the kernel's t only selects). Relaxed
    barycentric bounds (bary_eps 1e-5) keep the recompute from vetoing the
    affine-map selection over rounding differences."""
    valid = gid >= 0
    tri = torch.where(valid, accel.tri_ids.reshape(-1)[gid.clamp_min(0).long()], -1)
    idx = scene.tris[tri.clamp_min(0).long()].long()
    v0, v1, v2 = (scene.verts[idx[..., i]] for i in range(3))
    t, u, v, hitm = moller_trumbore(ray.o, ray.d, v0, v1, v2, t_min=t_min, bary_eps=1e-5)
    valid = valid & hitm
    return Hit(t=torch.where(valid, t, T_FAR), tri=torch.where(valid, tri, -1),
               uv=torch.where(valid[..., None], torch.stack([u, v], dim=-1), 0.0))


def make_sorted_tracers(scene, accel, tr: int = 64):
    """(trace_fn, occlude_fn) over the sorted front-to-back kernels: tiles
    of tr rays -> cull_clusters_sorted2 -> trace_tiles_split /
    any_hit_tiles_graded -> recover_hit. The cull runs at its exact widths
    (no k_cap), so no candidate is dropped."""

    def trace_fn(ray: Ray) -> Hit:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        words, counts, _excess, _need = cull_clusters_sorted2(accel, o_t, d_t, T_FAR)
        bt, gid, _excess, _need = trace_tiles_split(o_t, d_t, accel, words, counts)
        return recover_hit(scene, ray, untile(bt, tiling), untile(gid, tiling), accel)

    def occlude_fn(ray: Ray, t_max) -> torch.Tensor:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        t_max_t = tiled_tmax(t_max, ray, o_t, tr)
        words, counts, _excess, _need = cull_clusters_sorted2(accel, o_t, d_t, t_max_t)
        occ, _excess, _need = any_hit_tiles_graded(o_t, d_t, t_max_t, accel, words, counts)
        return untile(occ, tiling)

    return trace_fn, occlude_fn
