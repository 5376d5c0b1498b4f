"""The pair-stream tier: closest-hit and any-hit over one global (tile,
candidate) stream (torch counterpart of tracer/kernels/traversal3.py).

The per-tile candidate lists, sorted front to back by
bvh.cull.cull_clusters_sorted, are flattened into ONE stream of packed
words ordered (tile, entry-t): build_pair_stream, the reference's stream pair
for pair. A tile's pairs are consecutive, so a tile is a run offs[t] ..
offs[t+1] of the stream, and the tile passes take the stream in that form
(_tile_stream). Walking its run one pair a step, a tile
  * stops at the first pair whose entry-t bits reach its bound (closest
    hit: the max over its rays of the best t so far; any-hit: the max t_max
    over its rays not yet occluded), as kernels/traversal2.py does;
  * skips a cluster that no ray can enter before its own best t (or t_max):
    a per-ray slab test against the cluster's box (_slab_enter). The prune
    is per ray, the skip per cluster: a tested cluster updates every ray.

Each of the two kernels has a plain version (pair_closest_plain,
pair_anyhit_plain: the same walk, vectorized over tiles, taking the same
stop and skip decisions), a wrapper (pair_closest, pair_anyhit: the plain
version for CPU tensors, the CUDA kernel of csrc/traversal3.cu for CUDA
tensors, or it raises) and a launch counter in kernels/_launch.py. The
triangle arithmetic is traversal2's _cluster_t.

Not carried over from the reference, by design: _pad_w and the 8-column
_boxes table, the trash tile row, PAIR_CHUNK, _chunk_windows, _iter_chunks
and the aliased carries between chunk launches. They fit the stream into a
scalar memory and carry state across grid steps; here a block owns a tile,
reads its run from device memory and keeps its state in registers.
"""
from __future__ import annotations

import warnings

import torch

from tracer_torch.bvh.cull import CLUSTER_BITS, WORD_INVALID, cull_clusters_sorted
from tracer_torch.core.types import T_FAR, Hit, Ray
from tracer_torch.kernels._launch import check_dense, check_rays, launch
from tracer_torch.kernels.traversal import (
    _homog, _tile_chunks, tile_rays, tile_runs, tiled_tmax, untile)
from tracer_torch.kernels.traversal2 import _closest_out, _cluster_t, check_quads, recover_hit

_CL_MASK = (1 << CLUSTER_BITS) - 1
_BIG = T_FAR

# pair_anyhit_kernel serves a ray with SLICES_PAIR threads (a block of 128
# for a tile of 64 rays), takes a tile's run in windows of WINDOW words (one
# bit of a 32-bit vote mask each) and copies the next voted clusters into a
# ring of NBUF_PAIR stages (kSlicesPair, kWindow, kNBufPair of
# csrc/traversal3.cu).
SLICES_PAIR = 2
WINDOW = 32
NBUF_PAIR = 4
# pair_closest_kernel walks the run the same way, with SLICES_PAIR_CLOSEST
# threads a ray and a ring of NBUF_PAIR_CLOSEST stages (kSlicesPairClosest,
# kNBufPairClosest).
SLICES_PAIR_CLOSEST = 2
NBUF_PAIR_CLOSEST = 2


def build_pair_stream(words, counts, p_cap: int | None = None):
    """Flatten per-tile sorted candidate lists into a global pair stream.

    words: (Nt, K) packed (entry-t | cluster) words sorted ascending per
    tile; counts: (Nt,). Returns (tiles (p_cap,), pwords (p_cap,), total,
    overflow). Every tile emits at least one pair (an empty tile its
    WORD_INVALID sentinel); padding pairs sit on tile Nt with WORD_INVALID.
    p_cap None is the exact total, so nothing is dropped; under a smaller
    p_cap every tile is clamped to its p_cap // Nt nearest candidates and
    overflow is True."""
    n_tiles, k = words.shape
    counts2 = counts.clamp_min(1)
    total0 = int(counts2.sum())
    if p_cap is None:
        p_cap = total0
    overflow = total0 > p_cap
    if overflow:
        counts2 = counts2.clamp_max(max(p_cap // n_tiles, 1))
    offs = torch.cat([counts2.new_zeros(1), counts2.cumsum(0)]).to(torch.int32)
    total = int(offs[-1])
    p = torch.arange(p_cap, dtype=torch.int32, device=words.device)
    tile = (torch.searchsorted(offs, p, right=True) - 1).clamp(0, n_tiles - 1)
    kk = (p - offs[tile]).clamp(0, k - 1)
    valid = p < total
    tiles = torch.where(valid, tile.to(torch.int32), n_tiles)
    pwords = torch.where(valid, words[tile, kk.long()], WORD_INVALID)
    return tiles, pwords, total, overflow


def _tile_stream(words, counts, p_cap: int | None):
    """The pairs of build_pair_stream's stream as runs: (offs (Nt+1,) int32
    with tile t's words at offs[t] .. offs[t+1], pwords (P,), overflow). An
    empty tile's run is empty (its sentinel pair ends a walk at once), and
    a p_cap under the stream's total clamps every tile as build_pair_stream
    does."""
    overflow = p_cap is not None and int(counts.clamp_min(1).sum()) > p_cap
    if overflow:
        counts = counts.clamp_max(max(p_cap // words.shape[0], 1))
    return (*tile_runs(words, counts), overflow)


def _ray_rows(o_t, d_t):
    """(Nt, TR, 3) rays -> (Nt, 8, TR) slab-test rows: 0..2 origin xyz,
    3..5 1/d (0 where d == 0), 6 the live flag (1.0 for a real ray, 0.0
    for padding), 7 zero."""
    oT = o_t.transpose(1, 2)
    dT = d_t.transpose(1, 2)
    inv = torch.where(dT == 0.0, 0.0, 1.0 / torch.where(dT == 0.0, 1.0, dT))
    live = (dT != 0.0).any(1, keepdim=True).to(o_t.dtype)
    return torch.cat([oT, inv, live, torch.zeros_like(live)], dim=1)


def _slab_enter(rt, lo, hi):
    """Per-ray slab test: rt (..., 8, TR) ray rows against boxes lo, hi
    (..., 3) -> entry distance (..., TR): max(t_enter, 0) where the ray's
    line crosses the box, _BIG where it cannot or the ray is padding."""
    enter = torch.zeros_like(rt[..., 0, :])
    exit_ = torch.full_like(enter, T_FAR)
    ok = rt[..., 6, :] > 0.0
    for k in range(3):
        o = rt[..., k, :]
        inv = rt[..., 3 + k, :]
        lo_k, hi_k = lo[..., k:k + 1], hi[..., k:k + 1]
        deg = inv == 0.0
        t1 = (lo_k - o) * inv
        t2 = (hi_k - o) * inv
        inside = (o >= lo_k) & (o <= hi_k)
        tn = torch.where(deg, torch.where(inside, 0.0, _BIG), torch.minimum(t1, t2))
        tf = torch.where(deg, torch.where(inside, _BIG, -_BIG), torch.maximum(t1, t2))
        enter = torch.maximum(enter, tn)
        exit_ = torch.minimum(exit_, tf)
    ok = ok & (enter <= exit_) & (exit_ > 0.0)
    return torch.where(ok, enter, _BIG)


# ---------------------------------------------------------------------------
# Plain versions: the same walk, vectorized over tiles
# ---------------------------------------------------------------------------

def _bits(x):
    return x.contiguous().view(torch.int32)


def _walk(offs, pwords, bound, n_cl: int):
    """Step j of every tile's run: yields (tiles still walking whose j-th
    word's entry bits are under their bound, those words' cluster ids).
    `bound` (Nt,) int32 is read anew at every step."""
    runs = (offs[1:] - offs[:-1]).long()
    start = offs[:-1].long()
    for j in range(int(runs.max()) if runs.numel() else 0):
        t = torch.nonzero(runs > j)[:, 0]
        word = pwords[start[t] + j]
        go = (word & ~_CL_MASK) < bound[t]
        yield t[go], (word[go] & _CL_MASK).clamp_max(n_cl - 1).long()


def pair_closest_plain(o4, d4, w, lo, hi, offs, pwords):
    """Closest hit over the pair stream: o4, d4 (Nt, TR, 4), w (Ncl, 4, 3C),
    boxes lo, hi (Ncl, 3), offs (Nt+1,), pwords (P,) -> (bt (Nt, TR) best t
    or T_FAR, bid (Nt, TR) slot cl*C + lane or -1). Per cluster the first
    lane that attains the minimum wins; the running best is replaced only
    on a strict <. Runs in chunks of tiles."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[2] // 3
    bt_all = o4.new_full((n_tiles, tr), T_FAR)
    bid_all = torch.full((n_tiles, tr), -1, dtype=torch.int32, device=o4.device)
    lanes = torch.arange(c, dtype=torch.int32, device=o4.device)
    for a, b in _tile_chunks(n_tiles, tr, c):
        o4c, d4c, bt, bid = o4[a:b], d4[a:b], bt_all[a:b], bid_all[a:b]
        rt = _ray_rows(o4c[..., :3], d4c[..., :3])
        bound = _bits(bt).amax(1)
        for t, cl in _walk(offs[a:b + 1], pwords, bound, n_cl):
            test = (_slab_enter(rt[t], lo[cl], hi[cl]) < bt[t]).any(1)
            t, cl = t[test], cl[test]
            tv = _cluster_t(o4c[t], d4c[t], w[cl], T_FAR)
            tmin = tv.amin(-1)
            lane = torch.where(tv == tmin[..., None], lanes, c).amin(-1)
            better = tmin < bt[t]
            bid[t] = torch.where(better, cl[:, None].to(torch.int32) * c + lane, bid[t])
            bt[t] = torch.where(better, tmin, bt[t])
            bound[t] = _bits(bt[t]).amax(1)
    return bt_all, bid_all


def pair_anyhit_plain(o4, d4, tmax, w, lo, hi, offs, pwords):
    """Occlusion over the pair stream: as pair_closest_plain plus tmax
    (Nt, TR), the per-ray upper bound, 0 for padding rays -> occ (Nt, TR)
    bool, True iff some tested triangle has t in (T_MIN, tmax)."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[2] // 3
    occ_all = torch.zeros((n_tiles, tr), dtype=torch.bool, device=o4.device)
    for a, b in _tile_chunks(n_tiles, tr, c):
        o4c, d4c, tm, occ = o4[a:b], d4[a:b], tmax[a:b], occ_all[a:b]
        rt = _ray_rows(o4c[..., :3], d4c[..., :3])
        bound = _bits(tm).amax(1)
        for t, cl in _walk(offs[a:b + 1], pwords, bound, n_cl):
            touch = (_slab_enter(rt[t], lo[cl], hi[cl]) < tm[t]) & ~occ[t]
            test = touch.any(1)
            t, cl = t[test], cl[test]
            tv = _cluster_t(o4c[t], d4c[t], w[cl], tm[t][..., None])
            occ[t] |= tv.amin(-1) < T_FAR
            bound[t] = _bits(torch.where(occ[t], 0.0, tm[t])).amax(1)
    return occ_all


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, CUDA kernel on CUDA tensors
# ---------------------------------------------------------------------------

def _check_pairs(o4, d4, w, lo, hi, offs, pwords, *extra):
    """Raise unless the arguments are what the pair kernels take."""
    check_dense(o4.device, (o4, torch.float32), (d4, torch.float32), (w, torch.float32),
                (lo, torch.float32), (hi, torch.float32), (offs, torch.int32),
                (pwords, torch.int32), *extra)
    check_rays(o4, d4, w)
    if lo.shape != (w.shape[0], 3) or hi.shape != lo.shape:
        raise ValueError(f"lo/hi must be (Ncl, 3), got {tuple(lo.shape)}, {tuple(hi.shape)}")
    if offs.shape != (o4.shape[0] + 1,) or pwords.ndim != 1:
        raise ValueError(f"offs must be (Nt+1,) and pwords (P,), got {tuple(offs.shape)}, "
                         f"{tuple(pwords.shape)}")


def _check_block(tr: int, slices: int, what: str):
    if tr * slices > 1024:
        raise ValueError(f"tile of {tr} rays: the pair {what} kernel takes {slices} threads a "
                         f"ray and at most 1024 a block")


def pair_closest(o4, d4, w, lo, hi, offs, pwords):
    """pair_closest_plain on CPU tensors; the CUDA kernel
    pair_closest_kernel on CUDA tensors (C % 4 == 0 and an aligned w, as
    traversal2.check_quads)."""
    if o4.device.type == "cpu":
        return pair_closest_plain(o4, d4, w, lo, hi, offs, pwords)
    _check_pairs(o4, d4, w, lo, hi, offs, pwords)
    check_quads(w)
    _check_block(o4.shape[1], SLICES_PAIR_CLOSEST, "closest-hit")
    bt, bid = _closest_out(o4)
    if o4.shape[0]:
        launch("pair_closest", "pr_closest", o4.device, offs, pwords, o4.shape[0], o4.shape[1],
               o4, d4, lo, hi, w, w.shape[0], w.shape[2] // 3, bt, bid)
    return bt, bid


def pair_anyhit(o4, d4, tmax, w, lo, hi, offs, pwords):
    """pair_anyhit_plain on CPU tensors; the CUDA kernel pair_anyhit_kernel
    on CUDA tensors (C % 4 == 0 and an aligned w, as
    traversal2.check_quads)."""
    if o4.device.type == "cpu":
        return pair_anyhit_plain(o4, d4, tmax, w, lo, hi, offs, pwords)
    _check_pairs(o4, d4, w, lo, hi, offs, pwords, (tmax, torch.float32))
    if tmax.shape != o4.shape[:2]:
        raise ValueError(f"tmax must be (Nt, TR), got {tuple(tmax.shape)}")
    check_quads(w)
    _check_block(o4.shape[1], SLICES_PAIR, "any-hit")
    occ = torch.empty(o4.shape[:2], dtype=torch.uint8, device=o4.device)
    if o4.shape[0]:
        launch("pair_anyhit", "pr_anyhit", o4.device, offs, pwords, o4.shape[0], o4.shape[1],
               o4, d4, tmax, lo, hi, w, w.shape[0], w.shape[2] // 3, occ)
    return occ.bool()


# ---------------------------------------------------------------------------
# Tile passes and tracers
# ---------------------------------------------------------------------------

def trace_tiles_pairs(o_t, d_t, accel, words, counts, p_cap: int | None = None):
    """Closest hit over the pair stream, one launch over all tiles ->
    (bt (Nt, TR), gid (Nt, TR) slot cl*C + lane or -1, overflow); overflow
    True when an explicit p_cap cut candidates."""
    offs, pwords, overflow = _tile_stream(words, counts, p_cap)
    o4, d4 = _homog(o_t, d_t)
    bt, gid = pair_closest(o4, d4, accel.tri_w, accel.cluster_lo.contiguous(),
                           accel.cluster_hi.contiguous(), offs, pwords)
    return bt, gid, overflow


def any_hit_tiles_pairs(o_t, d_t, t_max_t, accel, words, counts, p_cap: int | None = None):
    """Occlusion over the pair stream -> ((Nt, TR) bool, overflow). Padding
    rays (d == 0) get t_max = 0 so they cannot raise a tile's bound (they
    never hit: den == 0)."""
    offs, pwords, overflow = _tile_stream(words, counts, p_cap)
    o4, d4 = _homog(o_t, d_t)
    tmax = torch.where((d_t != 0.0).any(-1), t_max_t, 0.0).contiguous()
    occ = pair_anyhit(o4, d4, tmax, accel.tri_w, accel.cluster_lo.contiguous(),
                      accel.cluster_hi.contiguous(), offs, pwords)
    return occ, overflow


def make_pair_tracers(scene, accel, tr: int = 64, p_cap: int | None = None):
    """(trace_fn, occlude_fn) over the pair-stream kernels: a drop-in for
    kernels.traversal2.make_sorted_tracers. p_cap caps the pairs of one pass
    (None: every stream as long as its cull's counts say, exact); a cap that
    cuts a stream warns."""

    def warn(overflow):
        if overflow:
            warnings.warn(f"tracer pair-stream overflow: p_cap={p_cap} cut the tiles' candidate "
                          f"lists, the image may be incomplete", RuntimeWarning, stacklevel=3)

    def trace_fn(ray: Ray) -> Hit:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        words, counts, _excess = cull_clusters_sorted(accel, o_t, d_t, T_FAR)
        bt, gid, overflow = trace_tiles_pairs(o_t, d_t, accel, words, counts, p_cap)
        warn(overflow)
        return recover_hit(scene, ray, untile(bt, tiling), untile(gid, tiling), accel)

    def occlude_fn(ray: Ray, t_max) -> torch.Tensor:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        t_max_t = tiled_tmax(t_max, ray, o_t, tr)
        words, counts, _excess = cull_clusters_sorted(accel, o_t, d_t, t_max_t)
        occ, overflow = any_hit_tiles_pairs(o_t, d_t, t_max_t, accel, words, counts, p_cap)
        warn(overflow)
        return untile(occ, tiling)

    return trace_fn, occlude_fn
