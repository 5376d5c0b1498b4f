"""Tile-frustum vs cluster-AABB culling (torch counterpart of
tracer/bvh/cull.py).

Rays are grouped into coherent tiles; each tile is summarized by interval
bounds on its origins and directions, and a cluster survives iff SOME ray in
those intervals can reach its AABB within [0, t_max] (interval arithmetic on
the slab test: conservative). The survivors are packed with their
conservative entry distance into sortable int32 words, so sorting a tile's
words is its front-to-back traversal order.

The reference sizes every pass with static caps (k_cap, s_cap) because XLA
needs static shapes. Eager PyTorch reads the needs instead: stage 2 runs at
the exact supercluster width S = max(sup_counts) and the word lists are cut
at the exact k = max(counts) rounded up to 8, so no candidate is ever
dropped. `excess` is still computed with the reference's formula, so
`excess == 0` stays a checked fact.

cull_clusters_sorted2, the two-stage cull of the frames and the grad step,
is a wrapper: CPU tensors take its plain version (ATen ops,
cull_clusters_sorted2_plain), CUDA tensors the two kernels of csrc/cull.cu
(cull_stage1, cull_stage2; launch counters LAUNCHES["cull_stage1"] and
["cull_stage2"] of kernels/_launch.py), which give the same words, counts,
excess and need bit for bit. Both record the spans "cull.stage1" and
"cull.stage2", the read-backs "cull.s", "cull.k" and "cull.need", and the
counter "cull_spills": the passes whose words torch.sort ordered, which is
every pass of the plain version and, on the card, a pass whose fullest tile
held more words than a block sorts (see _cull_sorted2_cuda).
"""
from __future__ import annotations

import torch

from tracer_torch.bvh.cluster import SUPER_FACTOR
from tracer_torch.core.types import T_FAR
from tracer_torch.kernels._launch import check_dense, launch
from tracer_torch.utils.metrics import count, readback, span

_EPS = 1e-12

# Packed candidate words: top 15 bits = quantized entry distance (IEEE-754
# bits of the non-negative float, truncated: monotone and a conservative
# floor), low 17 bits = cluster id. 0x7FFFFFFF = invalid, sorts last.
CLUSTER_BITS = 17
_CL_MASK = (1 << CLUSTER_BITS) - 1
WORD_INVALID = 0x7FFFFFFF

# Fetched stage-2 boxes per chunk of tiles (Nt * S * SUPER_FACTOR * 6 f32),
# in the plain version.
_STAGE2_BYTES = 1 << 30

# The most words a block of the cull kernels sorts in shared memory
# (kSortCap of csrc/cull.cu); a tile with more writes them unsorted. And
# the floats a tile's bounds and t_max take between the kernels.
SORT_CAP = 8192
TILE_FLOATS = 16


def round8(v: int) -> int:
    """v rounded up to a multiple of 8, at least 8: the k a pass's word lists
    are cut to from its fullest tile's count."""
    return max(8, -(-int(v) // 8) * 8)


def _upper_lower(a, b, c, ge: bool):
    """Bounds on t from constraint a + t*b (<= or >=) c, broadcast
    scalars. Returns (lo, hi, ok)."""
    pos = b > _EPS
    neg = b < -_EPS
    r = (c - a) / torch.where(b.abs() > _EPS, b, torch.ones_like(b))
    zero = torch.zeros_like(r)
    far = torch.full_like(r, T_FAR)
    if ge:  # a + t*b >= c
        return (torch.where(pos, r, zero), torch.where(neg, r, far),
                pos | neg | (a >= c))
    # a + t*b <= c
    return (torch.where(neg, r, zero), torch.where(pos, r, far),
            pos | neg | (a <= c))


def frustum_aabb_entry(o_lo, o_hi, d_lo, d_hi, box_lo, box_hi, t_max):
    """(..., 3) tile interval bounds vs (..., 3) AABBs (all broadcast) ->
    (feasible (...) bool, t_lo (...) conservative entry distance)."""
    shape = torch.broadcast_shapes(o_lo[..., 0].shape, box_lo[..., 0].shape)
    t_lo = torch.zeros(shape, dtype=torch.float32, device=o_lo.device)
    t_hi = t_max.expand(shape)
    ok = torch.ones(shape, dtype=torch.bool, device=o_lo.device)
    for k in range(3):
        lo1, hi1, ok1 = _upper_lower(o_lo[..., k], d_lo[..., k], box_hi[..., k], ge=False)
        lo2, hi2, ok2 = _upper_lower(o_hi[..., k], d_hi[..., k], box_lo[..., k], ge=True)
        t_lo = torch.maximum(t_lo, torch.maximum(lo1, lo2))
        t_hi = torch.minimum(t_hi, torch.minimum(hi1, hi2))
        ok = ok & ok1 & ok2
    return ok & (t_lo <= t_hi), t_lo


def frustum_aabb_feasible(o_lo, o_hi, d_lo, d_hi, box_lo, box_hi, t_max) -> torch.Tensor:
    """frustum_aabb_entry without the entry distance -> (...) bool."""
    return frustum_aabb_entry(o_lo, o_hi, d_lo, d_hi, box_lo, box_hi, t_max)[0]


def tile_bounds(o: torch.Tensor, d: torch.Tensor):
    """(Ntiles, TR, 3) rays -> per-tile interval bounds (Ntiles, 3) x4.
    Rays with d == 0 (padding, dead) are ignored; a tile with no live ray
    collapses to a structurally infeasible frustum."""
    valid = (d != 0.0).any(-1, keepdim=True)
    big = torch.tensor(T_FAR, dtype=torch.float32, device=o.device)
    o_lo = torch.where(valid, o, big).amin(1)
    o_hi = torch.where(valid, o, -big).amax(1)
    d_lo = torch.where(valid, d, big).amin(1)
    d_hi = torch.where(valid, d, -big).amax(1)
    any_valid = valid[..., 0].any(1, keepdim=True)
    zero = torch.zeros_like(big)
    return (torch.where(any_valid, o_lo, big), torch.where(any_valid, o_hi, -big),
            torch.where(any_valid, d_lo, zero), torch.where(any_valid, d_hi, zero))


def pack_candidates(t_lo: torch.Tensor, cluster: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """(entry-t, cluster id, valid) -> packed int32 words. The clamp keeps
    the reference's max(t, 0.0) == +0.0 for t == -0.0 (torch's maximum
    would keep -0.0, whose sign bit would make the word negative)."""
    tb = (torch.clamp_min(t_lo, 0.0) + 0.0).view(torch.int32)
    q = tb & ~_CL_MASK
    return torch.where(valid, q | cluster.to(torch.int32),
                       torch.full_like(q, WORD_INVALID))


def _tile_tmax(t_max, n_tiles: int, device) -> torch.Tensor:
    """Scalar or (Ntiles, TR) per-ray t_max -> (Ntiles, 1) per-tile max."""
    if isinstance(t_max, torch.Tensor) and t_max.ndim > 0:
        return t_max.amax(1, keepdim=True)
    return torch.full((n_tiles, 1), float(t_max), dtype=torch.float32, device=device)


def _cut_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted words -> exactly k columns (cut, or padded with WORD_INVALID)."""
    if words.shape[1] >= k:
        return words[:, :k].contiguous()
    pad = words.new_full((words.shape[0], k - words.shape[1]), WORD_INVALID)
    return torch.cat([words, pad], dim=1)


def cull_clusters(accel, o: torch.Tensor, d: torch.Tensor, t_max, k_cap: int | None = None):
    """Unsorted two-level cull: tiles vs superclusters, then vs clusters.

    o, d: (Ntiles, TR, 3); t_max: scalar or (Ntiles, TR). Returns (cand
    (Ntiles, k) int32 candidate cluster ids in ascending order, padded past
    each tile's count by repeating its last valid id; counts (Ntiles,)
    int32, not clipped to k; excess () candidates dropped). k is the max
    count (at least 1), so nothing is dropped; an explicit k_cap cuts the
    lists at min(k_cap, Ncl) columns as the reference's static cap does."""
    n_cl = accel.num_clusters
    o_lo, o_hi, d_lo, d_hi = tile_bounds(o, d)
    t_max_tile = _tile_tmax(t_max, o_lo.shape[0], o.device)
    bounds = (o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None])
    sup = frustum_aabb_feasible(*bounds, accel.super_lo[None], accel.super_hi[None], t_max_tile)
    sup_mask = sup.repeat_interleave(SUPER_FACTOR, dim=1)[:, :n_cl]
    mask = sup_mask & frustum_aabb_feasible(*bounds, accel.cluster_lo[None],
                                            accel.cluster_hi[None], t_max_tile)
    counts = mask.sum(1, dtype=torch.int32)
    if k_cap is None:
        k = max(1, int(counts.max())) if counts.numel() else 1
    else:
        k = min(k_cap, n_cl)
    # Candidates first, in ascending cluster id (stable sort of not-candidate).
    cand = torch.argsort(~mask, dim=1, stable=True)[:, :k].to(torch.int32)
    slot = torch.arange(k, dtype=torch.int32, device=o.device)[None]
    last_valid = (counts - 1).clamp(0, k - 1)[:, None].long()
    cand = torch.where(slot < counts.clamp_min(1)[:, None], cand, cand.gather(1, last_valid))
    excess = torch.clamp_min(counts - k, 0).sum()
    return cand, counts, excess


def cull_clusters_sorted(accel, o: torch.Tensor, d: torch.Tensor, t_max):
    """Single-stage front-to-back cull: tiles vs every cluster AABB.

    Returns (words (Ntiles, k) int32 sorted ascending with k = max count
    rounded up to 8, counts (Ntiles,) int32, excess () candidates dropped,
    0 by construction)."""
    o_lo, o_hi, d_lo, d_hi = tile_bounds(o, d)
    n_tiles = o_lo.shape[0]
    t_max_tile = _tile_tmax(t_max, n_tiles, o.device)
    ok, t_lo = frustum_aabb_entry(
        o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None],
        accel.cluster_lo[None], accel.cluster_hi[None], t_max_tile)
    counts = ok.sum(1, dtype=torch.int32)
    ids = torch.arange(accel.num_clusters, dtype=torch.int32, device=o.device)[None]
    words = torch.sort(pack_candidates(t_lo, ids, ok), dim=1).values
    k = round8(readback(counts.max(), "cull.k")) if n_tiles else 8
    excess = torch.clamp_min(counts - k, 0).sum()
    return _cut_words(words, k), counts, excess


def cull_clusters_sorted2(accel, o: torch.Tensor, d: torch.Tensor, t_max):
    """Two-stage front-to-back cull: superclusters first, then only the
    survivors' clusters. The result equals cull_clusters_sorted (the
    supercluster box contains its clusters' boxes and the interval test is
    monotone in the box), at a stage-2 width of S*SUPER_FACTOR instead of
    Ncl.

    Returns (words, counts, excess, need) with need = (max cluster count,
    max supercluster count): the reference's need_k and need_s. CPU tensors
    take cull_clusters_sorted2_plain; CUDA tensors the two kernels of
    csrc/cull.cu (the same words, counts, excess and need), or it raises.
    One supercluster takes the single-stage cull on either device."""
    if accel.super_lo.shape[0] > 1 and o.device.type != "cpu":
        return _cull_sorted2_cuda(accel, o, d, t_max)
    count("cull_spills")   # the plain version sorts every pass with torch.sort
    if accel.super_lo.shape[0] > 1:
        return cull_clusters_sorted2_plain(accel, o, d, t_max)
    with span("cull.stage1"):
        words, counts, excess = cull_clusters_sorted(accel, o, d, t_max)
    return words, counts, excess, (readback(counts.max(), "cull.need"), 0)


def cull_clusters_sorted2_plain(accel, o: torch.Tensor, d: torch.Tensor, t_max):
    """cull_clusters_sorted2 in ATen ops, for more than one supercluster.
    Stage 2 runs in chunks of tiles so that its fetched boxes stay near
    1 GB."""
    n_cl = accel.num_clusters
    n_sc = accel.super_lo.shape[0]
    F = SUPER_FACTOR
    dev = o.device
    with span("cull.stage1"):
        o_lo, o_hi, d_lo, d_hi = tile_bounds(o, d)
        n_tiles = o_lo.shape[0]
        t_max_tile = _tile_tmax(t_max, n_tiles, dev)

        # Stage 1: superclusters (Ntiles, Nsc), untruncated.
        ok_s, t_s = frustum_aabb_entry(
            o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None],
            accel.super_lo[None], accel.super_hi[None], t_max_tile)
        sup_counts = ok_s.sum(1, dtype=torch.int32)
        sc_ids = torch.arange(n_sc, dtype=torch.int32, device=dev)[None]
        words_s1 = torch.sort(pack_candidates(t_s, sc_ids, ok_s), dim=1).values
        S = readback(sup_counts.max(), "cull.s")

    with span("cull.stage2"):
        # Cluster AABB table by supercluster; padding clusters (a short last
        # supercluster) get lo > hi finite sentinels: infeasible by construction.
        big = 3e37
        pad = n_sc * F - n_cl
        lo_t = torch.cat([accel.cluster_lo, accel.cluster_lo.new_full((pad, 3), big)])
        hi_t = torch.cat([accel.cluster_hi, accel.cluster_hi.new_full((pad, 3), -big)])
        lo_t = lo_t.reshape(n_sc, F, 3)
        hi_t = hi_t.reshape(n_sc, F, 3)
        lane = torch.arange(F, dtype=torch.int32, device=dev)

        parts_w, parts_c = [], []
        chunk = max(1, _STAGE2_BYTES // max(1, S * F * 6 * 4))
        for a in range(0, n_tiles if S > 0 else 0, chunk):
            b = min(a + chunk, n_tiles)
            sid = torch.clamp_max(words_s1[a:b, :S] & _CL_MASK, n_sc - 1)
            slot_ok = (torch.arange(S, device=dev)[None] < sup_counts[a:b, None])[..., None, None]
            box_lo = torch.where(slot_ok, lo_t[sid.long()], big)
            box_hi = torch.where(slot_ok, hi_t[sid.long()], -big)
            ok2, t2 = frustum_aabb_entry(
                o_lo[a:b, None, None], o_hi[a:b, None, None],
                d_lo[a:b, None, None], d_hi[a:b, None, None],
                box_lo, box_hi, t_max_tile[a:b, :, None])
            cl_ids = torch.clamp_max(sid[..., None] * F + lane, n_cl - 1)
            ok2 = ok2.reshape(b - a, S * F)
            w = pack_candidates(t2.reshape(b - a, S * F), cl_ids.reshape(b - a, S * F), ok2)
            parts_w.append(torch.sort(w, dim=1).values)
            parts_c.append(ok2.sum(1, dtype=torch.int32))
        if parts_c:
            counts = torch.cat(parts_c)
            k = round8(readback(counts.max(), "cull.k"))
            words = torch.cat([_cut_words(w, k) for w in parts_w])
        else:
            counts, k, words = _no_candidates(n_tiles, dev)
        sup_excess = torch.clamp_min(sup_counts - S, 0).sum()
        excess = torch.clamp_min(counts - k, 0).sum() + sup_excess
    return words, counts, excess, (readback(counts.max(), "cull.need") if n_tiles else 0, S)


def _no_candidates(n_tiles: int, dev):
    """(counts, k, words) of a pass in which no tile reaches a supercluster."""
    return (torch.zeros(n_tiles, dtype=torch.int32, device=dev), 8,
            torch.full((n_tiles, 8), WORD_INVALID, dtype=torch.int32, device=dev))


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _block(bound: int) -> tuple[int, int]:
    """(threads, cap) of a cull kernel's launch whose tiles hold at most
    `bound` words: a thread for every 4 words, 64 to 256 threads a block,
    and a shared buffer of the next power of two of bound words, at most
    SORT_CAP."""
    return min(256, max(64, _pow2(-(-bound // 4)))), min(SORT_CAP, _pow2(max(1, bound)))


def _check_rays(o, d, t_max) -> bool:
    """Raise unless o, d are (Nt, TR, 3) float32 on one device and a per-ray
    t_max (Nt, TR) float32 there too; returns whether t_max is per ray."""
    per_ray = isinstance(t_max, torch.Tensor) and t_max.ndim > 0
    rays = (o, d, t_max) if per_ray else (o, d)
    if o.ndim != 3 or o.shape[2] != 3 or d.shape != o.shape or (
            per_ray and t_max.shape != o.shape[:2]):
        raise ValueError(f"the cull takes o, d (Nt, TR, 3) and t_max (Nt, TR) or a scalar, got "
                         f"{[tuple(x.shape) for x in rays]}")
    if any(x.dtype != torch.float32 or x.device != o.device for x in rays):
        raise ValueError(f"the cull kernels take float32 rays on one device, got "
                         f"{[(x.dtype, str(x.device)) for x in rays]}")
    return per_ray


def cull_stage1(o: torch.Tensor, d: torch.Tensor, t_max, box_lo: torch.Tensor,
                box_hi: torch.Tensor):
    """Stage 1 on the card (cull_stage1_kernel): o, d (Nt, TR, 3) float32 of
    any strides, t_max scalar or (Nt, TR), the supercluster boxes (Nsc, 3)
    -> (words (Nt, Nsc) int32: row t's first counts[t] entries the tile's
    surviving words, sorted where counts[t] <= SORT_CAP, the rest of the row
    unwritten; counts (Nt,) int32; tiles (Nt, TILE_FLOATS) float32: the
    tile's tile_bounds o_lo, o_hi, d_lo, d_hi and _tile_tmax)."""
    dev = o.device
    check_dense(dev, (box_lo, torch.float32), (box_hi, torch.float32))
    if _check_rays(o, d, t_max):   # tm, its strides, its columns, the scalar
        tm = (t_max, *t_max.stride(), t_max.shape[1], 0.0)
    else:
        tm = (None, 0, 0, 0, float(t_max))
    n_tiles, tr, _ = o.shape
    n_box = box_lo.shape[0]
    words = torch.empty((n_tiles, n_box), dtype=torch.int32, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tiles = torch.empty((n_tiles, TILE_FLOATS), dtype=torch.float32, device=dev)
    launch("cull_stage1", "cu_stage1", dev, o, d, *o.stride(), *d.stride(), *tm, n_tiles, tr,
           box_lo, box_hi, n_box, *_block(n_box), words, counts, tiles)
    return words, counts, tiles


def cull_stage2(tiles: torch.Tensor, words_s1: torch.Tensor, sup_counts: torch.Tensor, s: int,
                cl_lo: torch.Tensor, cl_hi: torch.Tensor):
    """Stage 2 on the card (cull_stage2_kernel): stage 1's tiles, words_s1
    (Nt, >= s) and sup_counts, s = max(sup_counts), the cluster boxes
    (Ncl, 3) -> (words (Nt, s*SUPER_FACTOR) int32: row t the tile's
    counts[t] surviving words, sorted where counts[t] <= SORT_CAP, then
    WORD_INVALID; counts (Nt,) int32)."""
    dev = tiles.device
    check_dense(dev, (tiles, torch.float32), (words_s1, torch.int32),
                (sup_counts, torch.int32), (cl_lo, torch.float32), (cl_hi, torch.float32))
    n_tiles = tiles.shape[0]
    width = s * SUPER_FACTOR
    words = torch.empty((n_tiles, width), dtype=torch.int32, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    launch("cull_stage2", "cu_stage2", dev, tiles, words_s1, words_s1.shape[1], sup_counts,
           n_tiles, cl_lo, cl_hi, cl_lo.shape[0], width, *_block(width), words, counts)
    return words, counts


def _cull_sorted2_cuda(accel, o: torch.Tensor, d: torch.Tensor, t_max):
    """cull_clusters_sorted2 through cull_stage1 and cull_stage2, with the
    plain version's spans and read-backs. A stage whose fullest tile holds
    more than SORT_CAP words (S, then the max count, both read by the host
    anyway) sorts the pass's words with torch.sort; the counter
    "cull_spills" counts such passes (0 for a pass sorted in the kernels)."""
    with span("cull.stage1"):
        words_s1, sup_counts, tiles = cull_stage1(o, d, t_max, accel.super_lo, accel.super_hi)
        n_tiles = words_s1.shape[0]
        S = readback(sup_counts.max(), "cull.s")
        spilled = S > SORT_CAP
        if spilled:
            cols = torch.arange(S, device=o.device)[None] < sup_counts[:, None]
            words_s1 = torch.sort(torch.where(cols, words_s1[:, :S], WORD_INVALID),
                                  dim=1).values
    with span("cull.stage2"):
        if S > 0:
            words, counts = cull_stage2(tiles, words_s1, sup_counts, S, accel.cluster_lo,
                                        accel.cluster_hi)
            m = readback(counts.max(), "cull.k")
            if m > SORT_CAP:
                spilled = True
                words = torch.sort(words, dim=1).values
            k = round8(m)
            words = _cut_words(words, k)
        else:
            counts, k, words = _no_candidates(n_tiles, o.device)
        sup_excess = torch.clamp_min(sup_counts - S, 0).sum()
        excess = torch.clamp_min(counts - k, 0).sum() + sup_excess
    count("cull_spills", int(spilled))
    return words, counts, excess, (readback(counts.max(), "cull.need") if n_tiles else 0, S)
