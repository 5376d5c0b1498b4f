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
"""
from __future__ import annotations

import torch

from tracer_torch.bvh.cluster import SUPER_FACTOR
from tracer_torch.core.types import T_FAR
from tracer_torch.utils.metrics import readback, span

_EPS = 1e-12

# Packed candidate words: top 15 bits = quantized entry distance (IEEE-754
# bits of the non-negative float, truncated: monotone and a conservative
# floor), low 17 bits = cluster id. 0x7FFFFFFF = invalid, sorts last.
CLUSTER_BITS = 17
_CL_MASK = (1 << CLUSTER_BITS) - 1
WORD_INVALID = 0x7FFFFFFF

# Fetched stage-2 boxes per chunk of tiles (Nt * S * SUPER_FACTOR * 6 f32).
_STAGE2_BYTES = 1 << 30


def _round8(v: int) -> int:
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
    k = _round8(readback(counts.max(), "cull.k")) if n_tiles else 8
    excess = torch.clamp_min(counts - k, 0).sum()
    return _cut_words(words, k), counts, excess


def cull_clusters_sorted2(accel, o: torch.Tensor, d: torch.Tensor, t_max):
    """Two-stage front-to-back cull: superclusters first, then only the
    survivors' clusters. The result equals cull_clusters_sorted (the
    supercluster box contains its clusters' boxes and the interval test is
    monotone in the box), at a stage-2 width of S*SUPER_FACTOR instead of
    Ncl.

    Returns (words, counts, excess, need) with need = (max cluster count,
    max supercluster count): the reference's need_k and need_s. Stage 2
    runs in chunks of tiles so that its fetched boxes stay near 1 GB."""
    n_cl = accel.num_clusters
    n_sc = accel.super_lo.shape[0]
    F = SUPER_FACTOR
    if n_sc <= 1:
        with span("cull.stage1"):
            words, counts, excess = cull_clusters_sorted(accel, o, d, t_max)
        return words, counts, excess, (readback(counts.max(), "cull.need"), 0)
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
            k = _round8(readback(counts.max(), "cull.k"))
            words = torch.cat([_cut_words(w, k) for w in parts_w])
        else:  # no tile reaches any supercluster
            counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
            k = 8
            words = torch.full((n_tiles, k), WORD_INVALID, dtype=torch.int32, device=dev)
        sup_excess = torch.clamp_min(sup_counts - S, 0).sum()
        excess = torch.clamp_min(counts - k, 0).sum() + sup_excess
    return words, counts, excess, (readback(counts.max(), "cull.need") if n_tiles else 0, S)
