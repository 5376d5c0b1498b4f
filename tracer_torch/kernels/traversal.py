"""The work-list tier over the cluster accel, and the ray tiling every tier
shares (torch counterpart of tracer/kernels/traversal.py).

Rays are grouped into coherent tiles of TR rays: 2D (H, W) batches whose
sides divide by sqrt(TR) are tiled spatially (8x8 pixels at TR=64), other
batches are chunked in order, with padding rays of d = 0 that never hit.
bvh.cull.cull_clusters gives each tile its candidate clusters in ascending
cluster id, unsorted in depth, so this tier walks every candidate:

  * trace_tiles_plain / any_hit_tiles_plain: a loop over candidate slots in
    plain PyTorch, the counterpart of trace_tiles_jnp / any_hit_tiles_jnp.
    The tier behind make_accel_tracers(use_pallas=False), differentiable in
    the rays and in accel.tri_w, and the plain version of the two kernels;
  * trace_tiles_worklist / any_hit_tiles_worklist: the candidate lists
    flattened into one tile-ordered list of runs (tile_runs) and walked by
    the CUDA kernels of csrc/traversal.cu through the wrappers
    worklist_closest / worklist_anyhit (plain version on CPU tensors, the
    kernel on CUDA tensors, or they raise; launches counted in
    kernels/_launch.py). The counterpart of trace_tiles_pallas /
    any_hit_tiles_pallas. The kernels do not walk a tile in one block:
    their unit of work is a segment of SEG_WL items of a tile's run
    (_launch.run_segments), pulled by persistent blocks. Occlusion is an OR
    over the items, so its segments only set flags; closest hits merge
    through a 64-bit key a ray (pack_key) under an atomic minimum, exact
    because the tie rule is a total order, and a finishing pass
    (worklist_finish_plain is its plain version) turns the keys into
    (t, tri, u, v).

Both evaluate _affine_products + _field_epilogue: four products summed left
to right, a guarded divide and the test u >= 0, v >= 0, u + v <= 1. This is
not the arithmetic of kernels/traversal2.py (_cluster_t), and the two pick
different lanes on grazing hits.

Not carried over from the reference, by design: pack_worklist's 12-bit tile
/ 17-bit cluster word, _chunk_plan, MAX_CHUNK_TILES, MAX_WORK_PER_CALL,
_pad_tiles and the lax.map over chunks of tiles. They keep a work list
inside a 1 MB scalar memory the card does not have: here a block reads its
own run of the list from device memory, and one launch covers every tile.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from tracer_torch.bvh.cull import cull_clusters
from tracer_torch.core.types import T_FAR, Hit, Ray, normalize
from tracer_torch.kernels._launch import check_dense, check_rays, launch, run_segments, sm_count

DEFAULT_TILE = 256
T_MIN = 1e-4

# The work-list kernels' unit of work is a segment, SEG_WL consecutive items
# of one tile's run (a step is TR rays x C triangles, 256 x 128 at the
# defaults); a block is TR threads, one a ray. Their grid is
# BLOCKS_PER_SM_WL persistent blocks for every SM of the card (at some 40
# registers a thread, 6 blocks of 256 threads fit). The kernels are built
# for clusters of CLUSTER_WL triangles, the size the presets build (kSegWL,
# kClusterWL of csrc/traversal.cu).
SEG_WL = 4
BLOCKS_PER_SM_WL = 6
CLUSTER_WL = 128

# The closest-hit key of a ray: bits(t) << 32 | item << KEY_LANE_BITS | lane,
# item the position in the tile's run (kLaneBits of csrc/traversal.cu; the 17
# bits left for the item are bvh.cull.CLUSTER_BITS). KEY_MISS is what a ray
# without a hit keeps: T_FAR's bits over all ones.
KEY_LANE_BITS = 15
KEY_ITEM_BITS = 32 - KEY_LANE_BITS
_T_FAR_BITS = int(torch.tensor(T_FAR, dtype=torch.float32).view(torch.int32))
KEY_MISS = (_T_FAR_BITS << 32) | 0xFFFFFFFF


class Tiling(NamedTuple):
    batch_shape: tuple
    n_rays: int
    tile_hw: tuple | None  # (th, tw, H, W) when image-tiled


def tile_rays(o: torch.Tensor, d: torch.Tensor, tr: int = DEFAULT_TILE):
    """(..., 3) rays -> (Ntiles, TR, 3) o and d + tiling info."""
    batch_shape = tuple(o.shape[:-1])
    if len(batch_shape) == 2:
        H, W = batch_shape
        th = tw = int(tr ** 0.5)
        if th * tw == tr and H % th == 0 and W % tw == 0:
            def fold(x):
                f = x.reshape(H // th, th, W // tw, tw, 3)
                return f.permute(0, 2, 1, 3, 4).reshape(-1, tr, 3)

            return fold(o), fold(d), Tiling(batch_shape, H * W, (th, tw, H, W))
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = o.shape[0]
    n_pad = -(-n // tr) * tr
    if n_pad != n:
        o = torch.cat([o, o.new_zeros((n_pad - n, 3))])
        d = torch.cat([d, d.new_zeros((n_pad - n, 3))])
    return o.reshape(-1, tr, 3), d.reshape(-1, tr, 3), Tiling(batch_shape, n, None)


def generate_rays_tiled(camera, height: int, width: int, tr: int):
    """Primary rays generated directly in the (Ntiles, TR, 3) tiled layout:
    the same arithmetic as generate_rays + tile_rays, with the spatial fold
    done by index math. Falls back to exactly that pair when sqrt(TR) does
    not divide both image sides."""
    th = tw = int(tr ** 0.5)
    if th * tw != tr or height % th or width % tw:
        from tracer_torch.core.camera import generate_rays

        rays = generate_rays(camera, height, width)
        return tile_rays(rays.o, rays.d, tr)
    dev = camera.position.device
    ntx = width // tw
    tiles = torch.arange((height // th) * ntx, dtype=torch.int32, device=dev)[:, None]
    slot = torch.arange(tr, dtype=torch.int32, device=dev)[None, :]
    yy = (torch.div(tiles, ntx, rounding_mode="floor") * th
          + torch.div(slot, tw, rounding_mode="floor")).to(torch.float32)
    xx = ((tiles % ntx) * tw + slot % tw).to(torch.float32)
    right, up, fwd = camera.basis()
    aspect = width / height
    tan_half = torch.tan(camera.fov_y * 0.5)
    ndc_x = ((xx + 0.5) / width * 2.0 - 1.0) * aspect * tan_half
    ndc_y = (1.0 - (yy + 0.5) / height * 2.0) * tan_half
    d = ndc_x[..., None] * right + ndc_y[..., None] * up + fwd.expand(*ndc_x.shape, 3)
    o = camera.position.expand(d.shape)
    return o, normalize(d), Tiling((height, width), height * width,
                                   (th, tw, height, width))


def untile(x: torch.Tensor, tiling: Tiling) -> torch.Tensor:
    """(Ntiles, TR, ...) -> the original batch shape."""
    tail = tuple(x.shape[2:])
    if tiling.tile_hw is not None:
        th, tw, H, W = tiling.tile_hw
        x = x.reshape(H // th, W // tw, th, tw, *tail)
        perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
        return x.permute(perm).reshape(H, W, *tail)
    x = x.reshape(-1, *tail)[: tiling.n_rays]
    return x.reshape(*tiling.batch_shape, *tail)


def _homog(o: torch.Tensor, d: torch.Tensor):
    """(..., 3) rays -> (o4, d4) = ([o, 1], [d, 0]), contiguous."""
    ones = o.new_ones(o.shape[:-1] + (1,))
    return torch.cat([o, ones], dim=-1), torch.cat([d, torch.zeros_like(ones)], dim=-1)


def tiled_tmax(t_max, ray: Ray, o_t, tr: int):
    """Scalar or per-ray t_max -> (Nt, TR) in the rays' tiling (padding 0)."""
    if not isinstance(t_max, torch.Tensor) or t_max.ndim == 0:
        return torch.full(o_t.shape[:2], float(t_max), dtype=torch.float32, device=o_t.device)
    tm3 = t_max[..., None].expand(ray.batch_shape + (3,))
    return tile_rays(tm3, tm3, tr)[0][..., 0]


# ---------------------------------------------------------------------------
# Shared arithmetic (field-major columns: [0:C) plane, [C:2C) u, [2C:3C) v)
# ---------------------------------------------------------------------------

def _affine_products(o4, d4, w):
    """so, sd = o4 @ w, d4 @ w as four broadcast products summed left to
    right, each rounded on its own. o4, d4: (..., TR, 4); w: (..., 4, 3C)
    -> (..., TR, 3C)."""
    def prod(r4):
        return (r4[..., :, 0:1] * w[..., 0:1, :]
                + r4[..., :, 1:2] * w[..., 1:2, :]
                + r4[..., :, 2:3] * w[..., 2:3, :]
                + r4[..., :, 3:4] * w[..., 3:4, :])

    return prod(o4), prod(d4)


def _field_epilogue(so, sd, c: int, t_min, t_max):
    """(..., 3C) products -> (t, u, v, hit) each (..., C); t == T_FAR where
    the pair misses."""
    den = sd[..., 0:c]
    safe = den.abs() > 1e-12
    t = -so[..., 0:c] / torch.where(safe, den, 1.0)
    u = so[..., c:2 * c] + t * sd[..., c:2 * c]
    v = so[..., 2 * c:3 * c] + t * sd[..., 2 * c:3 * c]
    hit = safe & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return torch.where(hit, t, T_FAR), u, v, hit


# ---------------------------------------------------------------------------
# Plain versions: a loop over candidate slots
# ---------------------------------------------------------------------------

# Bytes of (tiles, TR, 3C) temporaries a plain version holds at once.
_PLAIN_BYTES = 1 << 30


def _tile_chunks(n_tiles: int, tr: int, c: int):
    step = max(1, _PLAIN_BYTES // (16 * tr * 3 * c * 4))
    return [(a, min(a + step, n_tiles)) for a in range(0, n_tiles, step)]


def _closest_slots(o4, d4, tri_w, tri_ids, cand, counts, t_min=T_MIN):
    """Closest hit of o4, d4 (Nt, TR, 4) over cand (Nt, K) candidate
    clusters, slots past counts (Nt,) inactive -> (bt, btri, bu, bv) each
    (Nt, TR). Per cluster the first lane that attains the minimum t wins;
    across slots the running best is replaced only on a strict <. Runs in
    chunks of tiles; nothing is written in place, so autograd sees it."""
    n_tiles, tr, _ = o4.shape
    c = tri_ids.shape[1]
    lanes = torch.arange(c, device=o4.device)
    parts = []
    for a, b in _tile_chunks(n_tiles, tr, c):
        o4c, d4c, cnt = o4[a:b], d4[a:b], counts[a:b]
        bt = o4.new_full((b - a, tr), T_FAR)
        btri = torch.full((b - a, tr), -1, dtype=torch.int32, device=o4.device)
        bu = o4.new_zeros((b - a, tr))
        bv = o4.new_zeros((b - a, tr))
        for k in range(min(cand.shape[1], int(cnt.max()))):
            cidx = cand[a:b, k].long()
            so, sd = _affine_products(o4c, d4c, tri_w[cidx])
            t, u, v, _ = _field_epilogue(so, sd, c, t_min, T_FAR)
            t = torch.where((k < cnt)[:, None, None], t, T_FAR)
            tmin = t.amin(-1, keepdim=True)
            am = torch.where(t == tmin, lanes, c).amin(-1, keepdim=True)
            ids = tri_ids[cidx][:, None, :].expand(-1, tr, -1)
            better = tmin[..., 0] < bt
            bt = torch.where(better, t.gather(-1, am)[..., 0], bt)
            btri = torch.where(better, ids.gather(-1, am)[..., 0], btri)
            bu = torch.where(better, u.gather(-1, am)[..., 0], bu)
            bv = torch.where(better, v.gather(-1, am)[..., 0], bv)
        parts.append((bt, btri, bu, bv))
    if not parts:
        return _closest_out4(o4)
    return tuple(torch.cat(x) for x in zip(*parts))


def _closest_out4(o4):
    """Uninitialized (bt, btri, bu, bv), each (Nt, TR)."""
    shape, dev = o4.shape[:2], o4.device
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev))


def _anyhit_slots(o4, d4, tmax, tri_w, cand, counts, t_min=T_MIN):
    """Occlusion of o4, d4 (Nt, TR, 4) with per-ray bound tmax (Nt, TR) over
    cand (Nt, K), slots past counts inactive -> occ (Nt, TR) bool."""
    n_tiles, tr, _ = o4.shape
    c = tri_w.shape[2] // 3
    occ = torch.zeros((n_tiles, tr), dtype=torch.bool, device=o4.device)
    for a, b in _tile_chunks(n_tiles, tr, c):
        cnt = counts[a:b]
        for k in range(min(cand.shape[1], int(cnt.max()))):
            so, sd = _affine_products(o4[a:b], d4[a:b], tri_w[cand[a:b, k].long()])
            hit = _field_epilogue(so, sd, c, t_min, tmax[a:b, :, None])[3]
            occ[a:b] |= hit.any(-1) & (k < cnt)[:, None]
    return occ


def trace_tiles_plain(o_t, d_t, accel, cand, counts, t_min=T_MIN):
    """Closest hit over candidate clusters, a loop over candidate slots.
    o_t, d_t: (Ntiles, TR, 3); cand (Ntiles, K), counts (Ntiles,) from
    cull_clusters. Returns (t, tri, u, v) each (Ntiles, TR): tri the original
    triangle id (accel.tri_ids) or -1, t == T_FAR on a miss."""
    o4, d4 = _homog(o_t, d_t)
    return _closest_slots(o4, d4, accel.tri_w, accel.tri_ids, cand, counts, t_min)


def any_hit_tiles_plain(o_t, d_t, t_max_t, accel, cand, counts, t_min=T_MIN):
    """Occlusion over candidate clusters -> (Ntiles, TR) bool, True iff some
    candidate triangle has t in (t_min, t_max_t)."""
    o4, d4 = _homog(o_t, d_t)
    return _anyhit_slots(o4, d4, t_max_t, accel.tri_w, cand, counts, t_min)


# ---------------------------------------------------------------------------
# The work list, and the kernels over it
# ---------------------------------------------------------------------------

def build_worklist(cand, counts, work_cap: int | None = None):
    """Flatten per-tile candidate lists into a tile-ordered work list: the
    reference's list, item for item. The tile passes below read the valid
    items of the same list as runs (tile_runs), which need no padding.

    Every tile contributes max(count, 1) items. work_cap None sizes the list
    to exactly that total, so nothing is dropped; a smaller work_cap cuts
    the list there, a larger one pads it by repeating the final slot.
    Returns (tile_of, cluster_of, valid, overflow): (work_cap,) int32 x3
    (valid 1 for an item inside its tile's count) and whether the list was
    cut (a Python bool)."""
    n_tiles, k_cap = cand.shape
    eff = counts.clamp_min(1)
    mask = torch.arange(k_cap, dtype=torch.int32, device=cand.device)[None] < eff[:, None]
    idx = torch.nonzero(mask.reshape(-1))[:, 0].to(torch.int32)
    total = int(eff.sum())
    if work_cap is None:
        work_cap = total
    if idx.shape[0] < work_cap:
        idx = torch.cat([idx, idx.new_full((work_cap - idx.shape[0],), n_tiles * k_cap - 1)])
    idx = idx[:work_cap]
    tile_of = torch.div(idx, k_cap, rounding_mode="floor")
    k_of = idx % k_cap
    cluster_of = cand[tile_of.long(), k_of.long()]
    in_range = torch.arange(work_cap, dtype=torch.int32, device=cand.device) < total
    valid = (in_range & (k_of < counts[tile_of.long()])).to(torch.int32)
    return tile_of, cluster_of, valid, total > work_cap


def tile_runs(lists, counts):
    """Per-tile lists (Nt, K), the first counts (Nt,) slots of each valid,
    flattened in tile order: (offs (Nt+1,) int32 with tile t's items at
    offs[t] .. offs[t+1], items (W,)): the valid items of build_worklist's
    exact list, in its order."""
    counts = counts.clamp_max(lists.shape[1])
    offs = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    slot = torch.arange(lists.shape[1], device=lists.device)[None]
    return offs, lists[slot < counts[:, None]]


def _runs_to_slots(offs, clusters):
    """Runs -> (cand (Nt, K), counts (Nt,)) with K the longest run (>= 1);
    slots past a tile's count hold a valid cluster id that is never used."""
    counts = offs[1:] - offs[:-1]
    k = max(1, int(counts.max())) if counts.numel() else 1
    if clusters.numel() == 0:
        return torch.zeros((counts.shape[0], k), dtype=torch.int32, device=offs.device), counts
    slot = offs[:-1, None] + torch.arange(k, dtype=torch.int32, device=offs.device)[None]
    return clusters[slot.clamp_max(clusters.shape[0] - 1).long()], counts


def worklist_closest_plain(o4, d4, tri_w, tri_ids, offs, clusters):
    """The plain version of worklist_closest_kernel: trace_tiles_plain over
    the runs' clusters -> (bt, btri, bu, bv) each (Nt, TR)."""
    cand, counts = _runs_to_slots(offs, clusters)
    return _closest_slots(o4, d4, tri_w, tri_ids, cand, counts)


def worklist_anyhit_plain(o4, d4, tmax, tri_w, offs, clusters):
    """The plain version of worklist_anyhit_kernel: any_hit_tiles_plain over
    the runs' clusters -> occ (Nt, TR) bool."""
    cand, counts = _runs_to_slots(offs, clusters)
    return _anyhit_slots(o4, d4, tmax, tri_w, cand, counts)


def pack_key(t, item, lane):
    """The closest-hit key of hits with t (f32, > 0), item and lane (int
    tensors) -> int64; keys order as (t, item, lane) does."""
    return ((t.contiguous().view(torch.int32).long() << 32) | (item.long() << KEY_LANE_BITS)
            | lane.long())


def unpack_key(key):
    """int64 keys -> (t f32, item i64, lane i64); t == T_FAR for KEY_MISS."""
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return t, (key >> KEY_LANE_BITS) & ((1 << KEY_ITEM_BITS) - 1), key & ((1 << KEY_LANE_BITS) - 1)


def check_key_fits(c: int, k_cap: int):
    """Raise unless a lane of a cluster of c triangles and a position in a
    run of up to k_cap items fit the closest-hit key."""
    if c > 1 << KEY_LANE_BITS or k_cap > 1 << KEY_ITEM_BITS:
        raise ValueError(f"clusters of {c} triangles in runs of up to {k_cap} items do not fit "
                         f"the closest-hit key: at most {1 << KEY_LANE_BITS} and "
                         f"{1 << KEY_ITEM_BITS}")


def worklist_finish_plain(key, o4, d4, tri_w, tri_ids, offs, clusters):
    """The plain version of worklist_finish_kernel: key (Nt, TR) int64, the
    minimum of pack_key over each ray's hits or KEY_MISS -> (bt, btri, bu,
    bv) each (Nt, TR): the key's t, and for a hit the triangle id and u, v
    of the winning (item, lane) by _affine_products + _field_epilogue, for a
    miss (T_FAR, -1, 0, 0)."""
    c = tri_ids.shape[1]
    bt, item, lane = unpack_key(key)
    hit = bt < T_FAR
    item, lane = torch.where(hit, item, 0), torch.where(hit, lane, 0)     # a miss reads slot 0
    if clusters.numel() == 0:
        cl = torch.zeros_like(item)
    else:
        cl = clusters[(offs[:-1, None] + item).clamp_max(clusters.shape[0] - 1).long()].long()
    cols = lane[..., None] + c * torch.arange(3, device=key.device)          # (Nt, TR, 3)
    w = tri_w[cl[..., None, None], torch.arange(4, device=key.device)[:, None],
              cols[..., None, :]]                                            # (Nt, TR, 4, 3)
    so, sd = _affine_products(o4[..., None, :], d4[..., None, :], w)         # (Nt, TR, 1, 3)
    _, u, v, _ = _field_epilogue(so[..., 0, :], sd[..., 0, :], 1, T_MIN, T_FAR)
    return (bt, torch.where(hit, tri_ids[cl, lane], -1), torch.where(hit, u[..., 0], 0.0),
            torch.where(hit, v[..., 0], 0.0))


def _check_worklist(o4, d4, tri_w, offs, clusters, *extra):
    """Raise unless the arguments are what the work-list kernels take."""
    check_dense(o4.device, (o4, torch.float32), (d4, torch.float32), (tri_w, torch.float32),
                (offs, torch.int32), (clusters, torch.int32), *extra)
    check_rays(o4, d4, tri_w)
    if offs.shape != (o4.shape[0] + 1,) or clusters.ndim != 1:
        raise ValueError(f"offs must be (Nt+1,) and clusters (W,), got {tuple(offs.shape)}, "
                         f"{tuple(clusters.shape)}")
    if tri_w.shape[2] // 3 != CLUSTER_WL:
        raise ValueError(f"clusters of {tri_w.shape[2] // 3} triangles: the work-list kernels "
                         f"are built for {CLUSTER_WL}")


def _segment_scratch(offs, k_cap: int):
    """What a launch over segments takes after the runs: their lengths, the
    segment table over them, its number of ranks, the segment counter and
    the grid."""
    counts = (offs[1:] - offs[:-1]).contiguous()
    order, ends = run_segments(counts, SEG_WL, k_cap)
    next_seg = torch.zeros(1, dtype=torch.int32, device=offs.device)
    grid = sm_count(offs.device.index) * BLOCKS_PER_SM_WL
    return counts, order, ends, ends.shape[0], next_seg, grid


def worklist_closest(o4, d4, tri_w, tri_ids, offs, clusters, k_cap: int):
    """worklist_closest_plain on CPU tensors; on CUDA tensors the kernels
    worklist_closest_kernel and, behind it on the stream,
    worklist_finish_kernel (one call of the C entry point, counted as one
    launch). k_cap: an upper bound of the runs' lengths that is known on
    the host (the width of the candidate lists). The kernels take o4 =
    (o, 1) and d4 = (d, 0), as _homog makes them."""
    if o4.device.type == "cpu":
        return worklist_closest_plain(o4, d4, tri_w, tri_ids, offs, clusters)
    _check_worklist(o4, d4, tri_w, offs, clusters, (tri_ids, torch.int32))
    if tri_ids.shape != (tri_w.shape[0], tri_w.shape[2] // 3):
        raise ValueError(f"tri_ids must be (Ncl, C), got {tuple(tri_ids.shape)}")
    check_key_fits(tri_ids.shape[1], k_cap)
    out = _closest_out4(o4)
    if o4.shape[0]:
        counts, order, ends, n_ranks, next_seg, grid = _segment_scratch(offs, k_cap)
        key = torch.full(o4.shape[:2], KEY_MISS, dtype=torch.int64, device=o4.device)
        launch("worklist_closest", "wl_closest", o4.device, offs, clusters, counts, o4.shape[0],
               o4.shape[1], o4, d4, tri_w, tri_ids, tri_ids.shape[1], order, ends, n_ranks,
               next_seg, grid, key, *out)
    return out


def worklist_anyhit(o4, d4, tmax, tri_w, offs, clusters, k_cap: int):
    """worklist_anyhit_plain on CPU tensors; the CUDA kernel
    worklist_anyhit_kernel on CUDA tensors. k_cap and the rays' form as for
    worklist_closest. The kernel only ever sets flags, so occ starts as
    zeros."""
    if o4.device.type == "cpu":
        return worklist_anyhit_plain(o4, d4, tmax, tri_w, offs, clusters)
    _check_worklist(o4, d4, tri_w, offs, clusters, (tmax, torch.float32))
    if tmax.shape != o4.shape[:2]:
        raise ValueError(f"tmax must be (Nt, TR), got {tuple(tmax.shape)}")
    occ = torch.zeros(o4.shape[:2], dtype=torch.uint8, device=o4.device)
    if o4.shape[0]:
        counts, order, ends, n_ranks, next_seg, grid = _segment_scratch(offs, k_cap)
        launch("worklist_anyhit", "wl_anyhit", o4.device, offs, clusters, counts, o4.shape[1],
               o4, d4, tmax, tri_w, tri_w.shape[2] // 3, order, ends, n_ranks, next_seg, grid,
               occ)
    return occ.bool()


def trace_tiles_worklist(o_t, d_t, accel, cand, counts):
    """Closest hit over the tiles' runs of candidates, one launch over all
    tiles -> (t, tri, u, v) as trace_tiles_plain. The runs hold every
    candidate: the list is as long as the counts say."""
    o4, d4 = _homog(o_t, d_t)
    return worklist_closest(o4, d4, accel.tri_w, accel.tri_ids, *tile_runs(cand, counts),
                            cand.shape[1])


def any_hit_tiles_worklist(o_t, d_t, t_max_t, accel, cand, counts):
    """Occlusion over the tiles' runs of candidates -> (Ntiles, TR) bool."""
    o4, d4 = _homog(o_t, d_t)
    return worklist_anyhit(o4, d4, t_max_t.contiguous(), accel.tri_w,
                           *tile_runs(cand, counts), cand.shape[1])


# ---------------------------------------------------------------------------
# Tracers
# ---------------------------------------------------------------------------

def make_accel_tracers(scene, accel, use_pallas: bool = False, k_cap: int | None = None,
                       tr: int = DEFAULT_TILE):
    """(trace_fn, occlude_fn) over the cluster accel.

    use_pallas=False walks the candidates in plain PyTorch
    (trace_tiles_plain); use_pallas=True through the work-list kernels, on
    CUDA tensors (on CPU tensors their plain versions). k_cap caps each
    tile's candidate list (None: as wide as the longest list, exact); a cap
    that drops candidates warns. The kernels' runs hold every candidate the
    cull kept."""

    def cull(o_t, d_t, t_max):
        cand, counts, excess = cull_clusters(accel, o_t, d_t, t_max, k_cap)
        if k_cap is not None and int(excess):
            warnings.warn(f"tracer candidate-cap overflow: k_cap={k_cap} dropped {int(excess)} "
                          f"candidates, the image may be incomplete", RuntimeWarning,
                          stacklevel=3)
        return cand, counts

    def trace_fn(ray: Ray) -> Hit:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        cand, counts = cull(o_t, d_t, T_FAR)
        if use_pallas:
            bt, btri, bu, bv = trace_tiles_worklist(o_t, d_t, accel, cand, counts)
        else:
            bt, btri, bu, bv = trace_tiles_plain(o_t, d_t, accel, cand, counts)
        uv = torch.stack([bu, bv], dim=-1)
        return Hit(t=untile(bt, tiling), tri=untile(btri, tiling), uv=untile(uv, tiling))

    def occlude_fn(ray: Ray, t_max) -> torch.Tensor:
        o_t, d_t, tiling = tile_rays(ray.o, ray.d, tr)
        t_max_t = tiled_tmax(t_max, ray, o_t, tr)
        cand, counts = cull(o_t, d_t, t_max_t)
        if use_pallas:
            occ = any_hit_tiles_worklist(o_t, d_t, t_max_t, accel, cand, counts)
        else:
            occ = any_hit_tiles_plain(o_t, d_t, t_max_t, accel, cand, counts)
        return untile(occ, tiling)

    return trace_fn, occlude_fn

