"""Sharded-geometry tracing for scenes one card cannot hold whole (torch
counterpart of tracer/dist/ring.py).

The mesh is ("data", "geom"); triangles are split over "geom", each rank
holding one block of packed shade rows (pack_tri_rows, the cluster accel's
SHADE_COLS layout), or the shard-local cluster accel built from it
(build_rows_accel).

  * Ring (ring_trace_rows, ring_trace_accel, ring_any_hit,
    ring_any_hit_accel): rays stay; the geometry blocks rotate around the
    geom group, rank j sending to j + 1 and receiving from j - 1
    (batch_isend_irecv, the next block's transfer posted before the current
    block is traced), until every ray has met every block. The running
    nearest hit takes a block's hit only where it is strictly nearer, in
    ring order, so ties pick the reference's row. The winning row arrives
    with the hit: shading needs no gather afterwards.
  * Reduce (reduce_trace_rows, reduce_trace_accel, reduce_any_hit,
    reduce_any_hit_accel): every rank traces its own block once; the
    nearest hit is an all_reduce(MIN) of t, a second MIN over the shard
    index breaks ties, and an all_reduce(SUM) of the rows masked to the
    winner fetches its row (_reduce_merge).

The shard-local passes have two tiers with one communication pattern:
brute rows (_rows_hit, every ray against every row of the block) and the
cluster accel (accel_trace_rows, accel_any_hit: cull_clusters, then the
work-list passes of kernels/traversal.py, which launch worklist_closest
and worklist_anyhit on CUDA tensors and run their plain versions on CPU
tensors). k_cap caps each tile's candidate list; the candidates it drops
are counted and surfaced as the overflow (None: exact).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tracer_torch.bvh.cluster import CLUSTER_SIZE, SUPER_FACTOR, ClusterAccel
from tracer_torch.bvh.cull import cull_clusters
from tracer_torch.bvh.morton import morton3d, quantize_positions
from tracer_torch.core.camera import Camera, generate_rays
from tracer_torch.core.intersect import moller_trumbore, triangle_affine_maps
from tracer_torch.core.types import RAY_EPS, T_FAR, Ray, normalize
from tracer_torch.dist.mesh import DATA_AXIS, GEOM_AXIS
from tracer_torch.dist.ray_dp import gather_rows
from tracer_torch.kernels.traversal import (
    T_MIN, any_hit_tiles_worklist, tile_rays, tiled_tmax, trace_tiles_worklist, untile)
from tracer_torch.render.whitted import WhittedConfig, phong_specular
from tracer_torch.scene.types import Scene

# Rotating per-triangle payload: v0(3) e1(3) e2(3) n0(3) n1(3) n2(3)
# albedo(3) emission(3) mirror(1) valid(1) specular(1) shininess(1)
# = 28 cols, padded to 32 (cols 24-27 as bvh.cluster.SHADE_COLS).
ROW_COLS = 32
_INT_MAX = 2147483647


def pack_tri_rows(scene: Scene) -> torch.Tensor:
    """(T, ROW_COLS) per-triangle shade rows (the cluster accel's shade
    layout, in triangle order)."""
    t = scene.tris.long()
    v = scene.verts
    v0 = v[t[:, 0]]
    mats = scene.materials
    mat = scene.mat_id.long()
    mir = mats.mirror[mat][:, None]
    rows = torch.cat([v0, v[t[:, 1]] - v0, v[t[:, 2]] - v0, scene.normals[t[:, 0]],
                      scene.normals[t[:, 1]], scene.normals[t[:, 2]], mats.albedo[mat],
                      mats.emission[mat], mir, torch.ones_like(mir),
                      mats.specular[mat][:, None], mats.shininess[mat][:, None]], dim=1)
    return torch.cat([rows, rows.new_zeros((rows.shape[0], ROW_COLS - rows.shape[1]))], dim=1)


def pad_rows_to_shards(rows: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Pad the row table with all-zero rows (degenerate, valid flag 0: they
    never hit) so that it splits evenly over n_shards."""
    t = rows.shape[0]
    t_pad = -(-t // n_shards) * n_shards
    if t_pad != t:
        rows = torch.cat([rows, rows.new_zeros((t_pad - t, rows.shape[1]))])
    return rows


def _rows_hit(o, d, rows, t_min, t_max):
    """Rays (R, 3) x rows (T, ROW_COLS) -> (R, T) hit distances, T_FAR where
    the pair misses or the row is padding (valid flag, column 25, is 0):
    Moller-Trumbore against the rows' (v0, e1, e2)."""
    v0 = rows[None, :, 0:3]
    t, _, _, hit = moller_trumbore(o[:, None, :], d[:, None, :], v0, v0 + rows[None, :, 3:6],
                                   v0 + rows[None, :, 6:9], t_min=t_min, t_max=t_max)
    t = torch.where(hit, t, T_FAR)
    return torch.where(rows[None, :, 25] > 0.5, t, T_FAR)


def _nearest_row(t_pairs, rows):
    """(R, T) hit distances + (T, C) rows -> (R,) nearest t, (R, C) its row
    (the first of equal minima)."""
    idx = torch.argmin(t_pairs, dim=-1)
    return t_pairs.gather(1, idx[:, None])[:, 0], rows[idx]


# ---------------------------------------------------------------------------
# The shard-local cluster accel, built from a row block
# ---------------------------------------------------------------------------

def build_rows_accel(rows: torch.Tensor, cluster_size: int | None = None) -> ClusterAccel:
    """(T_shard, ROW_COLS) row block -> the shard-local ClusterAccel. Its
    shade table is the Morton-permuted row block, and its tri_ids are the
    sorted slot ids, which index that table directly. Padding rows sort to
    the back and fill invalid slots."""
    C = cluster_size or CLUSTER_SIZE
    T = rows.shape[0]
    dev = rows.device
    big = torch.tensor(T_FAR, dtype=torch.float32, device=dev)
    v0 = rows[:, 0:3]
    v1 = v0 + rows[:, 3:6]
    v2 = v0 + rows[:, 6:9]
    tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
    tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
    real = rows[:, 25] > 0.5  # padding rows must not skew the Morton grid
    centroid = (0.5 * (tri_lo + tri_hi)).detach()
    scene_lo = torch.where(real[:, None], centroid, big).amin(0)
    scene_hi = torch.where(real[:, None], centroid, -big).amax(0)
    codes = morton3d(quantize_positions(centroid, scene_lo, scene_hi))
    codes = torch.where(real, codes, torch.full_like(codes, 0xFFFFFFFF))
    order = torch.argsort(codes, stable=True)

    n_cl = -(-T // C)
    n_pad = n_cl * C
    order_p = torch.cat([order, order.new_zeros(n_pad - T)])
    slot_valid = (torch.arange(n_pad, device=dev) < T) & (rows[order_p, 25] > 0.5)

    verts = torch.stack([v0, v1, v2], dim=1).reshape(-1, 3)
    tris = torch.arange(3 * T, dtype=torch.int32, device=dev).reshape(T, 3)
    maps = triangle_affine_maps(verts, tris)[order_p]
    maps = torch.where(slot_valid[:, None, None], maps, 0.0)
    mc = maps.reshape(n_cl, C, 3, 4)
    w = torch.cat([mc[:, :, 0, :], mc[:, :, 1, :], mc[:, :, 2, :]], dim=1)
    tri_w = w.permute(0, 2, 1).contiguous()  # (Ncl, 4, 3C)

    slots = torch.arange(n_pad, dtype=torch.int32, device=dev)
    tri_ids = torch.where(slot_valid, slots, -1).reshape(n_cl, C)
    vm = slot_valid[:, None]
    lo_p = torch.where(vm, tri_lo[order_p], big).reshape(n_cl, C, 3)
    hi_p = torch.where(vm, tri_hi[order_p], -big).reshape(n_cl, C, 3)
    cluster_lo = lo_p.amin(1).detach()
    cluster_hi = hi_p.amax(1).detach()
    n_sc = -(-n_cl // SUPER_FACTOR)
    pad_sc = n_sc * SUPER_FACTOR - n_cl
    sc_lo = torch.cat([cluster_lo, big.expand(pad_sc, 3)]).reshape(n_sc, SUPER_FACTOR, 3)
    sc_hi = torch.cat([cluster_hi, (-big).expand(pad_sc, 3)]).reshape(n_sc, SUPER_FACTOR, 3)
    return ClusterAccel(tri_w=tri_w, tri_ids=tri_ids, cluster_lo=cluster_lo,
                        cluster_hi=cluster_hi, super_lo=sc_lo.amin(1), super_hi=sc_hi.amax(1),
                        shade=torch.where(vm, rows[order_p], 0.0))


_RING_K_CAP = 64
_RING_TR = 64


def _check_t_min(t_min):
    if t_min != T_MIN:
        raise ValueError(f"the work-list passes test t > {T_MIN} (the kernels' constant), "
                         f"got t_min={t_min}")


def accel_trace_rows(o, d, accel: ClusterAccel, t_min=RAY_EPS, t_max=T_FAR,
                     k_cap: int | None = _RING_K_CAP):
    """Shard-local nearest hit through the cluster accel -> (t (R,), row
    (R, ROW_COLS), excess () int: the cull candidates the k-cap dropped;
    nonzero means this shard skipped geometry, and the caller surfaces it).
    k_cap=None: no cap, exact. Tiles of _RING_TR rays in order."""
    _check_t_min(t_min)
    o_t, d_t, tiling = tile_rays(o, d, _RING_TR)
    cand, counts, excess = cull_clusters(accel, o_t, d_t, t_max, k_cap)
    bt, bslot, _, _ = trace_tiles_worklist(o_t, d_t, accel, cand, counts)
    t = untile(bt, tiling)
    slot = untile(bslot, tiling)
    row = accel.shade[slot.clamp_min(0).long()]
    row = torch.where((slot >= 0)[:, None], row, 0.0)
    return torch.where(slot >= 0, t, T_FAR), row, excess


def accel_any_hit(o, d, accel: ClusterAccel, t_max, t_min=RAY_EPS,
                  k_cap: int | None = _RING_K_CAP):
    """Shard-local occlusion through the cluster accel -> ((R,) bool,
    excess). t_max: (R,) or scalar."""
    _check_t_min(t_min)
    o_t, d_t, tiling = tile_rays(o, d, _RING_TR)
    tm_t = tiled_tmax(_per_ray(t_max, o), Ray(o=o, d=d), o_t, _RING_TR)
    cand, counts, excess = cull_clusters(accel, o_t, d_t, tm_t, k_cap)
    occ = any_hit_tiles_worklist(o_t, d_t, tm_t, accel, cand, counts)
    return untile(occ, tiling), excess


def _per_ray(t_max, o) -> torch.Tensor:
    """Scalar or (R,) t_max -> (R,) float32 on o's device."""
    if isinstance(t_max, torch.Tensor) and t_max.ndim:
        return t_max
    return torch.full(o.shape[:1], float(t_max), dtype=o.dtype, device=o.device)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

def _payload(local) -> list:
    """The tensors of a geometry block: a row block, or an accel's fields."""
    if isinstance(local, ClusterAccel):
        return [getattr(local, f.name) for f in dataclasses.fields(local)]
    return [local]


def _unpayload(local, tensors):
    if isinstance(local, ClusterAccel):
        return ClusterAccel(*tensors)
    return tensors[0]


def _start_rotation(local, group) -> tuple:
    """Post the block's transfer one step round the ring: sends to rank
    j + 1 of the group, receives from j - 1 -> (the requests, the block
    being received)."""
    g = dist.get_world_size(group)
    j = dist.get_rank(group)
    dst = dist.get_global_rank(group, (j + 1) % g)
    src = dist.get_global_rank(group, (j - 1) % g)
    send = [x.contiguous() for x in _payload(local)]
    recv = [torch.empty_like(x) for x in send]
    ops = ([dist.P2POp(dist.isend, x, dst, group) for x in send]
           + [dist.P2POp(dist.irecv, x, src, group) for x in recv])
    return dist.batch_isend_irecv(ops), _unpayload(local, recv)


def _ring_steps(local, group):
    """Yield each geometry block in ring order (the rank's own first, then
    the blocks of ranks j - 1, j - 2, ...), each next transfer posted before
    the current block is yielded and waited for after it was used."""
    g = dist.get_world_size(group)
    cur = local
    for step in range(g):
        pending = _start_rotation(cur, group) if step + 1 < g else None
        yield cur
        if pending is not None:
            reqs, cur = pending
            for r in reqs:
                r.wait()


def _ring_closest(o, d, local, local_trace, row_cols, group):
    """The ring's nearest hit: `local` (a row block or an accel) rotates,
    the rays and their running nearest hit stay -> (t_best, row_best,
    excess summed over the ring's steps, this rank's)."""
    t_best = o.new_full(o.shape[:1], T_FAR)
    row_best = o.new_zeros((o.shape[0], row_cols))
    excess = torch.zeros((), dtype=torch.int64, device=o.device)
    for cur in _ring_steps(local, group):
        t_new, row_new, exc = local_trace(o, d, cur)
        excess = excess + exc
        better = t_new < t_best
        t_best = torch.where(better, t_new, t_best)
        row_best = torch.where(better[:, None], row_new, row_best)
    return t_best, row_best, excess


def _ring_any(o, d, local, local_any, group):
    occ = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    excess = torch.zeros((), dtype=torch.int64, device=o.device)
    for cur in _ring_steps(local, group):
        occ_new, exc = local_any(o, d, cur)
        occ = occ | occ_new
        excess = excess + exc
    return occ, excess


def _rows_trace_local(o, d, rows, t_min, t_max):
    t_best, row_best = _nearest_row(_rows_hit(o, d, rows, t_min, t_max), rows)
    return t_best, row_best, 0  # brute tier: exact, no k-cap


def _rows_any_local(o, d, rows, t_min, tm):
    return (_rows_hit(o, d, rows, t_min, tm[:, None]) < T_FAR).any(-1), 0


def ring_trace_rows(o, d, rows_local, group, t_min=RAY_EPS, t_max=T_FAR):
    """Nearest hit of this rank's rays (R, 3) against every geometry shard
    of the geom group, the row blocks (T_shard, ROW_COLS) rotating ->
    (t_best (R,), row_best (R, ROW_COLS), excess)."""
    return _ring_closest(o, d, rows_local,
                         lambda o_, d_, rows: _rows_trace_local(o_, d_, rows, t_min, t_max),
                         rows_local.shape[1], group)


def ring_trace_accel(o, d, accel_local, group, t_min=RAY_EPS, t_max=T_FAR,
                     k_cap: int | None = _RING_K_CAP):
    """The ring's nearest hit with the shard-local accels rotating."""
    return _ring_closest(o, d, accel_local,
                         lambda o_, d_, a: accel_trace_rows(o_, d_, a, t_min, t_max, k_cap),
                         accel_local.shade.shape[-1], group)


def ring_any_hit(o, d, rows_local, t_max, group, t_min=RAY_EPS):
    """The ring's occlusion -> (occ (R,) bool, excess): True where some
    shard's geometry blocks the ray within (t_min, t_max). t_max: (R,) or
    scalar."""
    tm = _per_ray(t_max, o)
    return _ring_any(o, d, rows_local,
                     lambda o_, d_, rows: _rows_any_local(o_, d_, rows, t_min, tm), group)


def ring_any_hit_accel(o, d, accel_local, t_max, group, t_min=RAY_EPS,
                       k_cap: int | None = _RING_K_CAP):
    tm = _per_ray(t_max, o)
    return _ring_any(o, d, accel_local,
                     lambda o_, d_, a: accel_any_hit(o_, d_, a, tm, t_min, k_cap), group)


# ---------------------------------------------------------------------------
# The reduce
# ---------------------------------------------------------------------------

def _any_over(occ, group):
    """OR of a bool per ray over the group: an all_reduce(SUM) of int32."""
    s = occ.to(torch.int32)
    dist.all_reduce(s, group=group)
    return s > 0


def reduce_any_hit(o, d, rows_local, t_max, group, t_min=RAY_EPS):
    """Occlusion by one local pass and an OR over the shards. The rays must
    be the same on every rank of the group (replicated over geom)."""
    occ, _ = _rows_any_local(o, d, rows_local, t_min, _per_ray(t_max, o))
    return _any_over(occ, group), 0


def _reduce_merge(t_loc, row_loc, group):
    """Nearest hit over the shards: all_reduce(MIN) of t, a MIN over the
    shard index of the shards that attain it, and all_reduce(SUM) of the
    rows masked to the winner."""
    t_best = t_loc.clone()
    dist.all_reduce(t_best, op=dist.ReduceOp.MIN, group=group)
    my = dist.get_rank(group)
    eligible = t_loc <= t_best
    win = torch.where(eligible, my, _INT_MAX).to(torch.int32)
    dist.all_reduce(win, op=dist.ReduceOp.MIN, group=group)
    mask = (eligible & (win == my)).to(row_loc.dtype)
    row_best = row_loc * mask[:, None]
    dist.all_reduce(row_best, group=group)
    return t_best, row_best


def reduce_trace_rows(o, d, rows_local, group, t_min=RAY_EPS, t_max=T_FAR):
    """The barrier alternative to the ring: one local pass, then the merge."""
    t_loc, row_loc = _nearest_row(_rows_hit(o, d, rows_local, t_min, t_max), rows_local)
    t_best, row_best = _reduce_merge(t_loc, row_loc, group)
    return t_best, row_best, 0


def reduce_trace_accel(o, d, accel_local, group, t_min=RAY_EPS, t_max=T_FAR,
                       k_cap: int | None = _RING_K_CAP):
    t_loc, row_loc, excess = accel_trace_rows(o, d, accel_local, t_min, t_max, k_cap)
    t_best, row_best = _reduce_merge(t_loc, row_loc, group)
    return t_best, row_best, excess


def reduce_any_hit_accel(o, d, accel_local, t_max, group, t_min=RAY_EPS,
                         k_cap: int | None = _RING_K_CAP):
    occ, excess = accel_any_hit(o, d, accel_local, t_max, t_min, k_cap)
    return _any_over(occ, group), excess


# ---------------------------------------------------------------------------
# Shading and the render fn
# ---------------------------------------------------------------------------

def _shade_rows(lights_pos, lights_int, o, d, t, rows, occluder, cfg: WhittedConfig):
    """Shade a wavefront from its hit rows: the tiled integrator's shading
    model. `occluder(o, wi, t_max) -> (occ, excess)`. Returns (found, p, n,
    mirror, local radiance, the shadow passes' summed excess)."""
    found = (t < T_FAR) & (rows[:, 25] > 0.5)
    p = o + t[:, None] * d
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]
    if cfg.smooth_shading:
        from tracer_torch.render.tiled import mt_from_edges

        _, u, v, _ = mt_from_edges(o, d, rows[:, 0:3], e1, e2)
        uu = u[:, None]
        vv = v[:, None]
        n = normalize(rows[:, 9:12] * (1.0 - uu - vv) + rows[:, 12:15] * uu
                      + rows[:, 15:18] * vv)
    else:
        n = normalize(torch.linalg.cross(e1, e2))
    n = torch.where((n * d).sum(-1, keepdim=True) > 0, -n, n)
    albedo = rows[:, 18:21]
    emission = rows[:, 21:24]
    mirror = rows[:, 24:25]
    spec = rows[:, 26]
    shin = rows[:, 27]

    direct = torch.zeros_like(p)
    excess = 0
    for li in range(lights_pos.shape[0]):
        to_l = lights_pos[li] - p
        dist2 = (to_l * to_l).sum(-1)
        dist_ = torch.sqrt(torch.clamp_min(dist2, 1e-20))
        wi = to_l / dist_[:, None]
        cos = torch.clamp_min((n * wi).sum(-1), 0.0)
        occ, exc = occluder(p + n * RAY_EPS, wi, dist_ - 2 * RAY_EPS)
        excess = excess + exc
        vis = torch.where(occ | ~found, 0.0, 1.0)
        falloff = (vis / torch.clamp_min(dist2, 1e-20))[:, None] * lights_int[li]
        brdf = (albedo / torch.pi * cos[:, None]
                + phong_specular(d, n, wi, spec, shin)[:, None])
        direct = direct + brdf * falloff
    return found, p, n, mirror, emission + albedo * cfg.ambient + direct, excess


def make_ring_render_fn(scene: Scene, cfg, mesh, use_ring: bool = True,
                        use_accel: bool | None = None, with_aux: bool = False,
                        k_cap: int | None = _RING_K_CAP):
    """(scene, camera) -> the (H, W, 3) image on every rank, geometry split
    over "geom"; with_aux=True returns (image, {"overflow": int}), the
    overflow summed over every rank: the cull candidates the accel tier's
    k_cap dropped, 0 when the render was exact.

    Ray placement:
      * ring (use_ring=True): the H * W rays split over (data, geom)
        flattened (chunk i * geom + j on the rank at (i, j)); the geometry
        blocks rotate round the geom group past them;
      * reduce (use_ring=False): rays split over data, the same on every
        rank of a geom group; each rank traces its own shard once and the
        winners merge by all_reduce.
    H * W must divide by the number of chunks.

    Shard-local tier: use_accel=None takes the cluster accel for scenes of
    more than 8192 triangles and brute rows below; True or False forces
    it. With the accel, each rank builds its shard's accel once a frame
    and the accels rotate."""
    n_data, g = mesh.size(0), mesh.size(1)
    i, j = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(GEOM_AXIS)
    geom_group = mesh.get_group(GEOM_AXIS)
    if use_accel is None:
        use_accel = scene.num_tris > 8192
    wcfg = WhittedConfig(max_bounces=cfg.max_bounces, smooth_shading=cfg.smooth_shading)
    H, W = cfg.height, cfg.width
    n_chunks, chunk_id = (n_data * g, i * g + j) if use_ring else (n_data, i)
    if (H * W) % n_chunks:
        raise ValueError(f"{H} x {W} rays do not split into {n_chunks} equal chunks")
    chunk = H * W // n_chunks
    gather_group = None if use_ring else mesh.get_group(DATA_AXIS)

    if use_ring:
        trace = ring_trace_accel if use_accel else ring_trace_rows
        any_fn = ring_any_hit_accel if use_accel else ring_any_hit
    else:
        trace = reduce_trace_accel if use_accel else reduce_trace_rows
        any_fn = reduce_any_hit_accel if use_accel else reduce_any_hit
    kw = {"k_cap": k_cap} if use_accel else {}

    def body(o, d, local, lights_pos, lights_int):
        sky = torch.tensor(wcfg.sky_color, dtype=torch.float32, device=o.device)
        radiance = torch.zeros_like(o)
        throughput = torch.ones_like(o)
        live = torch.ones(o.shape[:1], dtype=torch.bool, device=o.device)

        def occluder(so, sd, tmax):
            return any_fn(so, sd, local, tmax, geom_group, **kw)

        excess = torch.zeros((), dtype=torch.int64, device=o.device)
        for bounce in range(wcfg.max_bounces):
            t, rows, exc = trace(o, d, local, geom_group, **kw)
            found, p, n, mirror, local_rad, sh_exc = _shade_rows(
                lights_pos, lights_int, o, d, t, rows, occluder, wcfg)
            excess = excess + exc + sh_exc
            valid = found & live
            miss = torch.where((live & ~found)[:, None], sky, 0.0)
            surf = torch.where(valid[:, None], local_rad * (1.0 - mirror), 0.0)
            radiance = radiance + throughput * (surf + miss)
            if bounce + 1 < wcfg.max_bounces:
                refl = d - 2.0 * (d * n).sum(-1, keepdim=True) * n
                o = p + n * RAY_EPS
                d = normalize(refl)
                throughput = throughput * mirror
                live = valid & (mirror[:, 0] > 0.0)
        # Every rank did distinct cull work in both modes: sum over the world.
        dist.all_reduce(excess)
        return radiance, excess

    def run(scene: Scene, camera: Camera):
        with torch.inference_mode():
            rows = pad_rows_to_shards(pack_tri_rows(scene), g)
            block = rows.shape[0] // g
            local = rows[j * block:(j + 1) * block]
            if use_accel:
                local = build_rows_accel(local)
            rays = generate_rays(camera, H, W)
            sl = slice(chunk_id * chunk, (chunk_id + 1) * chunk)
            o = rays.o.reshape(-1, 3)[sl]
            d = rays.d.reshape(-1, 3)[sl]
            radiance, excess = body(o, d, local, scene.lights.position,
                                    scene.lights.intensity)
            img = gather_rows(radiance, H * W, gather_group).reshape(H, W, 3)
        if with_aux:
            return img, {"overflow": int(excess)}
        return img

    return run
