"""Karras-style LBVH: the build and a batched stack traversal in torch ops
(torch counterpart of tracer/bvh/lbvh.py, which is XLA code, not Pallas).

  1. triangle AABBs -> 30-bit Morton codes of their centroids (bvh.morton);
  2. a stable argsort orders the leaves;
  3. Karras 2012 internal-node topology: each of the N-1 internal nodes
     finds its key range and split with fixed-trip searches, all nodes at
     once as whole-array ops;
  4. a bottom-up AABB fit as a fixed number of gather rounds.

Node indexing: one array of 2N-1 nodes, internal nodes in [0, N-1), leaf k
(k-th in Morton order) at (N-1)+k, holding original triangle leaf_tri[k].
Codes and deltas are computed in int64 (the reference's uint32 codes fit);
the count of leading zeros comes from the exponent of torch.frexp of the
float64 value, which holds every 32-bit integer exactly.

The traversal runs the reference's while-loop eagerly: every lane does one
step an iteration (a leaf test, or a slab test of both children), inactive
lanes do nothing, and whether any lane is active is read back every
CHECK_EVERY iterations.
"""
from __future__ import annotations

import dataclasses

import torch

from tracer_torch.bvh.morton import morton3d, quantize_positions
from tracer_torch.core.intersect import moller_trumbore
from tracer_torch.core.types import T_FAR, Hit, Ray

STACK_DEPTH = 64  # >= the radix tree's depth for 30-bit codes + the index tiebreak
CHECK_EVERY = 16


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Flattened LBVH, SoA.

    node_lo/node_hi: (2N-1, 3) AABBs of all nodes (internal, then leaves)
    left/right:      (N-1,) int32 child node indices (unified indexing)
    leaf_tri:        (N,) int32 original triangle id of each leaf, in Morton order
    """

    node_lo: torch.Tensor
    node_hi: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    leaf_tri: torch.Tensor

    @property
    def num_leaves(self) -> int:
        return self.leaf_tri.shape[0]

    @property
    def num_internal(self) -> int:
        return self.left.shape[0]


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64: 32 - bit length, the
    bit length being frexp's exponent of the exact float64 value (0 -> 32)."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def _make_delta(codes: torch.Tensor, n: int):
    """delta(i, j): common-prefix length of keys i and j; -1 if j out of
    range. Equal codes are split by index (key = code ++ index)."""

    def delta(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        valid = (j >= 0) & (j < n)
        jj = j.clamp(0, n - 1)
        x = codes[i] ^ codes[jj]
        tie = 32 + _clz32(i ^ jj)
        d = torch.where(x == 0, tie, _clz32(x))
        return torch.where(valid, d, -1)

    return delta


def _karras_topology(codes: torch.Tensor):
    """Sorted codes (N,) -> (left, right) int32 children of the N-1
    internal nodes (unified indexing: leaf k -> (N-1)+k)."""
    n = codes.shape[0]
    ni = n - 1
    delta = _make_delta(codes, n)
    i = torch.arange(ni, dtype=torch.int64, device=codes.device)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d)

    # Upper bound on the range length by doubling (32 trips cover N < 2^31).
    lmax = torch.full_like(i, 2)
    for _ in range(32):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)

    # Binary search for the other end j = i + l*d.
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(32):
        take = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(take, l + t, l)
        t = t // 2
    j = i + l * d

    # Binary search for the split gamma in [min(i, j), max(i, j)).
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = l
    done = l == 0
    for _ in range(34):
        t = torch.where(done, t, (t + 1) // 2)
        take = ~done & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(take, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + torch.clamp_max(d, 0)

    left = torch.where(torch.minimum(i, j) == gamma, gamma + ni, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, gamma + 1 + ni, gamma + 1)
    return left.to(torch.int32), right.to(torch.int32)


@torch.no_grad()
def build_lbvh(verts: torch.Tensor, tris: torch.Tensor) -> FlatBVH:
    """The LBVH of (verts, tris), on their device. AABBs and topology are
    discrete (no gradient)."""
    n = tris.shape[0]
    tl = tris.long()
    v0, v1, v2 = (verts[tl[:, k]] for k in range(3))
    tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
    tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
    centroid = 0.5 * (tri_lo + tri_hi)
    codes = morton3d(quantize_positions(centroid, centroid.amin(0), centroid.amax(0)))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    leaf_tri = order.to(torch.int32)

    if n == 1:
        # One leaf and no internal node.
        empty = torch.zeros((0,), dtype=torch.int32, device=verts.device)
        return FlatBVH(node_lo=tri_lo, node_hi=tri_hi, left=empty, right=empty.clone(),
                       leaf_tri=leaf_tri)

    left, right = _karras_topology(codes)
    ni = n - 1
    lc, rc = left.long(), right.long()
    # Bottom-up fit: leaves are exact; internal boxes converge within the
    # tree's depth of gather rounds.
    lo = torch.cat([tri_lo.new_full((ni, 3), float("inf")), tri_lo[order]])
    hi = torch.cat([tri_hi.new_full((ni, 3), float("-inf")), tri_hi[order]])
    rounds = min(STACK_DEPTH, max(2 * int(n).bit_length() + 2, 8))
    for _ in range(rounds):
        lo = torch.cat([torch.minimum(lo[lc], lo[rc]), lo[ni:]])
        hi = torch.cat([torch.maximum(hi[lc], hi[rc]), hi[ni:]])
    return FlatBVH(node_lo=lo, node_hi=hi, left=left, right=right, leaf_tri=leaf_tri)


def _slab_test(o, inv_d, lo, hi, t_min, t_max):
    """Ray vs AABB slab test -> (hit, t_enter)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    enter = torch.clamp_min(tn, t_min)
    exit_ = torch.minimum(tf, t_max)
    return enter <= exit_, enter


@torch.no_grad()
def _traverse(o, dvec, t_min, t_max0, bvh: FlatBVH, verts, tris, any_hit: bool,
              stats: dict | None = None):
    """The batched stack traversal of o, dvec (R, 3) -> (t, tri, u, v,
    occluded). In any_hit mode only `occluded` means anything, and a lane
    stops at its first hit. `stats`, where given, gains "iterations" (run)
    and "needed" (those with an active lane: the reference's trip count)."""
    r, dev = o.shape[0], o.device
    n, ni = bvh.num_leaves, bvh.num_internal
    inv_d = 1.0 / torch.where(dvec.abs() > 1e-20, dvec, 1e-20)
    if isinstance(t_max0, torch.Tensor) and t_max0.ndim > 0:
        best_t = t_max0.reshape(r).to(torch.float32).clone()
    else:
        best_t = torch.full((r,), float(t_max0), dtype=torch.float32, device=dev)
    tris = tris.long()
    leaf_tri = bvh.leaf_tri.long()
    left, right = bvh.left.long(), bvh.right.long()
    lanes = torch.arange(r, device=dev)

    node = torch.zeros((r,), dtype=torch.int64, device=dev)  # the root (the leaf if N = 1)
    stack = torch.zeros((r, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    active = (dvec != 0.0).any(-1)
    occ = torch.zeros((r,), dtype=torch.bool, device=dev)
    needed = torch.zeros((), dtype=torch.int64, device=dev)
    iterations = 0

    while bool(active.any()):
        for _ in range(CHECK_EVERY):
            needed += active.any()
            iterations += 1
            is_leaf = node >= ni
            # Leaf lanes: one Moller-Trumbore test. Strictly closer wins;
            # an equal t goes to the lower triangle id, as in brute force.
            tid = leaf_tri[(node - ni).clamp(0, n - 1)]
            tv = tris[tid]
            t, u, v, hit = moller_trumbore(o, dvec, verts[tv[:, 0]], verts[tv[:, 1]],
                                           verts[tv[:, 2]], t_min=t_min, t_max=T_FAR)
            closer = (t < best_t) | ((t == best_t) & ((best_tri < 0) | (tid < best_tri)))
            hit = hit & is_leaf & active & closer
            best_t = torch.where(hit, t, best_t)
            best_tri = torch.where(hit, tid, best_tri)
            best_u = torch.where(hit, u, best_u)
            best_v = torch.where(hit, v, best_v)
            if any_hit:
                occ = occ | hit

            # Internal lanes: slab-test both children, near one first.
            if ni:
                node_i = node.clamp(0, ni - 1)
                lc, rc = left[node_i], right[node_i]
            else:
                lc = rc = torch.zeros_like(node)
            hl, tl = _slab_test(o, inv_d, bvh.node_lo[lc], bvh.node_hi[lc], t_min, best_t)
            hr, tr_ = _slab_test(o, inv_d, bvh.node_lo[rc], bvh.node_hi[rc], t_min, best_t)
            swap = hr & (~hl | (tr_ < tl))
            near = torch.where(swap, rc, lc)
            far = torch.where(swap, lc, rc)

            # Pops read the stack as it stood before this iteration's pushes
            # (a lane never does both).
            descend = active & ~is_leaf & (hl | hr)
            push = descend & hl & hr
            slot = sp.clamp(0, STACK_DEPTH - 1)
            sp = torch.where(push, sp + 1, sp)
            need_pop = active & ~descend
            can_pop = need_pop & (sp > 0)
            if any_hit:
                can_pop = can_pop & ~occ
            sp = torch.where(can_pop, sp - 1, sp)
            popped = stack[lanes, sp.clamp(0, STACK_DEPTH - 1)].long()
            stack[lanes, slot] = torch.where(push, far.to(torch.int32), stack[lanes, slot])
            node = torch.where(descend, near, torch.where(can_pop, popped, node))
            active = active & ~(need_pop & ~can_pop)
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + iterations
        stats["needed"] = stats.get("needed", 0) + int(needed)
    return best_t, best_tri.to(torch.int32), best_u, best_v, occ


def trace_rays_lbvh(ray: Ray, bvh: FlatBVH, verts, tris, t_min: float = 1e-4,
                    stats: dict | None = None) -> Hit:
    """Closest hit over the LBVH for a ray batch of any shape."""
    shape = ray.batch_shape
    t, tri, u, v, _ = _traverse(ray.o.reshape(-1, 3), ray.d.reshape(-1, 3), t_min, T_FAR, bvh,
                                verts, tris, any_hit=False, stats=stats)
    valid = tri >= 0
    t = torch.where(valid, t, T_FAR)
    uv = torch.where(valid[:, None], torch.stack([u, v], dim=-1), 0.0)
    return Hit(t=t.reshape(shape), tri=tri.reshape(shape), uv=uv.reshape(shape + (2,)))


def any_hit_lbvh(ray: Ray, t_max, bvh: FlatBVH, verts, tris, t_min: float = 1e-4,
                 stats: dict | None = None) -> torch.Tensor:
    """Occlusion over the LBVH; t_max a scalar or per-ray."""
    shape = ray.batch_shape
    if isinstance(t_max, torch.Tensor) and t_max.ndim > 0:
        t_max = t_max.reshape(-1)
    *_, occ = _traverse(ray.o.reshape(-1, 3), ray.d.reshape(-1, 3), t_min, t_max, bvh, verts,
                        tris, any_hit=True, stats=stats)
    return occ.reshape(shape)


def make_lbvh_tracers(scene, t_min: float = 1e-4, stats: dict | None = None):
    """(trace_fn, occlude_fn) over an LBVH built here: the render_wavefront
    tracer interface (render.whitted). `stats`, where given, gains the
    traversals' iteration counts (see _traverse)."""
    bvh = build_lbvh(scene.verts, scene.tris)

    def trace_fn(ray: Ray) -> Hit:
        return trace_rays_lbvh(ray, bvh, scene.verts, scene.tris, t_min, stats)

    def occlude_fn(ray: Ray, t_max) -> torch.Tensor:
        return any_hit_lbvh(ray, t_max, bvh, scene.verts, scene.tris, t_min, stats)

    return trace_fn, occlude_fn
