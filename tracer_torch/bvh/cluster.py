"""Cluster acceleration structure (torch counterpart of tracer/bvh/cluster.py).

Triangles are sorted by the Morton code of their AABB centroid (stable, as
jnp.argsort is) and grouped into fixed-size clusters of C triangles. Each
cluster carries a (4, 3C) field-major intersection matrix (cols [0:C) plane,
[C:2C) bary-u, [2C:3C) bary-v; rows are the x, y, z, w coefficients of the
affine maps of core.intersect), an AABB, and the packed shade rows of its
slots. Superclusters group SUPER_FACTOR consecutive clusters under one AABB
for the two-stage cull (bvh.cull).
"""
from __future__ import annotations

import dataclasses

import torch

from tracer_torch.bvh.morton import morton3d, quantize_positions
from tracer_torch.core.intersect import triangle_affine_maps
from tracer_torch.kernels.gather import gather_rows

CLUSTER_SIZE = 128
SUPER_FACTOR = 16

# Packed per-slot shading row layout (SHADE_COLS columns, fp32):
#   0:3  v0    3:6  e1     6:9  e2      (edges: MT uv/t recompute, flat normal)
#   9:12 n0   12:15 n1    15:18 n2      (vertex shading normals)
#  18:21 albedo   21:24 emission   24 mirror   25 valid(1/0)
#  26 specular (Phong ks)   27 shininess   28:32 pad
# Rows are in sorted slot order (cluster*C + slot), so the traversal
# kernel's slot id indexes the table directly.
SHADE_COLS = 32


@dataclasses.dataclass(frozen=True)
class ClusterAccel:
    """Two-level cluster acceleration structure (SoA tensors).

    tri_w:       (Ncl, 4, 3C) f32 per-cluster intersection matrices
    tri_ids:     (Ncl, C) i32 original triangle index per slot (-1 = padding)
    cluster_lo:  (Ncl, 3) cluster AABB minima;  cluster_hi: (Ncl, 3)
    super_lo:    (Nsc, 3) supercluster AABB minima;  super_hi: (Nsc, 3)
    shade:       (Ncl*C, SHADE_COLS) packed shading rows (layout above)
    """

    tri_w: torch.Tensor
    tri_ids: torch.Tensor
    cluster_lo: torch.Tensor
    cluster_hi: torch.Tensor
    super_lo: torch.Tensor
    super_hi: torch.Tensor
    shade: torch.Tensor

    @property
    def num_clusters(self) -> int:
        return self.tri_w.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_ids.shape[1]

    def detach(self) -> "ClusterAccel":
        """The accel with every field detached from autograd: what the culls
        and the traversal kernels read, since they only select."""
        return dataclasses.replace(self, **{f.name: getattr(self, f.name).detach()
                                            for f in dataclasses.fields(self)})


def _pad_to(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def build_clusters(verts: torch.Tensor, tris: torch.Tensor,
                   cluster_size: int = CLUSTER_SIZE, scene=None) -> ClusterAccel:
    """Morton sort -> pad -> pack. `scene` (optional) supplies normals and
    materials for the shade rows; without it the rows carry geometry only."""
    C = cluster_size
    T = tris.shape[0]
    dev = verts.device
    tl = tris.long()
    v0 = verts[tl[:, 0]]
    v1 = verts[tl[:, 1]]
    v2 = verts[tl[:, 2]]
    tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
    tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
    centroid = 0.5 * (tri_lo + tri_hi)
    codes = morton3d(quantize_positions(centroid, centroid.amin(0), centroid.amax(0)))
    order = torch.argsort(codes, stable=True)

    n_cl = -(-T // C)
    n_pad = n_cl * C
    order_p = _pad_to(order, n_pad, 0)
    slot_valid = torch.arange(n_pad, device=dev) < T

    maps = triangle_affine_maps(verts, tris)[order_p]  # (n_pad, 3, 4)
    maps = torch.where(slot_valid[:, None, None], maps, torch.zeros_like(maps))
    tri_ids = torch.where(slot_valid, order_p, torch.full_like(order_p, -1))
    tri_ids = tri_ids.to(torch.int32).reshape(n_cl, C)

    # (Ncl, C, 3, 4) -> [n | au | av] along the column axis -> (Ncl, 4, 3C).
    mc = maps.reshape(n_cl, C, 3, 4)
    w = torch.cat([mc[:, :, 0, :], mc[:, :, 1, :], mc[:, :, 2, :]], dim=1)
    tri_w = w.permute(0, 2, 1).contiguous()

    inf = torch.tensor(float("inf"), device=dev)
    vmask = slot_valid[:, None]
    lo_p = torch.where(vmask, tri_lo[order_p], inf).reshape(n_cl, C, 3)
    hi_p = torch.where(vmask, tri_hi[order_p], -inf).reshape(n_cl, C, 3)
    cluster_lo = lo_p.amin(1)
    cluster_hi = hi_p.amax(1)

    n_sc = -(-n_cl // SUPER_FACTOR)
    sc_lo = _pad_to(cluster_lo, n_sc * SUPER_FACTOR, float("inf"))
    sc_hi = _pad_to(cluster_hi, n_sc * SUPER_FACTOR, float("-inf"))

    # The slots' gathers of what can carry gradients (vertices, normals,
    # materials) go through gather_rows: the same values as x[idx], and a
    # backward that sums long runs of one row (every body slot's material)
    # in parallel.
    vm = slot_valid[:, None].to(verts.dtype)
    tri_p = tl[order_p]
    pv = gather_rows(verts, tri_p)                        # (n_pad, 3 corners, 3)
    cols = [pv[:, 0] * vm, (pv[:, 1] - pv[:, 0]) * vm, (pv[:, 2] - pv[:, 0]) * vm]
    if scene is not None:
        mats = scene.materials
        mat = scene.mat_id.long()[order_p]
        pn = gather_rows(scene.normals, tri_p)
        cols += [pn[:, k] * vm for k in range(3)]
        cols += [gather_rows(mats.albedo, mat) * vm, gather_rows(mats.emission, mat) * vm,
                 gather_rows(mats.mirror, mat)[:, None] * vm]
        spec = gather_rows(mats.specular, mat)[:, None] * vm
        shin = gather_rows(mats.shininess, mat)[:, None] * vm
    else:
        spec = shin = verts.new_zeros((n_pad, 1))
        cols.append(verts.new_zeros((n_pad, 16)))
    cols += [vm, spec, shin]  # cols 25, 26, 27
    shade = torch.cat(cols, dim=1)
    shade = torch.cat([shade, verts.new_zeros((n_pad, SHADE_COLS - shade.shape[1]))], dim=1)

    return ClusterAccel(
        tri_w=tri_w,
        tri_ids=tri_ids,
        cluster_lo=cluster_lo,
        cluster_hi=cluster_hi,
        super_lo=sc_lo.reshape(n_sc, SUPER_FACTOR, 3).amin(1),
        super_hi=sc_hi.reshape(n_sc, SUPER_FACTOR, 3).amax(1),
        shade=shade,
    )


def build_scene_accel(scene, cluster_size: int = CLUSTER_SIZE) -> ClusterAccel:
    return build_clusters(scene.verts, scene.tris, cluster_size, scene=scene)
