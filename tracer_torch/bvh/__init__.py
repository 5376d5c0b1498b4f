from tracer_torch.bvh.cluster import CLUSTER_SIZE, ClusterAccel, build_clusters, build_scene_accel
from tracer_torch.bvh.cull import cull_clusters, frustum_aabb_feasible, tile_bounds
from tracer_torch.bvh.lbvh import (
    FlatBVH, any_hit_lbvh, build_lbvh, make_lbvh_tracers, trace_rays_lbvh)
from tracer_torch.bvh.morton import morton3d, morton_decode3d, quantize_positions

__all__ = [
    "ClusterAccel", "build_clusters", "build_scene_accel", "CLUSTER_SIZE",
    "cull_clusters", "frustum_aabb_feasible", "tile_bounds",
    "morton3d", "morton_decode3d", "quantize_positions",
    "FlatBVH", "build_lbvh", "trace_rays_lbvh", "any_hit_lbvh", "make_lbvh_tracers",
]
