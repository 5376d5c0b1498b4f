"""Distribution over torch.distributed (torch counterpart of tracer/dist/):
the render mesh (mesh.py), tile data parallelism (ray_dp.py), the
all-to-all re-shard of bounce wavefronts (ulysses.py), the overlapped
bucketed grad all-reduce (grad_overlap.py), sharded geometry (ring.py) and
the scaling sweep (scaling.py). SPMD, one process a rank: NCCL for CUDA
tensors, gloo for CPU tensors."""
from tracer_torch.dist.mesh import DATA_AXIS, GEOM_AXIS, init_multihost, make_render_mesh
from tracer_torch.dist.ray_dp import make_sharded_grad_fn, make_sharded_render_fn, shard_rays

__all__ = [
    "make_render_mesh", "init_multihost", "DATA_AXIS", "GEOM_AXIS",
    "make_sharded_render_fn", "make_sharded_grad_fn", "shard_rays",
]
