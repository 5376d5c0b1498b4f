"""tracer_torch — the PyTorch/CUDA port of `tracer`, for NVIDIA Hopper.

The package mirrors `tracer/`'s layout and names (tracer_torch/core/camera.py
is the counterpart of tracer/core/camera.py, and so on). It holds the
forward renderer: procedural scenes, the cluster accel build, the frustum
culls, the traversal kernels of every tier (hand-written CUDA in
kernels/csrc/, each beside a plain PyTorch version of the same function),
the tiled and wavefront Whitted integrators and the api's render fns; the
grad step (api.make_grad_step_fn); and the differentiable tiers and the
inverse-rendering loop of diff/: the brute-force nearest hit with a
replayed backward (diff/vjp.py), the edge-aware silhouette gradients
against every triangle and against each tile's nearest clusters
(diff/edge.py, diff/edge_accel.py), and the fit with checkpoint/resume
(diff/fit.py), which bin/fit_torch runs; bin/trace_torch renders to PNG
and bin/bench_torch prints the benchmark line. Beside them: OBJ scenes
(scene/io.py, with the native parser of cpp/objloader.cpp), the LBVH tier
(bvh/lbvh.py), the debug guard (utils/debug.py) and the port's own
bindings to the oracles it is held to (refcpu/: the fp64 C++ renderer of
cpp/oracle.cpp and a numpy copy of the reference's oracle). dist/ spreads
frames and grad steps over ranks with torch.distributed (NCCL on cards,
gloo on the CPU): tile data parallelism, the all-to-all re-shard of bounce
wavefronts, the overlapped bucketed grad all-reduce, sharded geometry (ring
and reduce) and the scaling sweep.

It imports torch and numpy only. Every entry point takes an explicit
`device`, or the device of the tensors it is given; on CPU tensors each
kernel wrapper runs its plain version, on CUDA tensors it launches the
kernel.
"""

__version__ = "0.1.0"

# Names of the reference's top level, imported at first use.
_LAZY = {"render": "tracer_torch.api", "grad_step": "tracer_torch.api",
         "benchmark": "tracer_torch.api", "Ray": "tracer_torch.core.types",
         "Hit": "tracer_torch.core.types", "Camera": "tracer_torch.core.camera",
         "generate_rays": "tracer_torch.core.camera",
         "moller_trumbore": "tracer_torch.core.intersect",
         "triangle_affine_maps": "tracer_torch.core.intersect",
         "intersect_packed": "tracer_torch.core.intersect",
         "intersect_brute": "tracer_torch.core.intersect"}
__all__ = [*_LAZY, "dist"]


def __getattr__(name):
    if name == "dist":
        import importlib

        return importlib.import_module("tracer_torch.dist")
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(_LAZY[name]), name)
