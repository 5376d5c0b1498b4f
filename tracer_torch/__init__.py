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
(diff/fit.py), which bin/fit_torch runs; bin/trace_torch renders to PNG.

It imports torch and numpy only. Every entry point takes an explicit
`device`, or the device of the tensors it is given; on CPU tensors each
kernel wrapper runs its plain version, on CUDA tensors it launches the
kernel.
"""

__version__ = "0.1.0"
