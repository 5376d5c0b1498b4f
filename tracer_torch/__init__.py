"""tracer_torch — the PyTorch/CUDA port of `tracer`, for NVIDIA Hopper.

The package mirrors `tracer/`'s layout and names (tracer_torch/core/camera.py
is the counterpart of tracer/core/camera.py, and so on) and holds the slice
that renders the bench100k Whitted frame: procedural scenes, the cluster
accel build, the two-stage frustum cull, the closest-hit and any-hit
traversal kernels (hand-written CUDA in kernels/csrc/traversal2.cu, each
beside a plain PyTorch version of the same function) and the tiled Whitted
integrator.

It imports torch and numpy only. Every entry point takes an explicit
`device`; on CPU tensors each kernel wrapper runs its plain version, on CUDA
tensors it launches the kernel.
"""

__version__ = "0.1.0"
