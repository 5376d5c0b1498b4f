"""The differentiable-rendering layer (torch counterpart of tracer/diff/).

`vjp`: the brute-force nearest hit with a replayed O(R) backward. `edge`,
`edge_accel`: edge-aware visibility gradients (straight-through smoothed
indicators of shadow occlusion and primary coverage: the forward image is
the hard one, the backward pass sees silhouettes), against every triangle
or against each tile's nearest candidate clusters. `fit`: the
inverse-rendering loop with checkpoint/resume.
"""
from tracer_torch.diff.edge import (
    edge_heights,
    render_diff,
    render_diff_image,
    soft_any_hit,
    soft_coverage,
)
from tracer_torch.diff.edge_accel import (
    render_diff_accel,
    soft_any_hit_accel,
    soft_coverage_accel,
)
from tracer_torch.diff.fit import FitConfig, fit, init_params, latest_checkpoint
from tracer_torch.diff.vjp import intersect_nearest, make_replay_tracers

__all__ = [
    "render_diff",
    "render_diff_image",
    "soft_any_hit",
    "soft_coverage",
    "edge_heights",
    "render_diff_accel",
    "soft_any_hit_accel",
    "soft_coverage_accel",
    "FitConfig",
    "fit",
    "init_params",
    "latest_checkpoint",
    "intersect_nearest",
    "make_replay_tracers",
]
