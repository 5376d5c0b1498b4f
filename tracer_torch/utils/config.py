"""Render configurations (torch counterpart of tracer/utils/config.py:
the same preset names and fields)."""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """One fully-specified render/benchmark configuration.

    `use_bvh` and `use_pallas` pick the tracer tier, as in the JAX
    package. With both set, api.make_render_fn renders through the tiled
    tier (render/tiled.py) when the scene has at most
    api.TILED_MAX_CLUSTERS clusters and through the streamed tier
    (kernels/stream.py) when it has more. Every other config renders
    through the wavefront integrator over api.build_tracers: brute force
    without `use_bvh`, the plain cluster tier (kernels/traversal.py) with
    `use_bvh` alone. The port renders in float32 and has no profile
    option: api.make_render_fn raises on any other `dtype` and on
    `profile=True`."""

    scene: str = "cornell"          # cornell | bunny | hall | bench | soup
    height: int = 256
    width: int = 256
    max_bounces: int = 1
    smooth_shading: bool = True
    use_bvh: bool = False
    use_pallas: bool = False
    scene_arg: int = 0              # scene-specific size knob (e.g. subdiv)
    dtype: str = "float32"
    profile: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


PRESETS: dict[str, RenderConfig] = {
    "cornell256": RenderConfig(scene="cornell", height=256, width=256, max_bounces=1,
                               smooth_shading=False, use_bvh=False),
    "bunny512": RenderConfig(scene="bunny", height=512, width=512, max_bounces=1,
                             scene_arg=6, use_bvh=True, use_pallas=True),
    "bunny-grad": RenderConfig(scene="bunny", height=128, width=128, max_bounces=1,
                               scene_arg=3, use_bvh=True),
    "sponza1080": RenderConfig(scene="hall", height=1080, width=1920, max_bounces=3,
                               use_bvh=True, use_pallas=True),
    "pod-1m": RenderConfig(scene="hall", height=1080, width=1920, max_bounces=2,
                           scene_arg=1, use_bvh=True, use_pallas=True),
    # Headline bench config: ~100k-tri scene at 1080p.
    "bench100k": RenderConfig(scene="bench", height=1080, width=1920, max_bounces=1,
                              use_bvh=True, use_pallas=True),
}


def load_config(source: str | dict | None = None, **overrides: Any) -> RenderConfig:
    """Resolve a config from a preset name, JSON path, or dict + overrides."""
    if source is None:
        cfg = RenderConfig()
    elif isinstance(source, dict):
        cfg = RenderConfig(**source)
    elif source in PRESETS:
        cfg = PRESETS[source]
    elif source.endswith(".json"):
        with open(source) as f:
            cfg = RenderConfig(**json.load(f))
    else:
        raise ValueError(f"unknown config '{source}' (presets: {sorted(PRESETS)})")
    return cfg.replace(**overrides) if overrides else cfg
