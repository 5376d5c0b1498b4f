"""Whitted light transport settings and the Phong lobe (torch counterpart of
tracer/render/whitted.py:69-133)."""
from __future__ import annotations

import dataclasses

import torch


def phong_specular(d, n, wi, spec, shin):
    """Classic Phong lobe: ks * max(0, R . wi)^shininess with R the view
    ray's mirror direction about the shading normal; (...,) weight. ks == 0
    contributes exactly zero (0^n is masked)."""
    r = d - 2.0 * (d * n).sum(-1, keepdim=True) * n
    cos_r = torch.clamp_min((r * wi).sum(-1), 0.0)
    on = spec > 0.0
    base = torch.where(cos_r > 0.0, cos_r, 1.0)
    lobe = torch.where((cos_r > 0.0) & on, base ** shin, 0.0)
    return spec * lobe


@dataclasses.dataclass(frozen=True)
class WhittedConfig:
    max_bounces: int = 1  # 1 = primary rays only
    smooth_shading: bool = True
    sky_color: tuple = (0.0, 0.0, 0.0)
    ambient: float = 0.04
