"""Pinhole camera and primary-ray generation (torch counterpart of
tracer/core/camera.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tracer_torch.core.types import Ray, normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: position (3,), look_at (3,), up (3,) world-up hint,
    fov_y scalar vertical field of view in radians; float32 tensors."""

    position: torch.Tensor
    look_at: torch.Tensor
    up: torch.Tensor
    fov_y: torch.Tensor

    @staticmethod
    def make(position, look_at, up=(0.0, 1.0, 0.0), fov_y_deg=45.0, *,
             device) -> "Camera":
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        # deg2rad in float32, as jnp.deg2rad rounds it: f32(deg) * f32(pi/180).
        fov = np.float32(fov_y_deg) * np.float32(np.pi / 180)
        return Camera(position=f32(position), look_at=f32(look_at), up=f32(up),
                      fov_y=f32(fov))

    def basis(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Right-handed view basis (right, up, forward)."""
        fwd = normalize(self.look_at - self.position)
        right = normalize(torch.linalg.cross(fwd, self.up))
        up = torch.linalg.cross(right, fwd)
        return right, up, fwd


def generate_rays(camera: Camera, height: int, width: int,
                  jitter: torch.Tensor | None = None) -> Ray:
    """Primary rays for an H x W image, SoA layout (H, W, 3). Pixel (0, 0)
    is the top-left corner; without `jitter` rays pass through pixel
    centers. `jitter` is an optional (H, W, 2) sub-pixel offset in [0, 1),
    (y, x) in the last axis."""
    return generate_rays_band(camera, height, width, 0, height, jitter)


def generate_rays_band(camera: Camera, height: int, width: int, y0: int, band_h: int,
                       jitter: torch.Tensor | None = None) -> Ray:
    """Rays for the horizontal band of rows [y0, y0 + band_h) of an H x W
    image, (band_h, W, 3): the arithmetic of generate_rays restricted to
    the band, so a band's rays are bit-equal to those rows of the full
    frame's. The NDC divisors stay the full image's H and W; the row index
    y0 + i is formed in float32. `jitter` is (band_h, W, 2), (y, x)."""
    dev = camera.position.device
    right, up, fwd = camera.basis()
    aspect = width / height
    tan_half = torch.tan(camera.fov_y * 0.5)
    yy = (torch.tensor(y0, dtype=torch.float32, device=dev)
          + torch.arange(band_h, dtype=torch.float32, device=dev))[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    if jitter is None:
        jx = jy = 0.5
    else:
        jy = jitter[..., 0]
        jx = jitter[..., 1]
    ndc_x = ((xx + jx) / width * 2.0 - 1.0) * aspect * tan_half
    ndc_y = (1.0 - (yy + jy) / height * 2.0) * tan_half
    d = ndc_x[..., None] * right + ndc_y[..., None] * up + fwd.expand(band_h, width, 3)
    o = camera.position.expand(band_h, width, 3)
    return Ray(o=o, d=normalize(d))
