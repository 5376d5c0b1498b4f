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


def generate_rays(camera: Camera, height: int, width: int) -> Ray:
    """Primary rays for an H x W image, SoA layout (H, W, 3). Pixel (0, 0)
    is the top-left corner; rays pass through pixel centers."""
    dev = camera.position.device
    right, up, fwd = camera.basis()
    aspect = width / height
    tan_half = torch.tan(camera.fov_y * 0.5)
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ndc_x = ((xx + 0.5) / width * 2.0 - 1.0) * aspect * tan_half
    ndc_y = (1.0 - (yy + 0.5) / height * 2.0) * tan_half
    d = ndc_x[..., None] * right + ndc_y[..., None] * up + fwd.expand(height, width, 3)
    o = camera.position.expand(height, width, 3)
    return Ray(o=o, d=normalize(d))
