from tracer_torch.core.camera import Camera, generate_rays, generate_rays_band
from tracer_torch.core.intersect import (
    intersect_brute, intersect_packed, moller_trumbore, triangle_affine_maps)
from tracer_torch.core.types import Hit, Ray

__all__ = [
    "Ray", "Hit", "Camera", "generate_rays", "generate_rays_band", "moller_trumbore",
    "triangle_affine_maps", "intersect_packed", "intersect_brute",
]
