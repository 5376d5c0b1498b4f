"""Morton (Z-order) codes (torch counterpart of tracer/bvh/morton.py).

The reference works in uint32; torch's uint32 lacks arithmetic, so the codes
are computed in int64 and masked back to 32 bits after every multiply, which
gives the same wrapped products."""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value out to every 3rd bit."""
    v = v.to(torch.int64) & _U32
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(q: torch.Tensor) -> torch.Tensor:
    """(N, 3) integer coords in [0, 1024) -> (N,) 30-bit codes (int64)."""
    x = expand_bits_10(q[..., 0])
    y = expand_bits_10(q[..., 1])
    z = expand_bits_10(q[..., 2])
    return ((x << 2) | (y << 1) | z) & _U32


def quantize_positions(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Normalize points into the scene AABB and quantize to a 10-bit grid."""
    extent = torch.clamp_min(hi - lo, 1e-12)
    u = (p - lo) / extent
    return torch.clamp(u * 1024.0, 0.0, 1023.0).to(torch.int64)


def morton_decode3d(code: torch.Tensor) -> torch.Tensor:
    """Inverse of morton3d: (N,) codes -> (N, 3) coords (int64)."""
    def compact(v):
        v = v.to(torch.int64) & 0x49249249
        v = (v | (v >> 2)) & 0xC30C30C3
        v = (v | (v >> 4)) & 0x0F00F00F
        v = (v | (v >> 8)) & 0xFF0000FF
        v = (v | (v >> 16)) & 0x000003FF
        return v

    code = code.to(torch.int64) & _U32
    return torch.stack([compact(code >> 2), compact(code >> 1), compact(code)], dim=-1)
