"""Ray tiling helpers (torch counterpart of tracer/kernels/traversal.py:41-137).

Rays are grouped into coherent tiles of TR rays: 2D (H, W) batches whose
sides divide by sqrt(TR) are tiled spatially (8x8 pixels at TR=64), other
batches are chunked in order, with padding rays of d = 0 that never hit."""
from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_torch.core.types import normalize

DEFAULT_TILE = 256
T_MIN = 1e-4


class Tiling(NamedTuple):
    batch_shape: tuple
    n_rays: int
    tile_hw: tuple | None  # (th, tw, H, W) when image-tiled


def tile_rays(o: torch.Tensor, d: torch.Tensor, tr: int = DEFAULT_TILE):
    """(..., 3) rays -> (Ntiles, TR, 3) o and d + tiling info."""
    batch_shape = tuple(o.shape[:-1])
    if len(batch_shape) == 2:
        H, W = batch_shape
        th = tw = int(tr ** 0.5)
        if th * tw == tr and H % th == 0 and W % tw == 0:
            def fold(x):
                f = x.reshape(H // th, th, W // tw, tw, 3)
                return f.permute(0, 2, 1, 3, 4).reshape(-1, tr, 3)

            return fold(o), fold(d), Tiling(batch_shape, H * W, (th, tw, H, W))
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = o.shape[0]
    n_pad = -(-n // tr) * tr
    if n_pad != n:
        o = torch.cat([o, o.new_zeros((n_pad - n, 3))])
        d = torch.cat([d, d.new_zeros((n_pad - n, 3))])
    return o.reshape(-1, tr, 3), d.reshape(-1, tr, 3), Tiling(batch_shape, n, None)


def generate_rays_tiled(camera, height: int, width: int, tr: int):
    """Primary rays generated directly in the (Ntiles, TR, 3) tiled layout:
    the same arithmetic as generate_rays + tile_rays, with the spatial fold
    done by index math. Falls back to exactly that pair when sqrt(TR) does
    not divide both image sides."""
    th = tw = int(tr ** 0.5)
    if th * tw != tr or height % th or width % tw:
        from tracer_torch.core.camera import generate_rays

        rays = generate_rays(camera, height, width)
        return tile_rays(rays.o, rays.d, tr)
    dev = camera.position.device
    ntx = width // tw
    tiles = torch.arange((height // th) * ntx, dtype=torch.int32, device=dev)[:, None]
    slot = torch.arange(tr, dtype=torch.int32, device=dev)[None, :]
    yy = (torch.div(tiles, ntx, rounding_mode="floor") * th
          + torch.div(slot, tw, rounding_mode="floor")).to(torch.float32)
    xx = ((tiles % ntx) * tw + slot % tw).to(torch.float32)
    right, up, fwd = camera.basis()
    aspect = width / height
    tan_half = torch.tan(camera.fov_y * 0.5)
    ndc_x = ((xx + 0.5) / width * 2.0 - 1.0) * aspect * tan_half
    ndc_y = (1.0 - (yy + 0.5) / height * 2.0) * tan_half
    d = ndc_x[..., None] * right + ndc_y[..., None] * up + fwd.expand(*ndc_x.shape, 3)
    o = camera.position.expand(d.shape)
    return o, normalize(d), Tiling((height, width), height * width,
                                   (th, tw, height, width))


def untile(x: torch.Tensor, tiling: Tiling) -> torch.Tensor:
    """(Ntiles, TR, ...) -> the original batch shape."""
    tail = tuple(x.shape[2:])
    if tiling.tile_hw is not None:
        th, tw, H, W = tiling.tile_hw
        x = x.reshape(H // th, W // tw, th, tw, *tail)
        perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
        return x.permute(perm).reshape(H, W, *tail)
    x = x.reshape(-1, *tail)[: tiling.n_rays]
    return x.reshape(*tiling.batch_shape, *tail)


def _homog(o: torch.Tensor, d: torch.Tensor):
    """(..., 3) rays -> (o4, d4) = ([o, 1], [d, 0]), contiguous."""
    ones = o.new_ones(o.shape[:-1] + (1,))
    return torch.cat([o, ones], dim=-1), torch.cat([d, torch.zeros_like(ones)], dim=-1)
