"""Core ray types: SoA ray batches and hit records (torch counterpart of
tracer/core/types.py)."""
from __future__ import annotations

import dataclasses

import torch

# Large t used as "infinity" for nearest-hit reductions (fp32-safe).
T_FAR = 1e30
# Epsilon used to offset secondary-ray origins off surfaces.
RAY_EPS = 1e-4


@dataclasses.dataclass(frozen=True)
class Ray:
    """A batch of rays in SoA layout: o (..., 3) origins, d (..., 3)
    directions (not necessarily unit)."""

    o: torch.Tensor
    d: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.o.shape[:-1])

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """Points o + t*d; t broadcasts against the batch shape."""
        return self.o + t[..., None] * self.d


@dataclasses.dataclass(frozen=True)
class Hit:
    """Nearest-hit record: t (...,) (T_FAR on a miss), tri (...,) int32
    triangle index (-1 on a miss), uv (..., 2) barycentrics."""

    t: torch.Tensor
    tri: torch.Tensor
    uv: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Dot product along the last axis."""
    return (a * b).sum(-1, keepdim=keepdim)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product along the last axis, the other axes broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize along the last axis."""
    return v * torch.rsqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), eps))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x at the indices idx, of any shape -> idx.shape + x.shape[1:].
    The same values as x[idx]; under autograd its backward is index_add_
    (atomic adds on CUDA) where x[idx]'s is a sort of the indices, which
    serialises on repeated ones."""
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *x.shape[1:])
