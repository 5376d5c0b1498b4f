"""Row gathers whose backward is a deterministic segmented row sum
(csrc/gather.cu), for the sources that carry gradients.

`gather_rows(src, idx)` is src[idx.clamp_min(0)]: a negative index reads
row 0. Where grad is enabled and src requires grad it goes through
`GatherRows`, whose forward is index_select (the same bits as src[idx]) and
whose backward sums the gradient rows of each source row:
  * a plain version, rows_sum_plain: zeros(n_rows, w).index_add_;
  * a wrapper, rows_sum: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors, or it raises;
  * a launch counter, LAUNCHES["rows_sum"] (kernels/_launch.py);
  * a span "grad.rows_sum" around each backward and a counter
    "rows_summed" of the entries summed (utils/metrics.py).
Everywhere else it is the plain src[idx]. The backward this replaces,
ATen's index_put_ with accumulate, walks all repeats of one index in one
warp, one after another; this one cuts the sorted entries into chunks of
CHUNK (see the .cu).
"""
from __future__ import annotations

import math

import torch

from tracer_torch.kernels._launch import check_dense, launch
from tracer_torch.utils.metrics import count, span

# Entries a warp sums (kChunk of csrc/gather.cu); each level of partial sums
# has 2 slots for every chunk of the level below.
CHUNK = 128
# The widest rows the kernel takes (one lane a column).
MAX_WIDTH = 32


def rows_sum_plain(g: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """out[r] = the sum of the rows g[i] with idx[i] == r: g (N, w), idx (N,)
    int64 in [0, n_rows) -> (n_rows, w)."""
    return g.new_zeros((n_rows, g.shape[1])).index_add_(0, idx, g)


def slot_counts(n: int) -> tuple[int, int]:
    """The partial slots of the kernel's odd and even levels for n entries:
    2 per chunk of the first level, and 2 per chunk of those."""
    a = 2 * -(-n // CHUNK)
    return a, 2 * -(-a // CHUNK)


def rows_sum(g: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """rows_sum_plain on CPU tensors; the CUDA kernel rows_sum on CUDA
    tensors: the same sums, each in one fixed order (the same bits on every
    run)."""
    if g.device.type == "cpu":
        return rows_sum_plain(g, idx, n_rows)
    check_dense(g.device, (g, torch.float32), (idx, torch.int64))
    n, w = g.shape
    if idx.shape != (n,) or not 0 < w <= MAX_WIDTH:
        raise ValueError(f"rows_sum takes g (N, w <= {MAX_WIDTH}) and idx (N,), got "
                         f"{tuple(g.shape)} and {tuple(idx.shape)}")
    out = g.new_zeros((n_rows, w))
    if n:
        keys, perm = torch.sort(idx, stable=True)
        a, b = slot_counts(n)
        pk = torch.empty(a + b, dtype=torch.int64, device=g.device)
        pv = torch.empty((a + b, w), dtype=torch.float32, device=g.device)
        launch("rows_sum", "gr_rows_sum", g.device, keys, perm, g, n, w, out, pk, pv,
               pk[a:], pv[a:])
    return out


class GatherRows(torch.autograd.Function):
    """src.index_select(0, idx) for idx (N,) int64 >= 0, with rows_sum as
    its backward."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.src_shape = src.shape
        return src.index_select(0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        shape = ctx.src_shape
        with span("grad.rows_sum"):
            out = rows_sum(g.reshape(idx.shape[0], math.prod(shape[1:])).contiguous(), idx,
                           shape[0])
        count("rows_summed", idx.shape[0])
        return out.reshape(shape), None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx.clamp_min(0)] -> idx.shape + src.shape[1:]; through
    GatherRows where grad is enabled and src requires grad."""
    idx = idx.clamp_min(0)
    if not (torch.is_grad_enabled() and src.requires_grad):
        return src[idx]
    return GatherRows.apply(src, idx.reshape(-1).long()).reshape(*idx.shape, *src.shape[1:])
