"""All-to-all ray re-sharding between bounces (torch counterpart of
tracer/dist/ulysses.py).

Between bounces the wavefront of the ranks of one data group is re-sharded
by the Morton key of each ray's origin, so that each rank traces a
spatially coherent block: the ray-tracing analog of Ulysses-style sequence
parallelism. Within a group of n ranks, each holding R rays:

  1. each rank sorts its rays by (key, row id), a stable sort on int64 keys;
  2. splits the sorted block into n equal runs and sends run j to rank j
     (all_to_all_single): rank j then holds every rank's j-th key quantile;
  3. after the per-ray work, restore sends the results back by the same
     exchange and unsorts them by the carried row id.

The exchange is fixed-size (R/n rays to every peer). Columns of one dtype
travel together, one all_to_all_single a dtype each way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tracer_torch.bvh.morton import morton3d, quantize_positions

DEAD_KEY = (1 << 30) - 1


def _morton_key(p: torch.Tensor, lo, hi) -> torch.Tensor:
    """(R, 3) points -> (R,) 30-bit Morton keys (int64) on the [lo, hi] grid."""
    return morton3d(quantize_positions(p, lo, hi))


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Run j of x's rows (n equal runs) to rank j of the group, and back."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _exchange_columns(columns: list, group) -> list:
    """Exchange (R,) columns, those of one dtype stacked into one message."""
    out = [None] * len(columns)
    for dtype in dict.fromkeys(c.dtype for c in columns):
        idx = [i for i, c in enumerate(columns) if c.dtype == dtype]
        back = _exchange(torch.stack([columns[i] for i in idx], dim=1), group)
        for k, i in enumerate(idx):
            out[i] = back[:, k]
    return out


def reshard_by_key(key: torch.Tensor, columns: list, group=None):
    """Re-shard `columns` (each (R,)) across the ranks of `group` by sorted
    `key` ((R,) integer, below 2^31). Returns (resharded_columns,
    restore_fn), where restore_fn maps per-row result columns back to the
    caller's rows, in the caller's order."""
    n = dist.get_world_size(group)
    r = key.shape[0]
    if r % n:
        raise ValueError(f"local rows {r} not divisible by group size {n}")
    # A stable sort on the key alone is the sort on (key, row id).
    order = torch.argsort(key.to(torch.int64), stable=True)
    out = _exchange_columns([c[order] for c in columns], group)

    def restore(result_columns: list) -> list:
        """Per-row results of the re-sharded block -> the caller's rows: the
        inverse exchange (the same one), then the unsort by row id."""
        back = _exchange_columns(list(result_columns), group)
        res = []
        for b in back:
            x = torch.empty_like(b)
            x[order] = b
            res.append(x)
        return res

    return out, restore


def reshard_rays_by_position(o, d, aux_columns, lo, hi, group=None):
    """Re-shard rays (o, d (R, 3)) and flat aux columns by the Morton key of
    o, quantized to [lo, hi]. Dead rays (d == 0) key to 2^30 - 1, so they
    gather on the last rank. Returns (o2, d2, aux2, restore_fn)."""
    key = _morton_key(o, lo, hi)
    dead = (d == 0.0).all(-1)
    key = torch.where(dead, torch.full_like(key, DEAD_KEY), key)
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], *aux_columns]
    out, restore = reshard_by_key(key, cols, group)
    return torch.stack(out[0:3], -1), torch.stack(out[3:6], -1), out[6:], restore
