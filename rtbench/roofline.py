"""The least time the card could take for the traversal kernels' work, from
the candidate lists the wrappers receive: the larger of their operations
over the card's fp32 peak and their bytes over its memory rate. The counts
follow the work these inputs need, so they stay the same whatever
implements a kernel:

  * a closest-hit walk over a tile's sorted words with an early-out needs
    the words whose entry bits lie under the tile's final bound (its
    largest best t), each tested by every ray of the tile against every
    triangle of the word's cluster; the count-1 tiles' walk is their one
    word;
  * an any-hit needs, for a ray it leaves unoccluded, every word whose
    entry bits lie under the ray's own t_max, each against every triangle
    of the cluster, and one triangle test for a ray it occludes;
  * bytes: each ray's inputs once and outputs once, 4 a list item and a
    tile, and 48 C bytes (a (4, 3C) float32 matrix) a cluster touched.
"""
from __future__ import annotations

import torch

# Published peaks of one H100 SXM at its full 700 W power limit: fp32
# outside the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Arithmetic operations a (ray, triangle) test of the tri_t form, compares
# not counted: so 3 x (3 mul + 3 add), sd 3 x (3 mul + 2 add), negate,
# divide, u and v 2 x (mul + add), 1 - u - v.
FLOPS_TRI = 41
# Packed candidate words: entry-distance bits over CLUSTER_BITS of cluster id.
CLUSTER_BITS = 17
CL_MASK = (1 << CLUSTER_BITS) - 1
_TILE_CHUNK = 1024


def bound_ms(flops: float, n_tiles: int, tr: int, list_items: int, cluster_bytes: int,
             in_ray: int, out_ray: int) -> float:
    """max(operations / PEAK_FP32, bytes / PEAK_BYTES) in ms."""
    nbytes = n_tiles * tr * (in_ray + out_ray) + 4 * (list_items + n_tiles) + cluster_bytes
    return max(float(flops) / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3


def float_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _closest_region_ms(words, counts, final_bits, tr: int, c: int) -> float:
    slot = torch.arange(words.shape[1], device=words.device)[None]
    need = ((words & ~CL_MASK) < final_bits[:, None]) & (slot < counts[:, None])
    tests = int(need.sum())
    clusters = torch.unique((words & CL_MASK)[need]).numel()
    return bound_ms(tests * tr * c * FLOPS_TRI, words.shape[0], tr, tests, clusters * 48 * c,
                    32, 8)


def closest_split_ms(words, counts, bt, tr: int, c: int) -> float:
    """Bound of a closest-hit pass over count-sorted regions: the tiles with
    more than one candidate walk under their final bound (max bt), the
    count-1 tiles test their one word, the empty ones need nothing."""
    gen = counts > 1
    one = counts == 1
    ms = 0.0
    if bool(gen.any()):
        ms += _closest_region_ms(words[gen], counts[gen], float_bits(bt[gen]).amax(1), tr, c)
    if bool(one.any()):
        w1 = words[one][:, :1]
        ms += _closest_region_ms(w1, counts[one].clamp_max(1),
                                 torch.full_like(counts[one], 2**31 - 1), tr, c)
    return ms


def anyhit_ms(words, counts, occ, tmax, c: int) -> float:
    """Bound of an any-hit pass over sorted words, per ray (tiles in chunks)."""
    tests = items = 0
    clusters = []
    for a in range(0, words.shape[0], _TILE_CHUNK):
        w, n = words[a:a + _TILE_CHUNK], counts[a:a + _TILE_CHUNK]
        oc, tm = occ[a:a + _TILE_CHUNK], tmax[a:a + _TILE_CHUNK]
        slot = torch.arange(w.shape[1], device=w.device)[None]
        valid = slot < n[:, None]
        open_ray = ~oc & (tm > 1e-4)
        need = (((w & ~CL_MASK)[:, :, None] < float_bits(tm)[:, None, :])
                & valid[:, :, None] & open_ray[:, None, :])           # (tiles, K, TR)
        tests += int(need.sum()) * c + int(oc.sum())
        used = need.any(2)
        items += int(torch.maximum(used.sum(1), oc.any(1).long()).sum())
        clusters.append((w & CL_MASK)[used])
    n_cl = torch.unique(torch.cat(clusters)).numel() if clusters else 0
    return bound_ms(tests * FLOPS_TRI, words.shape[0], occ.shape[1], items, n_cl * 48 * c,
                    36, 1)
