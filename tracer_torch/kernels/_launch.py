"""What every kernel wrapper of kernels/ shares: the launch counters, the
argument check, the segmented kernels' table of segments and the one place
a C entry point of the built library is called."""
from __future__ import annotations

import functools

import torch

# Kernel launches per wrapper, raised by one where a wrapper launches its
# kernel and nowhere else (callers that count a run set them to 0 first).
LAUNCHES = {"closest": 0, "closest_fast": 0, "anyhit": 0,              # traversal2.cu
            "closest_stream": 0, "anyhit_stream": 0,                   # stream.cu
            "worklist_closest": 0, "worklist_anyhit": 0,               # traversal.cu
            "pair_closest": 0, "pair_anyhit": 0}                       # traversal3.cu


def check_dense(dev, *pairs):
    """Raise unless every (tensor, dtype) is a contiguous tensor of that
    dtype on the CUDA device `dev`."""
    if dev.type != "cuda":
        raise RuntimeError(f"traversal kernels run on CUDA or CPU tensors, got {dev}")
    for x, dt in pairs:
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"expected a contiguous {dt} tensor on {dev}, got "
                             f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")


def check_rays(o4, d4, w):
    """Raise unless o4/d4 are (Nt, TR, 4) tiles a block can take (TR a
    multiple of 32 up to 1024) and w is (Ncl, 4, 3C)."""
    if o4.ndim != 3 or o4.shape[2] != 4 or d4.shape != o4.shape:
        raise ValueError(f"o4/d4 must be (Nt, TR, 4), got {tuple(o4.shape)}, {tuple(d4.shape)}")
    tr = o4.shape[1]
    if tr % 32 or not 0 < tr <= 1024:
        raise ValueError(f"tile of {tr} rays: the kernels take a multiple of 32 up to 1024")
    if w.ndim != 3 or w.shape[1] != 4 or w.shape[2] % 3:
        raise ValueError(f"w must be (Ncl, 4, 3C), got {tuple(w.shape)}")


def run_segments(counts, seg: int, k_cap: int):
    """The segmented kernels' work list: every tile's run of candidates cut
    into segments of `seg` items. counts (Nt,) i32, none above k_cap (the
    width of the candidate lists, known on the host, so nothing here waits
    for the device) -> (order (Nt,) i64, ends (R,) i32) with R =
    ceil(k_cap / seg) ranks. order holds the tiles by descending count
    (stable), ends[r] the number of segments of the ranks 0 .. r. Order of
    the segments: every tile's first one (rank 0), then every second one,
    and so on (in a sorted list the front-most clusters occlude the most
    rays, so a later segment finds more of its rays already occluded);
    within a rank the heaviest tile first. The tiles of a rank are a prefix
    of `order`, so segment s with ends[r-1] <= s < ends[r] (ends[-1] read as
    0) is the items r*seg .. min((r+1)*seg, counts[tile]) - 1 of tile
    order[s - ends[r-1]], and ends[R-1] is the number of segments."""
    sorted_counts, order = torch.sort(counts, descending=True, stable=True)
    k0 = torch.arange(0, k_cap, seg, dtype=counts.dtype, device=counts.device)
    per_rank = torch.searchsorted(-sorted_counts, -k0)      # tiles with count > k0
    return order, per_rank.cumsum(0, dtype=torch.int32)


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(name: str, entry: str, dev, *args):
    """One launch of the C entry point `entry` (tensors passed by pointer)
    on the device's current stream; raises on a launch error."""
    from tracer_torch.kernels import _build

    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(_build.load(), entry)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {rc}")
    LAUNCHES[name] += 1
