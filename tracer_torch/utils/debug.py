"""Debug guards (torch counterpart of tracer/utils/debug.py).

The risky surfaces of a tensor program are numerical (a NaN escaping a
kernel's arithmetic) and indexing (a gather out of its dimension, which on
the card is a device assert that poisons the CUDA context). `checked` wraps
a render or step function so that both become a CheckError:

    run = make_render_fn(scene, cfg, device)
    dbg = checked(lambda s, c: run(s, c))
    img = dbg(scene, camera)   # raises CheckError on NaN / out-of-range

The reference checkifies a jitted function. Here a TorchDispatchMode sees
every ATen op the function runs: an indexing op's indices are checked
before it runs, every floating output after. The CUDA kernels launch
through ctypes, past the dispatcher, so `checked` also checks the wrapped
function's own tensor outputs. Every check reads its result back to the
host: debug runs only; production paths stay unchecked.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten


class CheckError(RuntimeError):
    """A NaN output or an out-of-range index found by `checked`."""


def _out_of_range(idx: torch.Tensor, lo: int, hi: int) -> bool:
    return idx.numel() > 0 and bool(((idx < lo) | (idx >= hi)).any())


def _dim_checks(self: torch.Tensor, dim: int, idx: torch.Tensor):
    """(index, [0, size)) of an op that indexes one dimension."""
    return [(idx, 0, self.shape[dim] if self.dim() else 1)]


def _advanced_checks(self: torch.Tensor, indices):
    """(index, [-size, size)) of each integer index tensor of x[i0, i1, ...];
    boolean masks are not positions and are left alone."""
    out = []
    for d, idx in enumerate(indices):
        if idx is not None and not idx.dtype.is_floating_point and idx.dtype not in (
                torch.bool, torch.uint8):
            out.append((idx, -self.shape[d], self.shape[d]))
    return out


# ATen op -> (args, kwargs) -> [(index tensor, lo, hi)].
_INDEX_OPS = {
    aten.index: lambda a, k: _advanced_checks(a[0], a[1]),
    aten.index_put_: lambda a, k: _advanced_checks(a[0], a[1]),
    aten.index_put: lambda a, k: _advanced_checks(a[0], a[1]),
    aten._index_put_impl_: lambda a, k: _advanced_checks(a[0], a[1]),
    aten.index_select: lambda a, k: _dim_checks(a[0], a[1], a[2]),
    aten.gather: lambda a, k: _dim_checks(a[0], a[1], a[2]),
    aten.index_add_: lambda a, k: _dim_checks(a[0], a[1], a[2]),
    aten.index_add: lambda a, k: _dim_checks(a[0], a[1], a[2]),
    aten.take: lambda a, k: [(a[1], -a[0].numel(), a[0].numel())],
}


def _nan_in(out) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel() > 0
               and bool(torch.isnan(x).any()) for x in tree_leaves(out))


class _Guard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        checks = _INDEX_OPS.get(func.overloadpacket)
        if checks is not None:
            for idx, lo, hi in checks(args, kwargs):
                if _out_of_range(idx, lo, hi):
                    raise CheckError(f"{func}: index out of [{lo}, {hi}) (min "
                                     f"{int(idx.min())}, max {int(idx.max())})")
        out = func(*args, **kwargs)
        if _nan_in(out):
            raise CheckError(f"{func}: NaN in its output")
        return out


def _leaves(out) -> list:
    """The tensors of a function's result: tensors, and tuples, lists, dicts
    and dataclasses of them, nested."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    elif not isinstance(out, (tuple, list)):
        return []
    return [t for x in out for t in _leaves(x)]


def checked(fn: Callable) -> Callable:
    """`fn` with its ATen ops guarded: an indexing op (index, index_select,
    gather, index_put_, index_add_, take) with an index outside its
    dimension, or a floating op with a NaN in its output, raises CheckError;
    so does a NaN in the tensors `fn` returns."""

    def wrapper(*args, **kwargs):
        with _Guard():
            out = fn(*args, **kwargs)
        bad = [i for i, x in enumerate(_leaves(out)) if _nan_in(x)]
        if bad:
            raise CheckError(f"NaN in the output tensors {bad} of {fn}")
        return out

    return wrapper
