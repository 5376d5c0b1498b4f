"""kernels/gather.py: gather_rows' forward is src[idx.clamp_min(0)] bit for
bit, its gradients are x[idx]'s within fp32 re-association (widths 3 and 32,
negative indices, one index repeated 10,000 times, no repeats, an empty
index), and without grad it adds no autograd node and launches nothing.
Also, in torch alone, a model of csrc/gather.cu's levels (chunks of CHUNK
entries, the runs at a chunk's two ends to its two partial slots, the slots
summed by the next level until one chunk holds them), held exactly to
index_add_ on integer-valued rows at several chunk sizes, and the constants
read from the .cu."""
import re
from pathlib import Path

import pytest
import torch

from tracer_torch.kernels import gather
from tracer_torch.kernels._launch import LAUNCHES
from tracer_torch.utils import metrics

CU = Path(gather.__file__).resolve().parent / "csrc" / "gather.cu"


def _idx(case: str, n_rows: int, gen) -> torch.Tensor:
    if case == "negative":
        idx = torch.randint(-1, n_rows, (37, 53), generator=gen)
        idx[0, :7] = -1
        return idx
    if case == "one index 10,000 times":
        idx = torch.randint(0, n_rows, (12_000,), generator=gen)
        idx[torch.randperm(12_000, generator=gen)[:10_000]] = 5
        return idx
    if case == "no repeats":
        return torch.randperm(n_rows, generator=gen)[: n_rows // 2]
    if case == "empty":
        return torch.zeros((0,), dtype=torch.int64)
    raise ValueError(case)


CASES = ("negative", "one index 10,000 times", "no repeats", "empty")


def graph_nodes(t: torch.Tensor) -> set:
    """The names of the autograd nodes behind t."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in seen:
            seen.add(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
    return seen


@pytest.mark.parametrize("w", [3, 32])
@pytest.mark.parametrize("case", CASES)
def test_forward_bits_and_gradients(case, w):
    gen = torch.Generator().manual_seed(17 * w + len(case))
    n_rows = 300
    src = torch.randn(n_rows, w, generator=gen)
    idx = _idx(case, n_rows, gen)
    a = src.clone().requires_grad_(True)
    b = src.clone().requires_grad_(True)
    got = gather.gather_rows(a, idx)
    want = b[idx.clamp_min(0)]
    assert got.shape == want.shape and torch.equal(got, want)
    assert "GatherRowsBackward" in graph_nodes(got)
    up = torch.randn(want.shape, generator=gen)
    (got * up).sum().backward()
    (want * up).sum().backward()
    # Both sum the same rows in some order: fp32 re-association at most.
    scale = torch.zeros(n_rows, w).index_add_(0, idx.clamp_min(0).reshape(-1),
                                              up.reshape(-1, w).abs())
    assert torch.all((a.grad - b.grad).abs() <= 1e-6 * scale)


@pytest.mark.parametrize("shape", [(40,), (40, 3), (40, 2, 4)])
def test_source_shapes_and_int32_indices(shape):
    gen = torch.Generator().manual_seed(3)
    src = torch.randn(shape, generator=gen).requires_grad_(True)
    idx = torch.randint(-2, 40, (6, 9), generator=gen, dtype=torch.int32)
    out = gather.gather_rows(src, idx)
    assert out.shape == (6, 9, *shape[1:])
    assert torch.equal(out, src.detach()[idx.clamp_min(0).long()])
    out.sum().backward()
    counts = torch.bincount(idx.clamp_min(0).reshape(-1).long(), minlength=40).float()
    assert torch.equal(src.grad, counts.reshape(-1, *[1] * (len(shape) - 1)).expand(shape))


@pytest.mark.parametrize("how", ["no requires_grad", "no_grad", "inference_mode"])
def test_no_node_and_no_launch_without_grad(how):
    LAUNCHES["rows_sum"] = 0
    src = torch.randn(50, 32, requires_grad=how != "no requires_grad")
    idx = torch.tensor([3, -1, 3, 49])
    ctx = {"no requires_grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[how]
    with ctx():
        out = gather.gather_rows(src, idx)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, src.detach()[idx.clamp_min(0)])
    assert LAUNCHES["rows_sum"] == 0


def test_cpu_backward_is_the_plain_version():
    LAUNCHES["rows_sum"] = 0
    src = torch.randn(10, 3, requires_grad=True)
    idx = torch.tensor([[1, 1, 9], [0, -1, 1]])
    g = torch.randn(2, 3, 3)
    (gather.gather_rows(src, idx) * g).sum().backward()
    assert torch.equal(src.grad, gather.rows_sum_plain(g.reshape(-1, 3),
                                                       idx.clamp_min(0).reshape(-1), 10))
    assert LAUNCHES["rows_sum"] == 0


def test_the_backward_records_its_span_and_count():
    src = torch.randn(20, 32, requires_grad=True)
    idx = torch.randint(-1, 20, (7, 11))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with metrics.span("grad.step"):
            out = gather.gather_rows(src, idx)
            with metrics.span("grad.backward"):
                out.sum().backward()
    try:
        recs = [r for r in metrics.span_records() if r.name == "grad.rows_sum"]
        assert len(recs) == 1 and recs[0].parent == "grad.backward"
        tot = metrics.span_totals("grad.step")
        assert tot["counters"] == {"rows_summed": 77}
        assert tot["spans"]["grad.rows_sum"]["calls"] == 1
    finally:
        metrics.reset()


# ---------------------------------------------------------------------------
# The kernel's levels, modelled in torch
# ---------------------------------------------------------------------------

def rows_sum_levels(g, idx, n_rows: int, chunk: int):
    """csrc/gather.cu's gr_rows_sum in torch -> (out, the entries of each
    level). Each chunk of `chunk` sorted entries writes every run that
    touches neither of its ends to out, the run at its first entry to slot
    2c and the run at its last to slot 2c + 1 (a chunk of one run: its sum
    at 2c, a zero row under the same key at 2c + 1); the slots are the next
    level's entries; a level of one chunk writes every run to out. Runs are
    summed in order (the column walk's order)."""
    keys, perm = torch.sort(idx, stable=True)
    vals = g[perm]
    out = g.new_zeros((n_rows, g.shape[1]))
    sizes = []
    while keys.numel():
        m = keys.numel()
        sizes.append(m)
        n_chunks = -(-m // chunk)
        final = n_chunks == 1
        pk = torch.full((2 * n_chunks,), -7, dtype=torch.int64)
        pv = torch.full((2 * n_chunks, g.shape[1]), float("nan"))
        for c in range(n_chunks):
            ks, vs = keys[c * chunk:(c + 1) * chunk], vals[c * chunk:(c + 1) * chunk]
            first, last = int(ks[0]), int(ks[-1])
            for k in torch.unique_consecutive(ks).tolist():
                acc = torch.zeros(g.shape[1])
                for v in vs[ks == k]:
                    acc = acc + v
                if final or k not in (first, last):
                    out[k] = acc
                    continue
                slot = 2 * c + (0 if k == first else 1)
                pk[slot], pv[slot] = k, acc
                if first == last:
                    pk[slot + 1], pv[slot + 1] = k, 0.0
        if final:
            break
        assert torch.all(pk[1:] >= pk[:-1]), "the slots are sorted by key"
        keys, vals = pk, pv
    return out, sizes


@pytest.mark.parametrize("chunk", [4, 8, 128])
@pytest.mark.parametrize("case", ["long runs", "no repeats", "one key", "ragged"])
def test_the_levels_sum_every_row_once(case, chunk):
    gen = torch.Generator().manual_seed(chunk)
    n_rows, w = 60, 3
    if case == "long runs":
        idx = torch.cat([torch.full((700,), 0), torch.randint(0, n_rows, (300,), generator=gen),
                         torch.full((500,), 59), torch.full((333,), 17)])
    elif case == "no repeats":
        idx = torch.randperm(n_rows, generator=gen)
    elif case == "one key":
        idx = torch.full((1029,), 4)
    else:
        idx = torch.randint(0, n_rows, (chunk + 1,), generator=gen)
    idx = idx[torch.randperm(idx.numel(), generator=gen)]
    # Small integers: every order of summation gives the same bits.
    g = torch.randint(-8, 9, (idx.numel(), w), generator=gen).float()
    got, sizes = rows_sum_levels(g, idx, n_rows, chunk)
    assert torch.equal(got, gather.rows_sum_plain(g, idx, n_rows))
    for m, nxt in zip(sizes, sizes[1:]):
        assert nxt == 2 * -(-m // chunk) < m


@pytest.mark.parametrize("n, levels", [(262_144, 3), (246_144, 3), (82_048, 3), (128, 1),
                                       (129, 2), (1, 1)])
def test_levels_and_slots_at_the_fit_shapes(n, levels):
    """The kernel's levels at the bunny512 fit's gathers (262,144 rays, 3 x
    82,048 slots, 82,048 slots) and at the edges of one chunk: the odd
    levels' slots fit the wrapper's first buffer, the even levels' its
    second."""
    sizes = [n]
    while sizes[-1] > gather.CHUNK:
        sizes.append(2 * -(-sizes[-1] // gather.CHUNK))
    assert len(sizes) == levels
    a, b = gather.slot_counts(n)
    assert all(m <= (a if i % 2 else b) for i, m in enumerate(sizes[1:], 1))


def test_constants_match_the_cu():
    src = CU.read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == gather.CHUNK
    assert "gr_rows_sum" in src and "w > 32" in src and gather.MAX_WIDTH == 32


def test_vertex_normals_backward_is_the_same_bits_every_call():
    """make_vertex_normal_fn's gather goes through gather_rows, so its VJP on
    the CPU sums in one order (ATen's backward of x[idx] on the CPU adds in
    an order that varies from call to call at this size)."""
    from tracer_torch import api
    from tracer_torch.scene.types import make_vertex_normal_fn
    from tracer_torch.utils.config import load_config

    scene, _ = api.get_scene(load_config("bunny-grad", scene_arg=4), "cpu")
    normals_of = make_vertex_normal_fn(scene.tris.numpy(), scene.verts.shape[0], device="cpu")
    up = torch.randn(scene.verts.shape, generator=torch.Generator().manual_seed(1))
    grads = []
    for _ in range(6):
        v = scene.verts.clone().requires_grad_(True)
        (normals_of(v) * up).sum().backward()
        grads.append(v.grad)
    assert all(torch.equal(g, grads[0]) for g in grads[1:])
