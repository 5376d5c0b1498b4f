"""The two-stage cull's CUDA path, on the CPU (bvh/cull.py): CPU tensors
take the plain version; the build and the launch counters name the two
kernels of csrc/cull.cu; and a model of the kernels' contract, run through
the kernels' host path (_cull_sorted2_cuda), gives the plain version's
words, counts, excess and need. The contract: a tile's survivors compacted
in any order, sorted alone where there are at most SORT_CAP of them, the
stage-2 rows padded with WORD_INVALID. The kernels themselves run only on a
card, where chip_smoke.py holds them to the plain version bit for bit."""
import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tracer_torch.bvh import cull
from tracer_torch.bvh.cluster import SUPER_FACTOR, build_clusters
from tracer_torch.core.types import T_FAR
from tracer_torch.kernels import _build
from tracer_torch.kernels._launch import LAUNCHES
from tracer_torch.scene.procedural import bunny_scene
from tracer_torch.utils import metrics

F = SUPER_FACTOR
SRC = Path(cull.__file__).resolve().parents[1] / "kernels" / "csrc" / "cull.cu"


def _boxes(n_cl: int, seed: int):
    """n_cl random cluster boxes in [-2.5, 2.5]^3 in order of x, cluster 0 =
    [0, 1] x [-1, 1] x [-1, 1], and their superclusters' boxes (the last one
    short where n_cl % 16)."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((n_cl, 3), generator=g) * 4 - 2
    c = c[torch.argsort(c[:, 0])]
    h = torch.rand((n_cl, 3), generator=g) * 0.4 + 0.1
    lo, hi = c - h, c + h
    lo[0] = torch.tensor([0.0, -1.0, -1.0])
    hi[0] = torch.tensor([1.0, 1.0, 1.0])
    n_sc = -(-n_cl // F)
    pad = n_sc * F - n_cl
    s_lo = torch.cat([lo, lo[-1:].expand(pad, 3)]).reshape(n_sc, F, 3).amin(1)
    s_hi = torch.cat([hi, hi[-1:].expand(pad, 3)]).reshape(n_sc, F, 3).amax(1)
    return SimpleNamespace(num_clusters=n_cl, cluster_lo=lo, cluster_hi=hi, super_lo=s_lo,
                           super_hi=s_hi)


def _rays(seed: int, n_tiles: int = 9, tr: int = 8):
    """Tiles of coherent rays from z = -6 into the boxes; tile 1 has no live
    ray, tile 2 starts on cluster 0's x = 1 face heading -x (its slab gives
    a -0.0 entry), tile 3 has one dead ray. Returns o, d, per-ray t_max."""
    g = torch.Generator().manual_seed(seed)
    base = torch.tensor([0.0, 0.0, -6.0]) + torch.rand((n_tiles, 1, 3), generator=g)
    o = base + 0.05 * torch.rand((n_tiles, tr, 3), generator=g)
    aim = torch.rand((n_tiles, 1, 3), generator=g) * 4 - 2
    d = aim + 0.3 * torch.rand((n_tiles, tr, 3), generator=g) - o
    d = d / d.norm(dim=-1, keepdim=True)
    d[1] = 0.0
    o[2] = torch.tensor([1.0, 0.0, 0.0]) + 0.2 * torch.rand((tr, 3), generator=g) * torch.tensor(
        [0.0, 1.0, 1.0])
    d[2] = torch.tensor([-1.0, 0.0, 0.0]) + 0.05 * torch.rand((tr, 3), generator=g) * torch.tensor(
        [0.0, 1.0, 1.0])
    d[3, 0] = 0.0
    tm = 3.0 + 5.0 * torch.rand((n_tiles, 1), generator=g) + 0.1 * torch.rand((n_tiles, tr),
                                                                         generator=g)
    return o, d, tm


def _bunny_case():
    """A small bunny (1,282 triangles in clusters of 32: 41 clusters, 3
    superclusters, the last short) and its primary rays in tiles of 64."""
    from tracer_torch.core.camera import Camera, generate_rays
    from tracer_torch.kernels.traversal import tile_rays

    scene, cam = bunny_scene(3, device="cpu")
    accel = build_clusters(scene.verts, scene.tris, 32)
    rays = generate_rays(Camera.make(**cam, device="cpu"), 40, 40)
    o, d, _ = tile_rays(rays.o, rays.d, 64)
    return accel, o, d


def _place(rows, width: int, fill, seed: int):
    """The kernels' rows: each tile's survivors in a shuffled order, sorted
    where they fit SORT_CAP, at the row's start; the rest `fill` (None:
    arbitrary ints, a row's unwritten part)."""
    g = torch.Generator().manual_seed(seed)
    if fill is None:
        out = torch.randint(-2**31, 2**31 - 1, (len(rows), width), generator=g,
                            dtype=torch.int64).to(torch.int32)
    else:
        out = torch.full((len(rows), width), fill, dtype=torch.int32)
    for t, w in enumerate(rows):
        w = w[torch.randperm(w.numel(), generator=g)]
        if w.numel() <= cull.SORT_CAP:
            w = torch.sort(w).values
        out[t, :w.numel()] = w
    return out


def model_stage1(o, d, t_max, box_lo, box_hi):
    """cull_stage1's contract in torch."""
    bounds = cull.tile_bounds(o, d)
    tm = cull._tile_tmax(t_max, o.shape[0], o.device)
    ok, t = cull.frustum_aabb_entry(*(b[:, None] for b in bounds), box_lo[None], box_hi[None],
                                    tm)
    ids = torch.arange(box_lo.shape[0], dtype=torch.int32)[None]
    w = cull.pack_candidates(t, ids, ok)
    words = _place([w[i][ok[i]] for i in range(ok.shape[0])], box_lo.shape[0], None, 1)
    tiles = torch.cat([*bounds, tm, torch.zeros((o.shape[0], cull.TILE_FLOATS - 13))], 1)
    return words, ok.sum(1, dtype=torch.int32), tiles


def model_stage2(tiles, words_s1, sup_counts, s, cl_lo, cl_hi):
    """cull_stage2's contract in torch: members of the first sup_counts[t]
    words, ids past the last cluster infeasible."""
    n_cl = cl_lo.shape[0]
    rows = []
    for t in range(tiles.shape[0]):
        sid = (words_s1[t, :int(sup_counts[t])] & ((1 << cull.CLUSTER_BITS) - 1)).long()
        cl = (sid[:, None] * F + torch.arange(F)).reshape(-1)
        cl = cl[cl < n_cl]
        tb = tiles[t]
        ok, tl = cull.frustum_aabb_entry(tb[0:3], tb[3:6], tb[6:9], tb[9:12], cl_lo[cl],
                                         cl_hi[cl], tb[12:13])
        rows.append(cull.pack_candidates(tl, cl.to(torch.int32), ok)[ok])
    counts = torch.tensor([r.numel() for r in rows], dtype=torch.int32)
    return _place(rows, s * F, cull.WORD_INVALID, 2), counts


@pytest.fixture
def modelled(monkeypatch):
    monkeypatch.setattr(cull, "cull_stage1", model_stage1)
    monkeypatch.setattr(cull, "cull_stage2", model_stage2)


def _cases():
    acc = _boxes(165, 5)
    o, d, tm = _rays(6)
    return {"boxes scalar t_max": (acc, o, d, T_FAR), "boxes per-ray t_max": (acc, o, d, tm),
            "bunny": (*_bunny_case(), T_FAR)}


CASES = ["boxes scalar t_max", "boxes per-ray t_max", "bunny"]


def _same(got, want):
    (w, c, x, need), (w0, c0, x0, need0) = got, want
    assert torch.equal(w, w0) and torch.equal(c, c0)
    assert int(x) == int(x0) == 0 and need == need0


def test_the_cases_cover_the_contract():
    """The boxes case holds a tile with no live ray (no survivor), a short
    last supercluster, per-ray t_max and a -0.0 entry candidate (the x slab
    of tile 2 against cluster 0: 0 / -1, which the kernel's fmaxf may carry
    into t_lo, and pack_candidates reads as +0.0)."""
    acc, o, d, tm = _cases()["boxes per-ray t_max"]
    assert acc.num_clusters % F and acc.super_lo.shape[0] == 11
    words, counts, _, _ = cull.cull_clusters_sorted2(acc, o, d, tm)
    assert counts[1] == 0 and (words[1] == cull.WORD_INVALID).all()
    assert counts.max() > 0 and tm.ndim == 2
    o_lo, _, d_lo, _ = cull.tile_bounds(o[2:3], d[2:3])
    lo1, _, ok1 = cull._upper_lower(o_lo[0, 0], d_lo[0, 0], acc.cluster_hi[0, 0], ge=False)
    assert bool(ok1) and float(lo1) == 0.0 and torch.signbit(lo1)
    assert (words[2] & ((1 << cull.CLUSTER_BITS) - 1) == 0).any()   # cluster 0 survives
    assert int(cull.pack_candidates(torch.tensor(-0.0), torch.tensor(0), torch.tensor(True))) == 0


@pytest.mark.parametrize("case", CASES)
def test_cpu_tensors_take_the_plain_version(case, monkeypatch):
    """No kernel path and no launch for CPU tensors; the plain version's
    words equal the single-stage cull's, with excess 0 and need (max count,
    S)."""
    acc, o, d, tm = _cases()[case]

    def refuse(*_):
        raise AssertionError("the kernel path ran on CPU tensors")

    for name in ("_cull_sorted2_cuda", "cull_stage1", "cull_stage2"):
        monkeypatch.setattr(cull, name, refuse)
    before = dict(LAUNCHES)
    words, counts, excess, need = cull.cull_clusters_sorted2(acc, o, d, tm)
    assert LAUNCHES == before
    w1, c1, x1 = cull.cull_clusters_sorted(acc, o, d, tm)
    k = w1.shape[1]
    assert torch.equal(counts, c1) and int(excess) == int(x1) == 0
    assert words.shape[1] == k and torch.equal(words, w1)
    assert need[0] == int(counts.max())
    assert need == cull.cull_clusters_sorted2_plain(acc, o, d, tm)[3]


def test_the_build_declares_the_cull_entry_points():
    """csrc/cull.cu is built, exports cu_stage1 and cu_stage2 with as many
    parameters as _build declares, the wrappers launch them, and the
    constants the host shares with the kernels agree."""
    src = SRC.read_text()
    assert "cull.cu" in _build.SOURCES
    exported = re.findall(r"^int (cu_\w+)\(([^)]*)\)", src, flags=re.M)
    assert [e for e, _ in exported] == ["cu_stage1", "cu_stage2"]
    assert [e for e, _ in exported] == [e for e in _build._SIGNATURES if e.startswith("cu_")]
    for (entry, params), wrapper in zip(exported, (cull.cull_stage1, cull.cull_stage2)):
        assert len(params.split(",")) == len(_build._SIGNATURES[entry])
        assert f'"{entry}"' in inspect.getsource(wrapper)
    const = dict(re.findall(r"constexpr \w+ (k\w+) = ([0-9.e+-]+)f?;", src))
    assert int(const["kSortCap"]) == cull.SORT_CAP
    assert int(const["kTileFloats"]) == cull.TILE_FLOATS
    assert int(const["kSuperFactor"]) == SUPER_FACTOR
    assert float(const["kEps"]) == cull._EPS
    assert cull._block(cull.SORT_CAP * 4)[1] == cull.SORT_CAP


def test_the_cull_kernels_have_launch_counters():
    assert LAUNCHES["cull_stage1"] == LAUNCHES["cull_stage2"] == 0
    from tracer_torch.kernels import traversal2

    assert traversal2.LAUNCHES is LAUNCHES


@pytest.mark.parametrize("case", CASES)
def test_the_kernels_contract_gives_the_plain_words(case, modelled):
    acc, o, d, tm = _cases()[case]
    _same(cull._cull_sorted2_cuda(acc, o, d, tm), cull.cull_clusters_sorted2_plain(acc, o, d, tm))


def _spills(acc, o, d, tm) -> tuple[tuple, int]:
    metrics.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with metrics.span("frame"):
                out = cull._cull_sorted2_cuda(acc, o, d, tm)
        tot = metrics.span_totals("frame")
    finally:
        metrics.reset()
    assert tot["counters"]["readbacks"] == 3
    assert {"cull.stage1", "cull.stage2"} <= set(tot["spans"])
    return out, tot["counters"]["cull_spills"]


@pytest.mark.parametrize("cap", ["below S", "between S and k", "k"])
@pytest.mark.parametrize("case", ["boxes per-ray t_max", "bunny"])
def test_the_spill_choice_follows_s_and_k(case, cap, modelled, monkeypatch):
    """With SORT_CAP below S both stages leave tiles unsorted, between S and
    the max count only stage 2 does, at the max count neither: the pass
    sorts them with torch.sort, counts one spill, and its words stay the
    plain version's."""
    acc, o, d, tm = _cases()[case]
    want = cull.cull_clusters_sorted2_plain(acc, o, d, tm)
    s, m = want[3][1], want[3][0]
    assert 1 < s < m
    value = {"below S": s - 1, "between S and k": s, "k": m}[cap]
    monkeypatch.setattr(cull, "SORT_CAP", value)
    got, spills = _spills(acc, o, d, tm)
    _same(got, want)
    assert spills == (0 if cap == "k" else 1)
