"""tracer_torch traversal drivers (plain versions of the CUDA kernels) vs
the JAX package's Pallas kernels in interpret mode (CPU).

One accel, built by the JAX package, feeds both sides through
tracer_torch.bridge.accel_from_arrays, and one cull's words feed both
drivers, so the comparison isolates the traversal. The selected slot `gid`
and the occlusion mask are held exact. The best t is held to rtol 1e-6:
XLA contracts the reference's products into FMAs, the port rounds each
product (as its CUDA kernels do, built with -fmad=false)."""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh.cluster import build_clusters
from tracer.core.types import T_FAR
from tracer.kernels import traversal2 as jt2
from tracer_torch.bridge import accel_from_arrays
from tracer_torch.kernels import traversal2 as tt2

from parity_util import bunny_rays, exact_cull as _cull, leaves, segment_list, soup_rays

FIXTURES = {"bunny3": functools.partial(bunny_rays, 64), "soup400": soup_rays}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def case(request):
    scene, o_t, d_t = FIXTURES[request.param]()
    accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 32)
    words, counts = _cull(accel, o_t, d_t, T_FAR)
    return (accel, accel_from_arrays(leaves(accel), "cpu"), o_t, d_t, request.param,
            words, counts)


def test_closest_split_matches_pallas(case):
    j_accel, t_accel, o_t, d_t, name, words, counts = case
    c = np.array(counts)
    need_split, need_zero = int((c > 1).sum()), int((c > 0).sum())
    # Every soup tile sees many clusters; the bunny fills all three regions.
    assert need_split > 0
    assert name == "soup400" or need_zero > need_split
    split = jax.jit(functools.partial(jt2.trace_tiles_split, split=need_split + 8,
                                      zero_split=need_zero + 8, interpret=True))
    bt, gid, excess, _ = split(jnp.asarray(o_t), jnp.asarray(d_t), j_accel, words, counts)
    assert int(excess) == 0
    t_bt, t_gid, t_excess, t_need = tt2.trace_tiles_split(
        torch.from_numpy(o_t), torch.from_numpy(d_t), t_accel,
        torch.from_numpy(np.array(words)), torch.from_numpy(c))
    assert int(t_excess) == 0 and t_need == (need_split, need_zero)
    np.testing.assert_array_equal(t_gid.numpy(), np.asarray(gid))
    np.testing.assert_allclose(t_bt.numpy(), np.asarray(bt), rtol=1e-6)
    assert (t_gid.numpy() >= 0).mean() > 0.05, "fixture must hit something"


def test_anyhit_graded_matches_pallas(case):
    """Light-origin segments to points along the primary rays: the port's
    one-launch any-hit == the reference's graded lockstep regions."""
    j_accel, t_accel, o_t, d_t, name, words, counts = case
    light = np.array([0.3, 1.4, 0.2], np.float32)
    p = o_t + 2.5 * d_t
    so = np.broadcast_to(light, p.shape).copy()
    sd = (p - light).astype(np.float32)
    sd[:, ::7] = 0.0  # dead segments: d == 0, t_max zeroed by the drivers
    tm = np.full(so.shape[:2], 1.0 - 1e-3, np.float32)
    words, counts = _cull(j_accel, so, sd, jnp.asarray(tm))
    c = np.array(counts)
    b1, z = int((c > 1).sum()), int((c > 0).sum())
    graded = jax.jit(functools.partial(jt2.any_hit_tiles_graded, b1_split=b1 + 8,
                                       zero_split=z + 8, interpret=True))
    occ, excess, _ = graded(jnp.asarray(so), jnp.asarray(sd), jnp.asarray(tm), j_accel,
                            words, counts)
    assert int(excess) == 0
    t_occ, t_excess, t_need = tt2.any_hit_tiles_graded(
        torch.from_numpy(so), torch.from_numpy(sd), torch.from_numpy(tm), t_accel,
        torch.from_numpy(np.array(words)), torch.from_numpy(c))
    assert int(t_excess) == 0 and t_need == (b1, z)
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(occ))
    assert 0.0 < t_occ.numpy().mean() < 1.0, "fixture must occlude some segments, not all"


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_plain_batch_invariance(case, batch):
    """The plain versions' any-hit result does not depend on B; the
    closest-hit one only through exact-t ties, which these fixtures do not
    have. (The CUDA kernels are built for B = BATCH only.)"""
    j_accel, t_accel, o_t, d_t, name, words, counts = case
    args = [torch.from_numpy(np.array(x)) for x in (words, counts)]
    o4 = torch.from_numpy(np.concatenate([o_t, np.ones_like(o_t[..., :1])], -1))
    d4 = torch.from_numpy(np.concatenate([d_t, np.zeros_like(d_t[..., :1])], -1))
    ref = tt2.closest_hit_plain(o4, d4, t_accel.tri_w, *args)
    got = tt2.closest_hit_plain(o4, d4, t_accel.tri_w, *args, batch=batch)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    tm = torch.full(o4.shape[:2], 2.0)
    np.testing.assert_array_equal(
        tt2.anyhit_plain(o4, d4, tm, t_accel.tri_w, *args, batch=batch).numpy(),
        tt2.anyhit_plain(o4, d4, tm, t_accel.tri_w, *args).numpy())


def test_wrappers_dispatch_by_device(case):
    """CPU tensors run the plain version and launch nothing; a tensor on
    any other non-CUDA device raises instead of falling back."""
    _, t_accel, o_t, d_t, _, _, _ = case
    o4 = torch.from_numpy(np.concatenate([o_t, np.ones_like(o_t[..., :1])], -1))
    d4 = torch.from_numpy(np.concatenate([d_t, np.zeros_like(d_t[..., :1])], -1))
    n = o4.shape[0]
    words = torch.zeros((n, 8), dtype=torch.int32)
    counts = torch.ones(n, dtype=torch.int32)
    tm = torch.ones(o4.shape[:2])
    before = dict(tt2.LAUNCHES)
    fast = tt2.closest_fast(o4, d4, t_accel.tri_w, words, counts)
    np.testing.assert_array_equal(
        fast[1].numpy(), tt2.closest_hit_plain(o4, d4, t_accel.tri_w, words, counts)[1].numpy())
    tt2.closest_hit(o4, d4, t_accel.tri_w, words, counts)
    tt2.anyhit(o4, d4, tm, t_accel.tri_w, words, counts)
    assert tt2.LAUNCHES == before
    meta = lambda x: x.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tt2.closest_hit(*map(meta, (o4, d4, t_accel.tri_w, words, counts)))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tt2.anyhit(*map(meta, (o4, d4, tm, t_accel.tri_w, words, counts)))


def _segment_pairs(counts, seg, k_cap):
    """anyhit_segments -> [(tile, k0)] of its segments, in its order."""
    order, ends = tt2.anyhit_segments(torch.from_numpy(counts), seg, k_cap)
    assert order.shape == counts.shape and order.dtype == torch.int64
    assert ends.shape == (-(-k_cap // seg),) and ends.dtype == torch.int32
    tile, k0 = segment_list(order, ends, seg)
    return list(zip(tile.tolist(), k0.tolist()))


@pytest.mark.parametrize("seg", [1, 3, tt2.SEG])
def test_anyhit_segments_cover_every_word_once_in_order(seg):
    """Random counts, zeros and counts not divisible by seg among them: the
    segments cover every (tile, k < count) exactly once; every tile's first
    segment comes before any second one, and so on; within a rank the
    heaviest tile comes first (ties by tile index). A wider bound k_cap of
    the counts gives the same segments."""
    rng = np.random.default_rng(11)
    for trial in range(40):
        n_tiles = int(rng.integers(0, 50))
        k_max = int(rng.integers(0, 45))
        counts = rng.integers(0, k_max + 1, size=n_tiles).astype(np.int32)
        counts[rng.random(n_tiles) < 0.2] = 0
        pairs = _segment_pairs(counts, seg, k_max)
        covered = [(t, k) for t, k0 in pairs for k in range(k0, min(k0 + seg, counts[t]))]
        want = [(t, k) for t in range(n_tiles) for k in range(counts[t])]
        assert sorted(covered) == want and len(covered) == len(want)
        assert all(k0 % seg == 0 and k0 < counts[t] for t, k0 in pairs)
        keys = [(k0 // seg, -int(counts[t]), t) for t, k0 in pairs]
        assert keys == sorted(keys)
        assert _segment_pairs(counts, seg, k_max + int(rng.integers(1, 9))) == pairs


def _anyhit_by_segments(case, batch):
    """anyhit_plain over the whole word lists, and OR-ed over the segments
    of anyhit_segments, one call a segment rank (a segment's words as a list
    of its own, as a block of the kernel walks them)."""
    _, t_accel, o_t, d_t, _, words, counts = case
    words, counts = torch.from_numpy(np.array(words)), torch.from_numpy(np.array(counts))
    o4 = torch.from_numpy(np.concatenate([o_t, np.ones_like(o_t[..., :1])], -1))
    d4 = torch.from_numpy(np.concatenate([d_t, np.zeros_like(d_t[..., :1])], -1))
    tm = torch.from_numpy(np.random.default_rng(5).uniform(0.8, 3.5, o4.shape[:2])
                          .astype(np.float32))
    whole = tt2.anyhit_plain(o4, d4, tm, t_accel.tri_w, words, counts, batch=batch)
    tile, k0 = map(torch.from_numpy, segment_list(
        *tt2.anyhit_segments(counts, tt2.SEG, words.shape[1]), tt2.SEG))
    assert tile.shape[0] > o4.shape[0], "some tile must hold more than one segment"
    pad = torch.nn.functional.pad(words, (0, tt2.SEG))
    seg_words = pad[tile[:, None], k0[:, None] + torch.arange(tt2.SEG)]
    seg_counts = (counts[tile] - k0).clamp_max(tt2.SEG).int()
    occ_seg = tt2.anyhit_plain(o4[tile], d4[tile], tm[tile], t_accel.tri_w, seg_words,
                               seg_counts, batch=batch)
    ored = torch.zeros(whole.shape, dtype=torch.int32).index_put_(
        (tile,), occ_seg.int(), accumulate=True) > 0
    return whole, ored


def test_anyhit_plain_by_segments_equals_whole(case):
    """Occlusion is an OR over a tile's candidates: anyhit_plain applied
    segment by segment and OR-ed equals anyhit_plain over the whole lists."""
    whole, ored = _anyhit_by_segments(case, tt2.BATCH)
    np.testing.assert_array_equal(ored.numpy(), whole.numpy())
    assert 0.0 < whole.float().mean() < 1.0


def test_segment_constants_pinned_to_the_kernels():
    """SEG and SLICES are csrc/common.cuh's kSeg and kSlices, a block of the
    any-hit kernels is SLICES * 64 = 256 threads for a tile of 64 rays, and
    both sources take the header's constants and launch that block (the
    kernels cannot run here: their constants are read from the sources)."""
    csrc = Path(tt2.__file__).parent / "csrc"
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", (csrc / "common.cuh").read_text()))
    assert (int(consts["kSeg"]), int(consts["kSlices"])) == (tt2.SEG, tt2.SLICES) == (8, 4)
    assert tt2.SLICES * 64 == 256
    for name in ("traversal2.cu", "stream.cu"):
        src = (csrc / name).read_text()
        assert '#include "common.cuh"' in src
        assert not re.search(r"constexpr int (kSeg|kSlices) =", src)
        assert re.search(r"anyhit\w*kernel<<<grid, kSlices \* tr,", src)
    batch = re.search(r"constexpr int kBatch = (\d+);", (csrc / "traversal2.cu").read_text())
    assert int(batch.group(1)) == tt2.BATCH and tt2.SEG % tt2.BATCH == 0
