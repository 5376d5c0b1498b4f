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
from tracer_torch.bvh.cull import CLUSTER_BITS
from tracer_torch.kernels import traversal as tt
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
    """run_segments -> [(tile, k0)] of its segments, in its order."""
    order, ends = tt2.run_segments(torch.from_numpy(counts), seg, k_cap)
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
    of run_segments, one call a segment rank (a segment's words as a list
    of its own, as a block of the kernel walks them)."""
    _, t_accel, o_t, d_t, _, words, counts = case
    words, counts = torch.from_numpy(np.array(words)), torch.from_numpy(np.array(counts))
    o4 = torch.from_numpy(np.concatenate([o_t, np.ones_like(o_t[..., :1])], -1))
    d4 = torch.from_numpy(np.concatenate([d_t, np.zeros_like(d_t[..., :1])], -1))
    tm = torch.from_numpy(np.random.default_rng(5).uniform(0.8, 3.5, o4.shape[:2])
                          .astype(np.float32))
    whole = tt2.anyhit_plain(o4, d4, tm, t_accel.tri_w, words, counts, batch=batch)
    tile, k0 = map(torch.from_numpy, segment_list(
        *tt2.run_segments(counts, tt2.SEG, words.shape[1]), tt2.SEG))
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
    """SEG and SLICES are csrc/common.cuh's kSeg and kSlices, MAX_RAYS its
    kMaxRays, SLICES_CLOSEST, SLICES_FAST and FAST_THREADS
    csrc/traversal2.cu's kSlicesClosest, kSlicesFast and kFastThreads; a block
    of the any-hit kernels is SLICES * 64 = 256 threads for a tile of 64
    rays, one of closest_hit_kernel SLICES_CLOSEST * 64 = 128; both sources
    take the headers' kSeg and kSlices and launch those blocks, and SEG is a
    whole number of steps of each segmented kernel: B = BATCH in
    traversal2.cu, STREAM_BATCH in stream.cu (the kernels cannot run here:
    their constants are read from the sources)."""
    csrc = Path(tt2.__file__).parent / "csrc"
    common = (csrc / "common.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", common))
    assert (int(consts["kSeg"]), int(consts["kSlices"])) == (tt2.SEG, tt2.SLICES) == (8, 4)
    assert "constexpr int kMaxRays = 1024 / kSlices;" in common and tt2.MAX_RAYS == 256
    assert tt2.SLICES * 64 == 256
    for name in ("traversal2.cu", "stream.cu"):
        src = (csrc / name).read_text()
        assert '#include "common.cuh"' in src and '#include "sorted.cuh"' in src
        assert not re.search(r"constexpr int (kSeg|kSlices) =", src)
        assert re.search(r"anyhit\w*kernel<<<grid, kSlices \* tr,", src)
    src2, srcs = ((csrc / name).read_text() for name in ("traversal2.cu", "stream.cu"))
    closest = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src2))
    assert int(closest["kSlicesClosest"]) == tt2.SLICES_CLOSEST == 2
    assert tt2.SLICES_CLOSEST * 64 == 128 and 64 * tt2.SLICES <= 1024
    assert "closest_hit_kernel<<<grid, kSlicesClosest * tr, smem, s>>>" in src2
    assert int(closest["kBatch"]) == tt2.BATCH and tt2.SEG % tt2.BATCH == 0
    assert 1 << int(closest["kBatchBits"]) == tt2.BATCH
    assert "static_assert(kSeg % kBatch == 0" in src2
    assert "constexpr int kNBufClosest = 2 * kBatch;" in src2
    assert "Ring<kNBufClosest> ring{" in src2 and "kSlicesClosest" not in srcs
    stream_batch = int(re.search(r"constexpr int kBatch = (\d+);", srcs).group(1))
    assert stream_batch == 2 and tt2.SEG % stream_batch == 0
    # closest_fast_kernel: SLICES_FAST threads a ray, blocks of FAST_THREADS
    # holding FAST_THREADS // (SLICES_FAST * TR) tiles, 2 at a tile of 64.
    assert (int(closest["kSlicesFast"]), int(closest["kFastThreads"])) == (
        tt2.SLICES_FAST, tt2.FAST_THREADS) == (2, 256)
    assert "const int tiles = max(1, kFastThreads / (kSlicesFast * tr));" in src2
    assert "closest_fast_kernel<<<(n_tiles + tiles - 1) / tiles, tiles * kSlicesFast * tr," in src2
    assert max(1, tt2.FAST_THREADS // (tt2.SLICES_FAST * 64)) == 2
    assert "constexpr int kMaxTilesFast = kFastThreads / (kSlicesFast * 32);" in src2


# ---------------------------------------------------------------------------
# The segmented closest-hit walk (csrc/traversal2.cu), modelled in plain torch:
# segments of run_segments, each walked step by step from the keys merged so
# far (its early-out bound), its hits merged into one key a ray by the
# minimum, the keys decoded by closest_finish_plain. The kernels' blocks meet
# in no fixed order; the model walks the segment ranks forward or backward.
# ---------------------------------------------------------------------------

def _homog_np(o_t, d_t):
    return (torch.from_numpy(np.concatenate([o_t, np.ones_like(o_t[..., :1])], -1)),
            torch.from_numpy(np.concatenate([d_t, np.zeros_like(d_t[..., :1])], -1)))


def _step_keys(o4, d4, w, words, counts, k, batch, n_cl):
    """The least key of each ray over one step (words k .. k+B-1) of each
    tile: per lane the earliest word wins, the candidate (t, step, rank,
    lane) -> (Nt, TR) int64, KEY_MISS where the step has no hit."""
    c = w.shape[2] // 3
    cl, live = tt2._candidates(words, counts, k, batch, n_cl)
    tv = tt2._cluster_t(o4[:, None], d4[:, None], w[cl.long()], T_FAR)
    tv = torch.where(live[..., None, None], tv, T_FAR)                   # (Nt, B, TR, C)
    m = tv.amin(1)
    j_first = (tv == m[:, None]).to(torch.uint8).argmax(1)               # (Nt, TR, C)
    ranks = tt2.step_ranks(cl, live)                                      # (Nt, B)
    rank = torch.gather(ranks, 1, j_first.flatten(1)).view_as(j_first)
    lane = torch.arange(c).expand_as(rank)
    keys = tt2.pack_closest_key(m, torch.full_like(rank, k // batch), rank, lane, c, batch)
    return torch.where(m < T_FAR, keys, tt.KEY_MISS).amin(-1)


def _closest_by_segments(o4, d4, w, words, counts, batch, seg, backward=False):
    """The segmented walk, merged by the key and decoded -> (bt, bid)."""
    n_cl, c = w.shape[0], w.shape[2] // 3
    k_cap = words.shape[1]
    tile, k0 = map(torch.from_numpy, segment_list(*tt2.run_segments(counts, seg, k_cap), seg))
    key = torch.full(o4.shape[:2], tt.KEY_MISS, dtype=torch.int64)
    ranks = sorted(set(k0.tolist()), reverse=backward)
    for r0 in ranks:                     # a rank's tiles are distinct: one block each
        t = tile[k0 == r0]
        held = key[t]                    # the keys as the segments find them
        best = held.clone()
        going = torch.ones(t.shape[0], dtype=torch.bool)
        for k in range(r0, r0 + seg, batch):
            bound = (best >> 32).amax(1)
            entry = (words[t, min(k, k_cap - 1)] & ~tt2._CL_MASK).long()
            going &= (k < counts[t]) & ~(entry > bound)
            if not going.any():
                break
            g = t[going]
            step = _step_keys(o4[g], d4[g], w, words[g], counts[g], k, batch, n_cl)
            best[going] = torch.minimum(best[going], step)
        key[t] = torch.minimum(key[t], best)
    return tt2.closest_finish_plain(key, words, counts, n_cl, c, batch)


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[0].view(torch.int32).numpy(),
                                  want[0].view(torch.int32).numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert got[1].dtype == want[1].dtype == torch.int32


@pytest.mark.parametrize("batch", [tt2.BATCH, 2])
@pytest.mark.parametrize("mult", [1, 2, 4])
def test_closest_by_segments_equals_the_plain_walk(case, batch, mult):
    """Segments of B, 2B and 4B words, walked from the keys merged so far
    (forward) or from none of the earlier ranks' (backward: every bound
    stale), merged by the key's minimum and decoded: bt and bid bit for bit
    those of closest_hit_plain at the same B."""
    _, t_accel, o_t, d_t, _, words, counts = case
    words, counts = torch.from_numpy(np.array(words)), torch.from_numpy(np.array(counts))
    o4, d4 = _homog_np(o_t, d_t)
    w = t_accel.tri_w
    want = tt2.closest_hit_plain(o4, d4, w, words, counts, batch=batch)
    assert int(counts.max()) > batch, "some tile must walk more than one step"
    for backward in (False, True):
        _assert_bits(_closest_by_segments(o4, d4, w, words, counts, batch, batch * mult,
                                          backward), want)
    assert (want[1] >= 0).float().mean() > 0.05


def _tie_case(kind):
    """A hand-made tie over the soup's accel (C = 32): cluster y, the cluster
    that holds the most rays' closest hit over all clusters, and y' = a copy
    appended with the highest id, n_cl. Every tile walks the same words
    (entry bits 0: no early out). Returns (o4, d4, w, words, counts, the
    slot that must win for the tied rays, the slot that a wrong rule would
    pick)."""
    scene, o_t, d_t = soup_rays()
    j_accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 32)
    accel = accel_from_arrays(leaves(j_accel), "cpu")
    w = accel.tri_w
    n_cl, c = w.shape[0], w.shape[2] // 3
    o4, d4 = _homog_np(o_t, d_t)
    n_tiles = o4.shape[0]
    every = torch.arange(n_cl, dtype=torch.int32).expand(n_tiles, n_cl).contiguous()
    bid = tt2.closest_hit_plain(o4, d4, w, every, torch.full((n_tiles,), n_cl, dtype=torch.int32))[1]
    y, lane = divmod(int(torch.mode(bid[bid >= 0]).values), c)
    copy = w[y].clone()
    if kind == "two_lanes":            # y' holds y's lane l at lane l + 1
        copy = copy.view(4, 3, c).roll(1, dims=2).reshape(4, 3 * c)
    w = torch.cat([w, copy[None]])
    others = [i for i in range(n_cl) if i != y][:3]
    if kind == "two_steps":            # y in step 0, y' in step 1 (at both B)
        run, win, lose = [y] + others + [n_cl], y * c + lane, n_cl * c + lane
    elif kind == "two_lanes":          # y' at j = 0, y at j = 1: the lower id wins, at its lane
        run, win, lose = [n_cl, y] + others, y * c + lane, n_cl * c + lane + 1
    else:                              # one lane, y' at j = 0, y at j = 1: the earlier j wins
        run, win, lose = [n_cl, y] + others, n_cl * c + lane, y * c + lane
    words = torch.tensor(run, dtype=torch.int32).expand(n_tiles, len(run)).contiguous()
    counts = torch.full((n_tiles,), len(run), dtype=torch.int32)
    return o4, d4, w, words, counts, win, lose


@pytest.mark.parametrize("batch", [tt2.BATCH, 2])
@pytest.mark.parametrize("kind", ["two_steps", "two_lanes", "one_lane"])
def test_closest_by_segments_keeps_the_tie_rule(kind, batch):
    """Hand-made ties (_tie_case), each held to the plain version: equal t
    in two steps (the earlier step wins); equal t in two lanes whose
    clusters' id order is the reverse of their j order (the lower slot
    wins); one lane whose two words tie, ids in reverse order (the earlier
    word wins, though its id is higher). Segments of one step each, walked
    forward and backward."""
    o4, d4, w, words, counts, win, lose = _tie_case(kind)
    want = tt2.closest_hit_plain(o4, d4, w, words, counts, batch=batch)
    assert (want[1] == win).any() and not (want[1] == lose).any()
    for backward in (False, True):
        _assert_bits(_closest_by_segments(o4, d4, w, words, counts, batch, batch, backward),
                     want)


@pytest.mark.parametrize("batch", [tt2.BATCH, 2])
def test_closest_key_packing_and_limits(batch):
    """The key orders as (t, step, rank, lane), round-trips at the limits of
    its fields, and KEY_MISS lies above every hit's key and decodes to
    (T_FAR, -1); check_closest_key raises one step past its limit."""
    for c in (4, 32, 128):
        lane_bits, shift = tt2.closest_key_bits(c, batch)
        assert 1 << lane_bits >= c and shift == lane_bits + (batch - 1).bit_length()
        step_max, lane_max = (1 << (32 - shift)) - 1, c - 1
        t = torch.tensor([1.0001e-4, 1.0001e-4, 1.0, 1.0, 1.0, 1.0, 9.9e29], dtype=torch.float32)
        step = torch.tensor([0, step_max, 0, 0, 0, 1, step_max])
        rank = torch.tensor([batch - 1, 0, 0, 0, batch - 1, 0, batch - 1])
        lane = torch.tensor([lane_max, 0, 0, 1, 0, 0, lane_max])
        keys = tt2.pack_closest_key(t, step, rank, lane, c, batch)
        assert keys.dtype == torch.int64 and bool((keys[1:] > keys[:-1]).all())
        assert bool((keys < tt.KEY_MISS).all()) and bool((keys > 0).all())
        t2, step2, rank2, lane2 = tt2.unpack_closest_key(keys, c, batch)
        np.testing.assert_array_equal(t2.view(torch.int32).numpy(), t.view(torch.int32).numpy())
        for got, want in ((step2, step), (rank2, rank), (lane2, lane)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        k_cap = (step_max + 1) * batch
        tt2.check_closest_key(c, k_cap, batch)
        with pytest.raises(ValueError, match="closest-hit key"):
            tt2.check_closest_key(c, k_cap + 1, batch)
    # The largest list the cull can emit fits at the presets' C = 128.
    tt2.check_closest_key(128, 1 << CLUSTER_BITS, batch)
    miss = torch.full((2, 32), tt.KEY_MISS, dtype=torch.int64)
    words, counts = torch.zeros((2, 3), dtype=torch.int32), torch.tensor([3, 0], dtype=torch.int32)
    bt, bid = tt2.closest_finish_plain(miss, words, counts, 5, 32, batch)
    assert bool((bt == T_FAR).all()) and bool((bid == -1).all()) and bid.dtype == torch.int32


# ---------------------------------------------------------------------------
# closest_fast_kernel's fold (csrc/traversal2.cu), modelled in plain torch:
# SLICES_FAST threads a ray, each with every SLICES_FAST-th quad of 4 lanes of
# the tile's one cluster, keeping the first lane of its least t; the slices
# then fold the least (t, lane). The kernels cannot run here: the model holds
# the fold rule, in several orders, to closest_fast_plain.
# ---------------------------------------------------------------------------

def _fast_slices(o4, d4, w, words, counts, slices):
    """Each slice's best of the one-word walk: (t (S, Nt, TR), lane (S, Nt,
    TR)), the first lane of the least t over the slice's quads (T_FAR and
    lane 0 where the slice has no hit or the tile no word)."""
    c = w.shape[2] // 3
    cl = torch.clamp_max(words[:, 0] & tt2._CL_MASK, w.shape[0] - 1).long()
    tv = tt2._cluster_t(o4, d4, w[cl], T_FAR)
    tv = torch.where((counts > 0)[:, None, None], tv, T_FAR)              # (Nt, TR, C)
    lane = torch.arange(c)
    ts, ls = [], []
    for s in range(slices):
        mine = (lane // 4) % slices == s
        tm = torch.where(mine, tv, T_FAR)
        t = tm.amin(-1)
        first = torch.where((tm == t[..., None]) & mine, lane, c).amin(-1)
        ts.append(t)
        ls.append(torch.where(t < T_FAR, first, 0))
    return torch.stack(ts), torch.stack(ls)


def _fold(a, b):
    """The least (t, lane) of two slices' bests."""
    take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return torch.where(take, b[0], a[0]), torch.where(take, b[1], a[1])


def _fold_orders(ts, ls, seed):
    """The slices' bests folded by the kernel's shuffles (xor offsets S/2
    .. 1, read at slice 0), forward, backward and in two random orders."""
    slices = ts.shape[0]
    xor = [(ts[s], ls[s]) for s in range(slices)]
    off = slices // 2
    while off:
        xor = [_fold(xor[s], xor[s ^ off]) for s in range(slices)]
        off //= 2
    rng = np.random.default_rng(seed)
    orders = [list(range(slices)), list(range(slices))[::-1],
              list(rng.permutation(slices)), list(rng.permutation(slices))]
    out = [xor[0]]
    for order in orders:
        acc = (ts[order[0]], ls[order[0]])
        for s in order[1:]:
            acc = _fold(acc, (ts[s], ls[s]))
        out.append(acc)
    return out


def _assert_fast_folds(o4, d4, w, words, counts, slices):
    c = w.shape[2] // 3
    want = tt2.closest_fast_plain(o4, d4, w, words, counts)
    cl = torch.clamp_max(words[:, 0] & tt2._CL_MASK, w.shape[0] - 1)[:, None]
    for t, lane in _fold_orders(*_fast_slices(o4, d4, w, words, counts, slices), slices):
        hit = t < T_FAR
        _assert_bits((torch.where(hit, t, T_FAR), torch.where(hit, cl * c + lane, -1).int()),
                     want)
    return want


@pytest.mark.parametrize("slices", [2, 4, 8])
def test_closest_fast_fold_equals_the_plain_walk(case, slices):
    """Per-slice bests of the one-word walk, folded by shuffles and in four
    other orders: bt and bid bit for bit those of closest_fast_plain."""
    _, t_accel, o_t, d_t, _, words, counts = case
    words, counts = torch.from_numpy(np.array(words)), torch.from_numpy(np.array(counts))
    o4, d4 = _homog_np(o_t, d_t)
    want = _assert_fast_folds(o4, d4, t_accel.tri_w, words, counts, slices)
    lanes = want[1][want[1] >= 0] % (t_accel.tri_w.shape[2] // 3)
    assert set(((lanes // 4) % slices).tolist()) == set(range(slices)), \
        "every slice must hold some ray's winning lane"


@pytest.mark.parametrize("slices", [2, 4, 8])
def test_closest_fast_fold_keeps_the_tie_rule(slices):
    """A hand-made tie across slices: the soup's most-hit triangle copied to
    the lane 4 away (the next or the previous quad, so another slice), so
    two lanes of one cluster give the same t. The lower lane wins, in every
    fold order."""
    scene, o_t, d_t = soup_rays()
    j_accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 32)
    w = accel_from_arrays(leaves(j_accel), "cpu").tri_w.clone()
    n_cl, c = w.shape[0], w.shape[2] // 3
    o4, d4 = _homog_np(o_t, d_t)
    n_tiles = o4.shape[0]
    every = torch.arange(n_cl, dtype=torch.int32).expand(n_tiles, n_cl).contiguous()
    bid = tt2.closest_hit_plain(o4, d4, w, every, torch.full((n_tiles,), n_cl, dtype=torch.int32))[1]
    y, lane = divmod(int(torch.mode(bid[bid >= 0]).values), c)
    other = lane + 4 if lane + 4 < c else lane - 4
    for f in range(3):
        w[y, :, f * c + other] = w[y, :, f * c + lane]
    words = torch.full((n_tiles, 2), y, dtype=torch.int32)
    counts = torch.ones(n_tiles, dtype=torch.int32)
    want = _assert_fast_folds(o4, d4, w, words, counts, slices)
    assert (want[1] == y * c + min(lane, other)).any()
    assert not (want[1] == y * c + max(lane, other)).any()
