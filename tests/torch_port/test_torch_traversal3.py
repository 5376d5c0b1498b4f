"""tracer_torch's pair-stream tier (kernels/traversal3.py) and its sorted
twin (traversal2.make_sorted_tracers) vs the JAX package on the CPU: the
pair-grid Pallas kernels in interpret mode, with the reference's PAIR_CHUNK
cut to 512 grid steps a launch to keep the interpreter quick.

One accel (cluster_size=32), built by the JAX package, feeds both sides,
and one cull's words feed both tile passes. The pair stream, the selected slot
`gid` and the occlusion mask are held exact; the best t to rtol 1e-6 and
the slab test's entry distance to rtol 1e-6 (XLA contracts products into
FMAs, the port rounds each)."""
import functools
import re
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh.cluster import build_clusters
from tracer.bvh.cull import cull_clusters_sorted as j_cull_sorted
from tracer.core.types import T_FAR
from tracer.kernels import traversal2 as jt2
from tracer.kernels import traversal3 as jt3
from tracer_torch.bridge import accel_from_arrays, scene_from_arrays
from tracer_torch.bvh.cull import CLUSTER_BITS, WORD_INVALID, cull_clusters_sorted
from tracer_torch.core.intersect import any_hit_brute, intersect_brute
from tracer_torch.core.types import Ray
from tracer_torch.kernels import traversal2 as tt2
from tracer_torch.kernels import traversal3 as tt3
from tracer_torch.kernels._launch import LAUNCHES

from parity_util import bunny_rays, leaves, soup_rays

FIXTURES = {"bunny3": functools.partial(bunny_rays, 64), "soup400": soup_rays}


def _t(x):
    return torch.from_numpy(np.array(x))


def _round8(n):
    return max(8, -(-n // 8) * 8)


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def case(request):
    scene, o_t, d_t = FIXTURES[request.param]()
    accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 32)
    return {"scene": scene, "j_accel": accel, "accel": accel_from_arrays(leaves(accel), "cpu"),
            "o_t": o_t, "d_t": d_t}


def _cull(case, o_t, d_t, t_max):
    """The reference's single-stage sorted cull at a cap that drops nothing."""
    k = _round8(case["accel"].num_clusters)
    words, counts, excess = j_cull_sorted(case["j_accel"], jnp.asarray(o_t), jnp.asarray(d_t),
                                          t_max, k)
    assert int(excess) == 0
    return words, counts


def test_pair_stream_expansion():
    """3 tiles with counts 2, 0, 3: the empty tile emits its sentinel, and
    padding pairs sit on tile 3 (the case of tests/unit/test_traversal3.py)."""
    words = torch.full((3, 4), WORD_INVALID, dtype=torch.int32)
    words[0, :2] = torch.tensor([5, 9])
    words[2, :3] = torch.tensor([1, 2, 3])
    counts = torch.tensor([2, 0, 3], dtype=torch.int32)
    tiles, pwords, total, overflow = tt3.build_pair_stream(words, counts, 8)
    assert total == 6 and overflow is False
    assert tiles.tolist() == [0, 0, 1, 2, 2, 2, 3, 3]
    assert pwords.tolist() == [5, 9, WORD_INVALID, 1, 2, 3, WORD_INVALID, WORD_INVALID]
    # p_cap None: the exact total, no padding pair.
    tiles, pwords, total, overflow = tt3.build_pair_stream(words, counts)
    assert total == 6 and overflow is False
    assert tiles.tolist() == [0, 0, 1, 2, 2, 2]
    # As runs: the same pairs without the empty tile's sentinel.
    offs, run_words, overflow = tt3._tile_stream(words, counts, None)
    assert offs.tolist() == [0, 2, 2, 5] and overflow is False
    assert run_words.tolist() == pwords[pwords != WORD_INVALID].tolist()
    # Under a short p_cap the runs are the clamped stream's pairs.
    offs, run_words, overflow = tt3._tile_stream(words, counts, 3)
    assert overflow is True and offs.tolist() == [0, 1, 1, 2]
    assert run_words.tolist() == [5, 1]


def test_pair_stream_overflow_clamps_far():
    """Under a short p_cap every tile keeps its p_cap // Nt nearest words."""
    words = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    counts = torch.tensor([4, 4, 4], dtype=torch.int32)
    tiles, pwords, total, overflow = tt3.build_pair_stream(words, counts, 6)
    assert overflow is True and total == 6
    assert tiles.tolist() == [0, 0, 1, 1, 2, 2]
    assert pwords.tolist() == [0, 1, 4, 5, 8, 9]


def test_pair_stream_matches_reference(case):
    words, counts = _cull(case, case["o_t"], case["d_t"], T_FAR)
    p_cap = int(np.maximum(np.asarray(counts), 1).sum()) + 7
    want = jt3.build_pair_stream(words, counts, p_cap)
    got = tt3.build_pair_stream(_t(words), _t(counts), p_cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2]) and got[3] == bool(want[3])


def test_slab_enter_matches_reference(case):
    """Ray rows exact (1/d is one IEEE divide on both sides); entry distance
    of every ray into every 5th cluster's box to rtol 1e-6, and the same
    rays miss (enter == T_FAR) on both sides."""
    o_t, d_t = case["o_t"].copy(), case["d_t"].copy()
    d_t[:, ::9] = 0.0          # padding rays
    d_t[:, 1::9, 1] = 0.0      # a degenerate axis
    rt = tt3._ray_rows(_t(o_t), _t(d_t))
    j_rt = jt2._ray_rows(jnp.asarray(o_t), jnp.asarray(d_t))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(j_rt))
    accel, differ = case["accel"], 0
    for cl in range(0, accel.num_clusters, 5):
        lo, hi = accel.cluster_lo[cl], accel.cluster_hi[cl]
        got = tt3._slab_enter(rt, lo[None], hi[None]).numpy()
        box = [float(x) for x in (*lo, *hi)]
        want = np.stack([np.asarray(jt2._slab_enter(j_rt[t], *box))[0]
                         for t in range(rt.shape[0])])
        differ += int(((got >= 1e29) != (want >= 1e29)).sum())
        both = (got < 1e29) & (want < 1e29)
        np.testing.assert_allclose(got[both], want[both], rtol=1e-6, atol=1e-7)
    assert differ == 0


def test_trace_tiles_pairs_matches_pallas(case, monkeypatch):
    monkeypatch.setattr(jt3, "PAIR_CHUNK", 512)
    o_t, d_t = case["o_t"], case["d_t"]
    words, counts = _cull(case, o_t, d_t, T_FAR)
    bt, gid, overflow = jt3.trace_tiles_pairs(
        jnp.asarray(o_t), jnp.asarray(d_t), case["j_accel"], words, counts,
        pairs_per_tile=case["accel"].num_clusters + 1, interpret=True)
    assert not bool(overflow)
    before = dict(LAUNCHES)
    t_bt, t_gid, t_overflow = tt3.trace_tiles_pairs(_t(o_t), _t(d_t), case["accel"], _t(words),
                                                    _t(counts))
    assert t_overflow is False and LAUNCHES == before
    np.testing.assert_array_equal(t_gid.numpy(), np.asarray(gid))
    np.testing.assert_allclose(t_bt.numpy(), np.asarray(bt), rtol=1e-6)
    assert (t_gid.numpy() >= 0).mean() > 0.05, "fixture must hit something"
    # The walk's stops and skips change no result: the exhaustive sorted
    # plain version selects the same slots.
    o4, d4 = tt3._homog(_t(o_t), _t(d_t))
    ex_bt, ex_gid = tt2.closest_hit_plain(o4, d4, case["accel"].tri_w, _t(words), _t(counts),
                                          batch=1)
    np.testing.assert_array_equal(t_gid.numpy(), ex_gid.numpy())
    np.testing.assert_array_equal(t_bt.numpy(), ex_bt.numpy())


def test_any_hit_tiles_pairs_matches_pallas(case, monkeypatch):
    """Surface-like shadow rays: origins 2.5 along the primary rays, directions
    toward a light, some dead (d == 0)."""
    monkeypatch.setattr(jt3, "PAIR_CHUNK", 512)
    o_t, d_t = case["o_t"], case["d_t"]
    light = np.array([0.3, 1.4, 0.2], np.float32)
    so = (o_t + 2.5 * d_t).astype(np.float32)
    sd = light - so
    dist = np.linalg.norm(sd, axis=-1, keepdims=True)
    sd = (sd / dist).astype(np.float32)
    sd[:, ::7] = 0.0
    tm = (dist[..., 0] - 1e-3).astype(np.float32)
    words, counts = _cull(case, so, sd, jnp.asarray(tm))
    occ, overflow = jt3.any_hit_tiles_pairs(
        jnp.asarray(so), jnp.asarray(sd), jnp.asarray(tm), case["j_accel"], words, counts,
        pairs_per_tile=case["accel"].num_clusters + 1, interpret=True)
    assert not bool(overflow)
    t_occ, t_overflow = tt3.any_hit_tiles_pairs(_t(so), _t(sd), _t(tm), case["accel"],
                                                _t(words), _t(counts))
    assert t_overflow is False
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(occ))
    assert 0.0 < t_occ.numpy().mean() < 1.0, "fixture must occlude some rays, not all"
    o4, d4 = tt3._homog(_t(so), _t(sd))
    tmz = torch.where((_t(sd) != 0).any(-1), _t(tm), 0.0)
    np.testing.assert_array_equal(
        t_occ.numpy(),
        tt2.anyhit_plain(o4, d4, tmz, case["accel"].tri_w, _t(words), _t(counts)).numpy())


def test_pair_and_sorted_tracers_match_brute_force(case):
    """make_pair_tracers and make_sorted_tracers on the fixture's rays as one
    (Nt*64,) batch: Hit.tri equal to each other and to brute force, t to
    rtol 1e-5, occlusion exact."""
    scene = scene_from_arrays(leaves(case["scene"]), "cpu")
    ray = Ray(o=_t(case["o_t"]).reshape(-1, 3), d=_t(case["d_t"]).reshape(-1, 3))
    t_max = torch.full(ray.batch_shape, 3.0)
    ref = intersect_brute(ray, scene.verts, scene.tris)
    occ_ref = any_hit_brute(ray, scene.verts, scene.tris, t_max=t_max)
    hits = {}
    for name, factory in (("pair", tt3.make_pair_tracers), ("sorted", tt2.make_sorted_tracers)):
        trace_fn, occlude_fn = factory(scene, case["accel"])
        hits[name] = trace_fn(ray)
        np.testing.assert_array_equal(hits[name].tri.numpy(), ref.tri.numpy())
        np.testing.assert_allclose(hits[name].t.numpy(), ref.t.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(occlude_fn(ray, t_max).numpy(), occ_ref.numpy())
    np.testing.assert_array_equal(hits["pair"].tri.numpy(), hits["sorted"].tri.numpy())
    np.testing.assert_array_equal(hits["pair"].t.numpy(), hits["sorted"].t.numpy())
    assert ref.valid.numpy().mean() > 0.05


def test_tile_passes_report_a_cut_stream(case):
    """An explicit p_cap under the total cuts each tile to its nearest
    candidates and says so; the result still holds the nearest clusters'
    hits (no slot the exact walk did not also consider). The tracers warn
    of a cut stream, and of no other."""
    o_t, d_t = _t(case["o_t"]), _t(case["d_t"])
    words, counts = (_t(x) for x in _cull(case, case["o_t"], case["d_t"], T_FAR))
    _, gid, overflow = tt3.trace_tiles_pairs(o_t, d_t, case["accel"], words, counts,
                                             p_cap=o_t.shape[0])
    assert overflow is True
    _, first, _ = tt3.trace_tiles_pairs(o_t, d_t, case["accel"], words[:, :1],
                                        counts.clamp_max(1))
    np.testing.assert_array_equal(gid.numpy(), first.numpy())
    scene = scene_from_arrays(leaves(case["scene"]), "cpu")
    ray = Ray(o=o_t.reshape(-1, 3), d=d_t.reshape(-1, 3))
    for fn, arg in zip(tt3.make_pair_tracers(scene, case["accel"], p_cap=o_t.shape[0]),
                       ((ray,), (ray, 3.0))):
        with pytest.warns(RuntimeWarning, match="pair-stream overflow"):
            fn(*arg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt3.make_pair_tracers(scene, case["accel"])[0](ray)


@pytest.mark.parametrize("kernel", ["pair_closest", "pair_anyhit"])
def test_pair_wrappers_dispatch_by_device(case, kernel):
    """CPU tensors run the plain version and launch nothing; a tensor on any
    other non-CUDA device raises instead of falling back."""
    accel = case["accel"]
    o4, d4 = tt3._homog(_t(case["o_t"]), _t(case["d_t"]))
    words, counts = _cull(case, case["o_t"], case["d_t"], T_FAR)
    offs, pwords, _ = tt3._tile_stream(_t(words), _t(counts), None)
    args = [o4, d4, accel.tri_w, accel.cluster_lo, accel.cluster_hi, offs, pwords]
    if kernel == "pair_anyhit":
        args.insert(2, torch.ones(o4.shape[:2]))
    before = dict(LAUNCHES)
    getattr(tt3, kernel)(*args)
    assert LAUNCHES == before
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        getattr(tt3, kernel)(*(x.to("meta") for x in args))


# ---------------------------------------------------------------------------
# pair_anyhit_kernel's walk (csrc/traversal3.cu), modelled in plain torch: a
# tile's run in windows of W words, a ray's slab votes over a window as one
# mask (its slices' bits OR-ed), the next tested word the first bit of the
# OR of the unoccluded rays' masks under the stop, a tested cluster's lanes
# split among the slices; the next voted clusters copied ahead into a ring
# of NBUF_PAIR stages, a skipped word's copy waited for unread. The kernels
# cannot run here: the model holds the walk to pair_anyhit_plain.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shadow_pass(case):
    """Surface-like shadow rays of the fixture (those of
    test_any_hit_tiles_pairs_matches_pallas) and the port's single-stage
    cull of them, as the pair kernels take them."""
    o_t, d_t = case["o_t"], case["d_t"]
    light = np.array([0.3, 1.4, 0.2], np.float32)
    so = (o_t + 2.5 * d_t).astype(np.float32)
    sd = light - so
    dist = np.linalg.norm(sd, axis=-1, keepdims=True)
    sd = (sd / dist).astype(np.float32)
    sd[:, ::7] = 0.0
    tm = _t((dist[..., 0] - 1e-3).astype(np.float32))
    words, counts, _ = cull_clusters_sorted(case["accel"], _t(so), _t(sd), tm)
    offs, pwords, _ = tt3._tile_stream(words, counts, None)
    o4, d4 = tt3._homog(_t(so), _t(sd))
    tmz = torch.where((_t(sd) != 0).any(-1), tm, 0.0)
    accel = case["accel"]
    return (o4, d4, tmz, accel.tri_w, accel.cluster_lo, accel.cluster_hi, offs, pwords)


def _pair_anyhit_windows(o4, d4, tmax, w, lo, hi, offs, pwords, slices, window, nbuf):
    """The kernel's walk, tile by tile -> (occ (Nt, TR) bool, clusters
    tested, copies issued); asserts that the ring holds the copy of every
    word the walk tests."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[2] // 3
    mask_cl = (1 << CLUSTER_BITS) - 1
    rt = tt3._ray_rows(o4[..., :3], d4[..., :3])
    lane_slice = (torch.arange(c) // 4) % slices
    occ_all = torch.zeros((n_tiles, tr), dtype=torch.bool)
    tested = issued = 0
    for tile in range(n_tiles):
        run = pwords[offs[tile]:offs[tile + 1]]
        tm, occ = tmax[tile], occ_all[tile]
        for k0 in range(0, run.shape[0], window):
            win = run[k0:k0 + window]
            n = win.shape[0]
            cl = (win & mask_cl).clamp_max(n_cl - 1).long()
            enter = tt3._slab_enter(rt[tile].expand(n, 8, tr), lo[cl], hi[cl])       # (n, TR)
            j_slice = torch.arange(n) % slices
            mask = torch.zeros((tr, n), dtype=torch.bool)
            for s in range(slices):                     # each slice's words, OR-ed
                mask |= ((enter < tm).T & (j_slice == s))
            assert torch.equal(mask, (enter < tm).T)
            inflight, pos, f, stop = [], 0, 0, False
            while True:
                bound = tt3._bits(torch.where(occ, 0.0, tm)).amax()
                votes = (mask & ~occ[:, None]).any(0)
                under = (win & ~mask_cl) < bound
                stop |= not bool(under.all())
                cand = votes & under & (torch.arange(n) >= pos)
                if not cand.any():
                    break
                j = int(torch.nonzero(cand)[0])
                assert len(inflight) < nbuf        # a stage is free
                new = torch.nonzero(cand & (torch.arange(n) >= f))[:nbuf - len(inflight), 0]
                inflight += new.tolist()
                f = int(new[-1]) + 1 if new.numel() else f
                issued += new.numel()
                inflight = [b for b in inflight if b >= j]      # skipped words' copies
                assert inflight[0] == j and inflight == sorted(inflight)
                inflight.pop(0)
                tv = tt2._cluster_t(o4[tile], d4[tile], w[cl[j]], tm[:, None])           # (TR, C)
                hit = torch.zeros(tr, dtype=torch.bool)
                for s in range(slices):                 # each slice's quads, OR-ed
                    hit |= (tv[:, lane_slice == s] < T_FAR).any(-1)
                occ |= hit
                tested += 1
                pos = j + 1
            if stop:
                break
    return occ_all, tested, issued


@pytest.mark.parametrize("slices,window", [(2, 32), (1, 32), (4, 32), (8, 32), (2, 4)])
def test_pair_anyhit_windowed_walk_equals_the_plain_walk(case, shadow_pass, slices, window):
    """The kernel's walk (_pair_anyhit_windows) gives pair_anyhit_plain's
    occlusion on every ray: the slices' OR-ed votes are the ray's votes, the
    first voted word under the stop is the step-by-step walk's next tested
    word, and the ring always holds its copy once the skipped words' copies
    are waited for. Windows of 32 (the kernel's) and of 4 (many window
    changes); ring of NBUF_PAIR stages."""
    want = tt3.pair_anyhit_plain(*shadow_pass)
    occ, tested, issued = _pair_anyhit_windows(*shadow_pass, slices, window, tt3.NBUF_PAIR)
    np.testing.assert_array_equal(occ.numpy(), want.numpy())
    assert 0.0 < want.float().mean() < 1.0 and tested > 0 and issued >= tested


def test_pair_anyhit_ring_holds_the_next_tested_word(shadow_pass):
    """Rings of one and two stages: every tested word's copy is in flight
    when the walk reaches it, whatever was skipped, and the walk still
    equals pair_anyhit_plain."""
    want = tt3.pair_anyhit_plain(*shadow_pass)
    for nbuf in (1, 2):
        occ, tested, issued = _pair_anyhit_windows(*shadow_pass, 2, 32, nbuf)
        np.testing.assert_array_equal(occ.numpy(), want.numpy())
        assert issued >= tested > 0


# ---------------------------------------------------------------------------
# pair_closest_kernel's walk (csrc/traversal3.cu), modelled in plain torch:
# windows of W words whose slab entries a thread computes once (its slices'
# share), a ray's votes the entries below its best t, recomputed after every
# tested cluster; the next tested word the first bit of the OR of the votes
# under the bound; a tested cluster's quads split among the slices, each
# keeping the first lane of its least t, the slices' bests folded by the
# kernel's shuffles; the ring of pair_anyhit_kernel; and on a tile whose live
# rays share ray 0's origin bit for bit, every ray's origin side taken from
# ray 0. The model holds the walk to pair_closest_plain.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def primary_pass(case):
    """The fixture's primary rays (one origin) and the port's single-stage
    cull of them, as pair_closest takes them."""
    o_t, d_t = _t(case["o_t"]), _t(case["d_t"])
    words, counts, _ = cull_clusters_sorted(case["accel"], o_t, d_t, T_FAR)
    offs, pwords, _ = tt3._tile_stream(words, counts, None)
    o4, d4 = tt3._homog(o_t, d_t)
    accel = case["accel"]
    return o4, d4, accel.tri_w, accel.cluster_lo, accel.cluster_hi, offs, pwords


def _one_origin(o4, d4):
    """Per tile: every live ray (some d != 0) starts at ray 0's origin, bit
    for bit -> (Nt,) bool."""
    live = (d4[..., :3] != 0.0).any(-1)
    same = (tt3._bits(o4[..., :3]) == tt3._bits(o4[:, :1, :3])).all(-1)
    return (same | ~live).all(1)


def _slice_fold(tv, slices):
    """A tested cluster's (TR, C) t's: each slice's first lane of its least t
    over its quads (lane // 4 % slices), folded as the kernel's shuffles do
    (xor offsets slices/2 .. 1, smaller t, on equal t the smaller lane), read
    at slice 0 -> (t (TR,), lane (TR,))."""
    c = tv.shape[-1]
    lane = torch.arange(c)
    best = []
    for s in range(slices):
        mine = (lane // 4) % slices == s
        t = torch.where(mine, tv, T_FAR).amin(-1)
        first = torch.where(mine & (tv == t[:, None]), lane, c).amin(-1)
        best.append((t, torch.where(t < T_FAR, first, 0)))
    off = slices // 2
    while off:
        nxt = []
        for s in range(slices):
            (ta, la), (tb, lb) = best[s], best[s ^ off]
            take = (tb < ta) | ((tb == ta) & (lb < la))
            nxt.append((torch.where(take, tb, ta), torch.where(take, lb, la)))
        best, off = nxt, off // 2
    return best[0]


def _pair_closest_windows(o4, d4, w, lo, hi, offs, pwords, slices, window, nbuf,
                          shared=None):
    """The kernel's walk, tile by tile -> (bt (Nt, TR), bid (Nt, TR),
    clusters tested, copies issued, tiles that took the shared origin).
    `shared` None decides per tile as the kernel does (_one_origin); True
    forces ray 0's origin on every tile. Asserts that the slices' masks
    make up the ray's votes and that the ring holds the copy of every word
    the walk tests."""
    n_tiles, tr, _ = o4.shape
    n_cl, c = w.shape[0], w.shape[2] // 3
    mask_cl = (1 << CLUSTER_BITS) - 1
    rt = tt3._ray_rows(o4[..., :3], d4[..., :3])
    one = _one_origin(o4, d4) if shared is None else torch.full((n_tiles,), shared)
    bt_all = torch.full((n_tiles, tr), T_FAR)
    bid_all = torch.full((n_tiles, tr), -1, dtype=torch.int32)
    tested = issued = 0
    for tile in range(n_tiles):
        run = pwords[offs[tile]:offs[tile + 1]]
        bt, bid = bt_all[tile], bid_all[tile]
        o_side = o4[tile, :1].expand(tr, 4) if bool(one[tile]) else o4[tile]
        for k0 in range(0, run.shape[0], window):
            win = run[k0:k0 + window]
            n = win.shape[0]
            cl = (win & mask_cl).clamp_max(n_cl - 1).long()
            enter = tt3._slab_enter(rt[tile].expand(n, 8, tr), lo[cl], hi[cl]).T      # (TR, n)
            j_slice = torch.arange(n) % slices
            inflight, pos, f, stop = [], 0, 0, False
            while True:
                mask = torch.zeros((tr, n), dtype=torch.bool)
                for s in range(slices):                 # each slice's words, OR-ed
                    mask |= (enter < bt[:, None]) & (j_slice == s)
                assert torch.equal(mask, enter < bt[:, None])
                votes, bound = mask.any(0), tt3._bits(bt).amax()
                under = (win & ~mask_cl) < bound
                stop |= not bool(under.all())
                cand = votes & under & (torch.arange(n) >= pos)
                if not cand.any():
                    break
                j = int(torch.nonzero(cand)[0])
                assert len(inflight) < nbuf        # a stage is free
                new = torch.nonzero(cand & (torch.arange(n) >= f))[:nbuf - len(inflight), 0]
                inflight += new.tolist()
                f = int(new[-1]) + 1 if new.numel() else f
                issued += new.numel()
                inflight = [b for b in inflight if b >= j]      # skipped words' copies
                assert inflight[0] == j and inflight == sorted(inflight)
                inflight.pop(0)
                t, lane = _slice_fold(tt2._cluster_t(o_side, d4[tile], w[cl[j]], T_FAR), slices)
                better = t < bt
                bid[:] = torch.where(better, int(cl[j]) * c + lane.int(), bid)
                bt[:] = torch.where(better, t, bt)
                tested += 1
                pos = j + 1
            if stop:
                break
    return bt_all, bid_all, tested, issued, int(one.sum())


def _ulp_origin(primary_pass):
    """The primary pass with one ray of every tile started one ulp away in
    each coordinate (the first ray with a hit in its tile, so that the
    change can show; a coordinate of 0 moves to a denormal, which rounds
    away)."""
    o4, d4, w, lo, hi, offs, pwords = primary_pass
    bid = tt3.pair_closest_plain(*primary_pass)[1]
    r = (bid >= 0).int().argmax(1)
    o4 = o4.clone()
    rows = torch.arange(o4.shape[0])
    xyz = o4[rows, r, :3].numpy()
    o4[rows, r, :3] = torch.from_numpy(np.nextafter(xyz, np.float32(np.inf)).astype(np.float32))
    return (o4, d4, w, lo, hi, offs, pwords)


def _slice_tie(primary_pass):
    """The primary pass with the most-hit triangle of its most-hit cluster
    copied to the lane 4 away (the next or the previous quad, so another
    slice): two lanes of one cluster give the same t -> (the pass, the lane
    that must win, the lane that must not)."""
    o4, d4, w, lo, hi, offs, pwords = primary_pass
    c = w.shape[2] // 3
    bid = tt3.pair_closest_plain(*primary_pass)[1]
    y, lane = divmod(int(torch.mode(bid[bid >= 0]).values), c)
    other = lane + 4 if lane + 4 < c else lane - 4
    w = w.clone()
    for f in range(3):
        w[y, :, f * c + other] = w[y, :, f * c + lane]
    return (o4, d4, w, lo, hi, offs, pwords), y * c + min(lane, other), y * c + max(lane, other)


@pytest.mark.parametrize("slices,window", [(2, 32), (1, 32), (4, 32), (2, 4), (1, 4), (4, 4)])
@pytest.mark.parametrize("rays", ["primary", "shadow", "ulp_origin", "slice_tie"])
def test_pair_closest_windowed_walk_equals_the_plain_walk(primary_pass, shadow_pass, rays,
                                                          slices, window):
    """The kernel's walk (_pair_closest_windows) gives pair_closest_plain's bt
    bits and bid on every ray, with rings of 1, 2 and NBUF_PAIR_CLOSEST
    stages: on the fixture's primary rays (one origin: the shared path on
    every tile), on shadow_pass's surface origins (the general path), with
    one ray of every primary tile one ulp off (the general path; ray 0's
    origin forced on those tiles would change a result), and with a tie of
    equal t across two slices (the lower lane wins)."""
    args, win, lose = primary_pass, None, None
    if rays == "shadow":
        o4, d4, _, w, lo, hi, offs, pwords = shadow_pass
        args = (o4, d4, w, lo, hi, offs, pwords)
    elif rays == "ulp_origin":
        args = _ulp_origin(primary_pass)
    elif rays == "slice_tie":
        args, win, lose = _slice_tie(primary_pass)
    want = tt3.pair_closest_plain(*args)
    n_tiles = args[0].shape[0]
    for nbuf in sorted({1, 2, tt3.NBUF_PAIR_CLOSEST}):
        bt, bid, tested, issued, n_shared = _pair_closest_windows(*args, slices, window, nbuf)
        np.testing.assert_array_equal(tt3._bits(bt).numpy(), tt3._bits(want[0]).numpy())
        np.testing.assert_array_equal(bid.numpy(), want[1].numpy())
        assert issued >= tested > 0
    assert (want[1] >= 0).float().mean() > 0.05
    if rays in ("primary", "slice_tie"):
        assert n_shared == n_tiles
    else:
        assert n_shared < n_tiles
    if rays == "ulp_origin":
        assert n_shared == 0
        forced = _pair_closest_windows(*args, slices, window, tt3.NBUF_PAIR_CLOSEST, shared=True)
        assert not torch.equal(tt3._bits(forced[0]), tt3._bits(want[0])), \
            "the one-ulp origins must change some result under ray 0's origin"
    if rays == "slice_tie":
        assert (want[1] == win).any() and not (want[1] == lose).any()


def test_pair_constants_pinned_to_the_kernel():
    """SLICES_PAIR, WINDOW and NBUF_PAIR are csrc/traversal3.cu's
    kSlicesPair, kWindow and kNBufPair, SLICES_PAIR_CLOSEST and
    NBUF_PAIR_CLOSEST its kSlicesPairClosest and kNBufPairClosest; a window
    is one 32-bit vote mask (one word a lane of a warp), a block of either
    kernel 2 * 64 = 128 threads for a tile of 64 rays (the kernels cannot
    run here: their constants and launch lines are read from the source)."""
    src = (Path(tt3.__file__).parent / "csrc" / "traversal3.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kSlicesPair"]), int(consts["kWindow"]), int(consts["kNBufPair"])) == (
        tt3.SLICES_PAIR, tt3.WINDOW, tt3.NBUF_PAIR) == (2, 32, 4)
    assert (int(consts["kSlicesPairClosest"]), int(consts["kNBufPairClosest"])) == (
        tt3.SLICES_PAIR_CLOSEST, tt3.NBUF_PAIR_CLOSEST) == (2, 2)
    assert "pair_anyhit_kernel<<<n_tiles, kSlicesPair * tr, smem," in src
    assert "pair_closest_kernel<<<n_tiles, kSlicesPairClosest * tr, smem," in src
    assert "__maxnreg__(kRegsPairClosest) pair_closest_kernel(" in src
    assert "WindowCopies<kNBufPair> copies{" in src
    assert "WindowCopies<kNBufPairClosest> copies{" in src
    assert '#include "sorted.cuh"' in src
    for slices in (tt3.SLICES_PAIR, tt3.SLICES_PAIR_CLOSEST):
        assert slices * 64 == 128 and 32 % slices == 0
