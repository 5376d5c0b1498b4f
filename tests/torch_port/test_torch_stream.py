"""tracer_torch's streamed tier (kernels/stream.py, plain versions of its
CUDA kernels on the CPU) vs the JAX package's streamed kernels in interpret
mode, and vs brute force.

One accel, built by the JAX package with cluster_size=32 (many candidates
per tile, so the kernels' ring of NBUF stages wraps many times), feeds both
sides through tracer_torch.bridge, and one cull's words feed both drivers.
Tolerances: the selected slot, the triangle id and occlusion exact; best t
rtol 1e-6 (XLA contracts the reference's products into FMAs, the port
rounds each product, as its kernels do); recovered uv atol 1e-5 plus rtol
1e-4 (Moller-Trumbore's u = (tvec . pvec) / det, which XLA evaluates with
FMAs, over the soup's tiny triangles, whose det is small). Brute force is
held to t rtol 1e-5 (a different formulation of the same hit)."""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh.cluster import build_clusters
from tracer.core.intersect import any_hit_brute as j_any_hit_brute
from tracer.core.intersect import intersect_brute as j_intersect_brute
from tracer.core.types import Ray as JRay
from tracer.core.types import T_FAR
from tracer.kernels import stream as jstream
from tracer.bvh import cull as jcull
from tracer_torch.bridge import accel_from_arrays, scene_from_arrays
from tracer_torch.core import intersect as ti
from tracer_torch.core.types import Ray
from tracer_torch.kernels import stream as ts
from tracer_torch.kernels import traversal2 as tt2

from parity_util import bunny_rays, exact_cull, leaves, segment_list, soup_rays

FIXTURES = {"bunny3": functools.partial(bunny_rays, 32), "soup400": soup_rays}


def _occlusion_rays(o_t, d_t):
    """The fixture's rays as shadow-like queries: per-ray t_max from a seeded
    draw, every 7th ray dead (d == 0) with t_max 1e30, as a missed
    receiver's shadow ray carries into the cull."""
    rng = np.random.default_rng(3)
    sd = d_t.copy()
    sd[:, ::7] = 0.0
    tm = rng.uniform(0.8, 3.5, size=o_t.shape[:2]).astype(np.float32)
    tm[:, ::7] = 1e30
    return o_t, sd, tm


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def case(request):
    scene, o_t, d_t = FIXTURES[request.param]()
    accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 32)
    return dict(name=request.param, scene=scene, accel=accel, o_t=o_t, d_t=d_t,
                t_scene=scene_from_arrays(leaves(scene), "cpu"),
                t_accel=accel_from_arrays(leaves(accel), "cpu"))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_trace_tiles_streamed_matches_pallas(case):
    o_t, d_t, accel = case["o_t"], case["d_t"], case["accel"]
    words, counts = exact_cull(accel, o_t, d_t, T_FAR)
    c = np.array(counts)
    assert c.max() > 2 * ts.NBUF, "the ring must wrap more than once"
    bt, gid = jax.jit(functools.partial(jstream.trace_tiles_streamed, interpret=True))(
        jnp.asarray(o_t), jnp.asarray(d_t), accel, words, counts)
    t_bt, t_gid = ts.trace_tiles_streamed(_t(o_t), _t(d_t), case["t_accel"], _t(words), _t(c))
    np.testing.assert_array_equal(t_gid.numpy(), np.asarray(gid))
    np.testing.assert_allclose(t_bt.numpy(), np.asarray(bt), rtol=1e-6)
    assert (t_gid.numpy() >= 0).mean() > 0.05, "fixture must hit something"


def test_any_hit_tiles_streamed_matches_pallas(case):
    so, sd, tm = _occlusion_rays(case["o_t"], case["d_t"])
    accel = case["accel"]
    words, counts = exact_cull(accel, so, sd, jnp.asarray(tm))
    occ = jax.jit(functools.partial(jstream.any_hit_tiles_streamed, interpret=True))(
        jnp.asarray(so), jnp.asarray(sd), jnp.asarray(tm), accel, words, counts)
    t_occ = ts.any_hit_tiles_streamed(_t(so), _t(sd), _t(tm), case["t_accel"], _t(words),
                                      _t(counts))
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(occ))
    assert not t_occ.numpy()[:, ::7].any(), "dead rays are never occluded"
    assert 0.0 < t_occ.numpy().mean() < 1.0, "fixture must occlude some rays, not all"


def _jax_tracers(case, monkeypatch):
    """The reference's streamed tracers with caps that drop nothing, on the
    exact f32 box fetch so that its needs are the port's. With more than one
    supercluster, k stays below the cluster count so that the reference
    runs (and measures the needs of) its two-stage cull, s = every
    supercluster; with one, it takes every cluster."""
    accel = case["accel"]
    monkeypatch.setattr(jstream, "cull_clusters_sorted2",
                        functools.partial(jcull.cull_clusters_sorted2, bf16_fetch=False))
    n_cl = accel.num_clusters
    k = (n_cl - 1) // 8 * 8 if accel.super_lo.shape[0] > 1 else n_cl
    return jstream.make_streamed_tracers_aux(case["scene"], accel, k_cap=k,
                                             s_cap=accel.super_lo.shape[0], interpret=True)


def _rays(case):
    """The fixture's tiled rays back in their (H, W, 3) image layout."""
    o_t, d_t = case["o_t"], case["d_t"]
    side = int(round((o_t.shape[0] * o_t.shape[1]) ** 0.5))
    untile = lambda x: x.reshape(side // 8, side // 8, 8, 8, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(side, side, 3)
    return untile(o_t), untile(d_t)


def test_streamed_tracers_match_reference(case, monkeypatch):
    """make_streamed_tracers_aux, closest and occlusion: the recovered hits,
    the occlusion and the cull's needs equal the reference's."""
    o, d = _rays(case)
    j_trace, j_occlude = _jax_tracers(case, monkeypatch)
    t_trace, t_occlude = ts.make_streamed_tracers_aux(case["t_scene"], case["t_accel"])
    j_hit, j_aux = jax.jit(j_trace)(JRay(o=jnp.asarray(o), d=jnp.asarray(d)))
    hit, aux = t_trace(Ray(o=_t(o), d=_t(d)))
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(j_hit.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(j_hit.t), rtol=1e-6)
    np.testing.assert_allclose(hit.uv.numpy(), np.asarray(j_hit.uv), rtol=1e-4, atol=1e-5)

    _, sd, tm = _occlusion_rays(*(x.reshape(1, -1, 3) for x in (o, d)))
    sd, tm = sd.reshape(d.shape), tm.reshape(d.shape[:2])
    j_occ, j_oaux = jax.jit(j_occlude)(JRay(o=jnp.asarray(o), d=jnp.asarray(sd)),
                                       jnp.asarray(tm))
    occ, oaux = t_occlude(Ray(o=_t(o), d=_t(sd)), _t(tm))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occ))
    for a, ja in ((aux, j_aux), (oaux, j_oaux)):
        assert int(a["excess"]) == 0 and int(ja["excess"]) == 0
        if case["accel"].super_lo.shape[0] > 1:  # else the reference reports 0: moot
            assert (a["need_k"], a["need_s"]) == (int(ja["need_k"]), int(ja["need_s"]))


def test_streamed_tracers_match_brute(case):
    """The port's streamed tracers against the port's brute force."""
    o, d = _rays(case)
    trace, occlude = ts.make_streamed_tracers(case["t_scene"], case["t_accel"])
    ray = Ray(o=_t(o), d=_t(d))
    got = trace(ray)
    want = ti.intersect_brute(ray, case["t_scene"].verts, case["t_scene"].tris)
    m = want.valid.numpy()
    np.testing.assert_array_equal(got.valid.numpy(), m)
    assert m.mean() > 0.05
    np.testing.assert_array_equal(got.tri.numpy()[m], want.tri.numpy()[m])
    np.testing.assert_allclose(got.t.numpy()[m], want.t.numpy()[m], rtol=1e-5, atol=1e-6)
    tm = torch.full(ray.batch_shape, 2.5)
    np.testing.assert_array_equal(
        occlude(ray, tm).numpy(),
        ti.any_hit_brute(ray, case["t_scene"].verts, case["t_scene"].tris, t_max=tm).numpy())


def test_brute_tracers_match_reference(case, monkeypatch):
    """intersect_brute / any_hit_brute against the JAX package's, with the
    ray chunking forced to several chunks. uv to atol 1e-4: u = so_u +
    t*sd_u cancels, and the (R, 4) x (4, 3T) products sum in another order
    (and with FMAs) in XLA's dot than in torch's matmul."""
    monkeypatch.setattr(ti, "_BRUTE_BYTES", 1 << 20)
    o, d = _rays(case)
    scene = case["scene"]
    j_ray = JRay(o=jnp.asarray(o), d=jnp.asarray(d))
    ray = Ray(o=_t(o), d=_t(d))
    want = jax.jit(j_intersect_brute)(j_ray, scene.verts, scene.tris)
    got = ti.intersect_brute(ray, case["t_scene"].verts, case["t_scene"].tris)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    m = got.valid.numpy()
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(want.t)[m], rtol=1e-5)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), rtol=0, atol=1e-4)
    tm = np.random.default_rng(5).uniform(0.5, 3.0, size=o.shape[:2]).astype(np.float32)
    j_occ = jax.jit(j_any_hit_brute)(j_ray, scene.verts, scene.tris, t_max=jnp.asarray(tm))
    occ = ti.any_hit_brute(ray, case["t_scene"].verts, case["t_scene"].tris, t_max=_t(tm))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occ))
    assert 0.0 < occ.numpy().mean() < 1.0


def test_stream_kernels_and_plain_versions_share_b_and_nbuf():
    """The plain versions are traversal2's at B = STREAM_BATCH, whose tie
    rule they share with the kernels, and csrc/stream.cu is built for the
    same B and ring depth (the kernels cannot run here: their constants
    are read from the source)."""
    src = (Path(ts.__file__).parent / "csrc" / "stream.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kBatch"]), int(consts["kNBuf"])) == (ts.STREAM_BATCH, ts.NBUF) == (2, 4)
    for plain, base in ((ts.closest_stream_plain, tt2.closest_hit_plain),
                        (ts.anyhit_stream_plain, tt2.anyhit_plain)):
        assert plain.func is base and plain.keywords == {"batch": ts.STREAM_BATCH}


def test_stream_wrappers_dispatch_by_device(case):
    """CPU tensors run the plain version and launch nothing; a tensor on
    any other non-CUDA device raises instead of falling back."""
    t_accel = case["t_accel"]
    o4 = _t(np.concatenate([case["o_t"], np.ones_like(case["o_t"][..., :1])], -1))
    d4 = _t(np.concatenate([case["d_t"], np.zeros_like(case["d_t"][..., :1])], -1))
    n = o4.shape[0]
    words = torch.zeros((n, 8), dtype=torch.int32)
    counts = torch.ones(n, dtype=torch.int32)
    tm = torch.ones(o4.shape[:2])
    before = dict(tt2.LAUNCHES)
    np.testing.assert_array_equal(
        ts.closest_stream(o4, d4, t_accel.tri_w, words, counts)[1].numpy(),
        tt2.closest_hit_plain(o4, d4, t_accel.tri_w, words, counts, batch=2)[1].numpy())
    ts.anyhit_stream(o4, d4, tm, t_accel.tri_w, words, counts)
    assert tt2.LAUNCHES == before
    meta = lambda x: x.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        ts.closest_stream(*map(meta, (o4, d4, t_accel.tri_w, words, counts)))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        ts.anyhit_stream(*map(meta, (o4, d4, tm, t_accel.tri_w, words, counts)))


def test_anyhit_stream_plain_by_segments_equals_whole(case):
    """The streamed any-hit kernel walks the same segments as traversal2's
    (_launch.run_segments) at B = STREAM_BATCH: anyhit_plain at that B
    applied segment by segment and OR-ed equals it over the whole lists,
    and a segment is a whole number of steps."""
    assert tt2.SEG % ts.STREAM_BATCH == 0
    so, sd, tm = _occlusion_rays(case["o_t"], case["d_t"])
    words, counts = exact_cull(case["accel"], so, sd, jnp.asarray(tm))
    words, counts = _t(words), _t(counts)
    o4 = _t(np.concatenate([so, np.ones_like(so[..., :1])], -1))
    d4 = _t(np.concatenate([sd, np.zeros_like(sd[..., :1])], -1))
    tm = torch.where((d4 != 0).any(-1), _t(tm), 0.0)
    w = case["t_accel"].tri_w
    whole = ts.anyhit_stream_plain(o4, d4, tm, w, words, counts)
    tile, k0 = map(torch.from_numpy, segment_list(
        *tt2.run_segments(counts, tt2.SEG, words.shape[1]), tt2.SEG))
    assert tile.shape[0] > o4.shape[0], "some tile must hold more than one segment"
    pad = torch.nn.functional.pad(words, (0, tt2.SEG))
    seg_words = pad[tile[:, None], k0[:, None] + torch.arange(tt2.SEG)]
    seg_counts = (counts[tile] - k0).clamp_max(tt2.SEG).int()
    occ_seg = ts.anyhit_stream_plain(o4[tile], d4[tile], tm[tile], w, seg_words, seg_counts)
    ored = torch.zeros(whole.shape, dtype=torch.int32).index_put_(
        (tile,), occ_seg.int(), accumulate=True) > 0
    np.testing.assert_array_equal(ored.numpy(), whole.numpy())
    assert 0.0 < whole.float().mean() < 1.0


def test_anyhit_stream_entry_points():
    """csrc/stream.cu exports one entry point a kernel, the ones the
    wrappers launch and kernels/_build.py declares."""
    import inspect

    from tracer_torch.kernels import _build

    src = (Path(ts.__file__).parent / "csrc" / "stream.cu").read_text()
    exported = re.findall(r"^int (st_\w+)\(", src, flags=re.M)
    assert exported == ["st_closest", "st_anyhit"]
    assert exported == [e for e in _build._SIGNATURES if e.startswith("st_")]
    for entry, wrapper in zip(exported, (ts.closest_stream, ts.anyhit_stream)):
        assert f'"{entry}"' in inspect.getsource(wrapper)
