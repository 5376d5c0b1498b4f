"""tracer_torch.dist.ring against tracer.dist.ring on the CPU.

Single-process pieces on the same inputs (the reference's scene arrays fed
to the port through tracer_torch.bridge; the reference's accel passes
jitted, the rest run eagerly): the packed rows and their padding bit for
bit; the shard-local accel exactly
(order, tri_ids, bounds; tri_w to rtol 1e-6); the brute hit distances and
the accel passes (t to rtol 1e-6; rows, occlusion and the k-cap's excess
exact), uncapped and at a cap of 2 that drops candidates; the shading of a
cornell 32x32 wavefront.

Multi-rank: one world of 4 gloo ranks (tracer_torch.dist.mesh.spawn_world,
the rank function dist_workers.ring_world) renders make_ring_render_fn at
(data, geom) = (2, 2) and (1, 4), ring and reduce: brute on the cornell box
at 32x32 with 2 bounces, the accel uncapped on the bunny-grad scene at
32x32 (several clusters a shard), and at (2, 2) the accel at a k_cap of 2;
each image is held to the reference's make_ring_render_fn on the first 4
of the 8 virtual devices under tests/dist/gates.py:dist_check, every
rank's result equal, and the overflow equal to the reference's (over 0 at
the cap, 0 otherwise). The cameras look 0.0123 and 0.0071 off their points."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.dist.gates import dist_check
from tracer.api import get_scene as j_get_scene
from tracer.core.camera import generate_rays as j_generate_rays
from tracer.dist import ring as jring
from tracer.dist.mesh import make_render_mesh as j_make_render_mesh
from tracer.render.whitted import WhittedConfig as JWhittedConfig
from tracer.utils.config import load_config as j_load_config
from tracer_torch.bridge import scene_from_arrays
from tracer_torch.core.types import RAY_EPS
from tracer_torch.dist import ring
from tracer_torch.dist.mesh import spawn_world
from tracer_torch.render.whitted import WhittedConfig
from tracer_torch.utils.config import load_config

import dist_workers
from parity_util import leaves

FIELDS = dict(height=32, width=32, max_bounces=2)
J_CFG = j_load_config("cornell256", **FIELDS)
CFG = load_config("cornell256", **FIELDS)
BIG = dict(height=32, width=32)
J_BIG = j_load_config("bunny-grad", **BIG)
CFG_BIG = load_config("bunny-grad", **BIG)
LAYOUTS = ((2, 2), (1, 4))
ACCEL_FIELDS = ("tri_w", "tri_ids", "cluster_lo", "cluster_hi", "super_lo", "super_hi", "shade")
# The reference's accel passes, compiled: eagerly they take seconds each.
# (Its accel build stays eager: compiled, XLA contracts tri_w's products.)
j_accel_trace_rows = jax.jit(jring.accel_trace_rows, static_argnames=("k_cap",))
j_accel_any_hit = jax.jit(jring.accel_any_hit, static_argnames=("k_cap",))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def off_centre(camera):
    """The camera looking 0.0123 and 0.0071 off its point: at the presets'
    cameras pixel centres lie exactly on projected edges, where the last
    bit of a ray direction picks the triangle."""
    return dataclasses.replace(camera, look_at=camera.look_at + jnp.array([0.0123, 0.0, 0.0071]))


@pytest.fixture(scope="module")
def cornell():
    scene, camera = j_get_scene(J_CFG)
    return scene, off_centre(camera)


@pytest.fixture(scope="module")
def bunny():
    scene, camera = j_get_scene(J_BIG)
    return scene, off_centre(camera)


def _rays(camera, size=32):
    rays = j_generate_rays(camera, size, size)
    return np.asarray(rays.o).reshape(-1, 3), np.asarray(rays.d).reshape(-1, 3)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("which", ["cornell", "bunny"])
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_pack_and_pad_rows_bit_equal(which, shards, cornell, bunny):
    scene, _ = cornell if which == "cornell" else bunny
    want = np.asarray(jring.pad_rows_to_shards(jring.pack_tri_rows(scene), shards))
    got = ring.pad_rows_to_shards(ring.pack_tri_rows(scene_from_arrays(leaves(scene), "cpu")),
                                  shards)
    assert got.shape == want.shape and got.shape[0] % shards == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shard", ["whole", "padded"])
def test_build_rows_accel_matches(shard, bunny, bunny_accel):
    if shard == "whole":
        want, got = bunny_accel[:2]
    else:  # the last of 3 shards holds the padding rows
        padded = jring.pad_rows_to_shards(jring.pack_tri_rows(bunny[0]), 3)
        rows = padded.reshape(3, -1, padded.shape[1])[2]
        assert float(jnp.min(rows[:, 25])) == 0.0
        want = jring.build_rows_accel(rows)
        got = ring.build_rows_accel(_t(rows))
    for f in ACCEL_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        if f == "tri_w":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_rows_hit_and_nearest_row_match(cornell):
    scene, camera = cornell
    o, d = _rays(camera)
    rows = jring.pack_tri_rows(scene)
    want = np.asarray(jring._rows_hit(jnp.asarray(o), jnp.asarray(d), rows, 1e-4, 1e30))
    got = ring._rows_hit(_t(o), _t(d), _t(rows), 1e-4, 1e30).numpy()
    np.testing.assert_array_equal(got < 1e30, want < 1e30)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (want < 1e30).any(-1).mean() > 0.9
    wt, wrow = jring._nearest_row(jnp.asarray(want), rows)
    gt, grow = ring._nearest_row(_t(want), _t(rows))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(grow.numpy(), np.asarray(wrow))


@pytest.fixture(scope="module")
def bunny_accel(bunny):
    scene, camera = bunny
    rows = jring.pack_tri_rows(scene)
    o, d = _rays(camera)
    rng = np.random.default_rng(0)
    tmax = rng.uniform(0.0, 6.0, o.shape[0]).astype(np.float32)
    return jring.build_rows_accel(rows), ring.build_rows_accel(_t(rows)), o, d, tmax


@pytest.mark.parametrize("k_cap", [None, 2])
def test_accel_trace_rows_matches(k_cap, bunny_accel):
    ja, ta, o, d, _ = bunny_accel
    wt, wrow, wex = j_accel_trace_rows(jnp.asarray(o), jnp.asarray(d), ja, k_cap=k_cap)
    gt, grow, gex = ring.accel_trace_rows(_t(o), _t(d), ta, k_cap=k_cap)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-6)
    np.testing.assert_array_equal(grow.numpy(), np.asarray(wrow))
    assert int(gex) == int(wex)
    assert (int(gex) > 0) == (k_cap is not None)
    assert (np.asarray(wt) < 1e30).mean() > 0.2


@pytest.mark.parametrize("k_cap", [None, 2])
def test_accel_any_hit_matches(k_cap, bunny_accel):
    ja, ta, o, d, tmax = bunny_accel
    wocc, wex = j_accel_any_hit(jnp.asarray(o), jnp.asarray(d), ja, jnp.asarray(tmax),
                                 k_cap=k_cap)
    gocc, gex = ring.accel_any_hit(_t(o), _t(d), ta, _t(tmax), k_cap=k_cap)
    np.testing.assert_array_equal(gocc.numpy(), np.asarray(wocc))
    assert int(gex) == int(wex)
    assert (int(gex) > 0) == (k_cap is not None)
    assert 0.05 < np.asarray(wocc).mean() < 0.95


@pytest.mark.parametrize("smooth", [False, True])
def test_shade_rows_matches(smooth, cornell):
    """_shade_rows on the cornell box's 32x32 primary wavefront, from the
    reference's brute nearest hits, each package's occluder over the rows."""
    scene, camera = cornell
    o, d = _rays(camera)
    rows = jring.pack_tri_rows(scene)
    t, hit_rows, _ = jring._rows_trace_local(jnp.asarray(o), jnp.asarray(d), rows, 1e-4, 1e30)
    lp, li = scene.lights.position, scene.lights.intensity
    want = jring._shade_rows(
        lp, li, jnp.asarray(o), jnp.asarray(d), t, hit_rows,
        lambda so, sd, tm: jring._rows_any_local(so, sd, rows, RAY_EPS, tm),
        JWhittedConfig(smooth_shading=smooth))
    trows = _t(rows)
    got = ring._shade_rows(
        _t(lp), _t(li), _t(o), _t(d), _t(t), _t(hit_rows),
        lambda so, sd, tm: ring._rows_any_local(so, sd, trows, RAY_EPS, tm),
        WhittedConfig(smooth_shading=smooth))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for w, g in zip(want[1:5], got[1:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert int(got[5]) == int(want[5]) == 0
    assert float(np.asarray(want[4]).max()) > 0.05


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------

# The brute tier on the cornell box (2 bounces: its mirror), the accel tier
# uncapped on bunny-grad (1 bounce, several clusters a shard), both at each
# layout, ring and reduce; then the accel at a cap of 2 on (2, 2).
CASES = ([("cornell", layout, use_ring, False, None) for layout in LAYOUTS
          for use_ring in (True, False)]
         + [("bunny", layout, use_ring, True, None) for layout in LAYOUTS
            for use_ring in (True, False)]
         + [("bunny", (2, 2), use_ring, True, 2) for use_ring in (True, False)])


def _reference(case, cornell, bunny):
    """The reference's make_ring_render_fn of the case on the first 4 of the
    virtual devices -> (image, overflow)."""
    name, layout, use_ring, use_accel, k_cap = case
    scene, camera = cornell if name == "cornell" else bunny
    cfg = J_CFG if name == "cornell" else J_BIG
    mesh = j_make_render_mesh(jax.devices()[:4], *layout)
    img, aux = jring.make_ring_render_fn(scene, cfg, mesh, use_ring=use_ring,
                                         use_accel=use_accel, with_aux=True,
                                         k_cap=k_cap)(scene, camera)
    return np.asarray(img), int(aux["overflow"])


@pytest.fixture(scope="module")
def world(cornell, bunny):
    """(every rank's results of dist_workers.ring_world, {case: the
    reference's (image, overflow)}). The ranks run while the reference
    compiles its cases, four at a time."""
    scenes = {"cornell": (leaves(cornell[0]), leaves(cornell[1]), CFG),
              "bunny": (leaves(bunny[0]), leaves(bunny[1]), CFG_BIG)}
    with ThreadPoolExecutor(1) as ranks, ThreadPoolExecutor(4) as refs:
        got = ranks.submit(spawn_world, dist_workers.ring_world, 4, scenes, CASES, device="cpu")
        want = dict(zip(CASES, refs.map(partial(_reference, cornell=cornell, bunny=bunny),
                                        CASES)))
        return got.result(), want


def _check_case(world, case):
    """Every rank's (image, overflow) of the case equal; the image under
    dist_check of the reference's; the overflow the reference's."""
    ranks, refs = world
    want, want_overflow = refs[case]
    got, overflow = ranks[0][case]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[case][0], got)
        assert res[case][1] == overflow
    assert got.shape == want.shape and want.max() > 0.05
    dist_check(got, want)
    assert overflow == want_overflow
    return overflow


@pytest.mark.parametrize("use_accel", [False, True], ids=["brute", "accel"])
@pytest.mark.parametrize("use_ring", [True, False], ids=["ring", "reduce"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=["2x2", "1x4"])
def test_ring_render_matches_reference(layout, use_ring, use_accel, world):
    name = "bunny" if use_accel else "cornell"
    assert _check_case(world, (name, layout, use_ring, use_accel, None)) == 0


@pytest.mark.parametrize("use_ring", [True, False], ids=["ring", "reduce"])
def test_ring_accel_overflow_matches_reference(use_ring, world):
    assert _check_case(world, ("bunny", (2, 2), use_ring, True, 2)) > 0
