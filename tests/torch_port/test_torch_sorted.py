"""tracer_torch's whole-tile-set passes, trace_tiles_sorted and
any_hit_tiles_sorted, against the JAX package's (Pallas in interpret mode,
at B = 4, the port's kernels' B) and against the port's own split passes.

As in test_torch_traversal2.py, one accel built by the JAX package feeds
both sides (tracer_torch.bridge.accel_from_arrays) and one exact cull's
words (bf16_fetch=False) feed both sides. Slot and occlusion are held
exact; the best t to rtol 1e-6 (XLA contracts the reference's products into
FMAs, the port rounds each product). Against trace_tiles_split and
any_hit_tiles_graded, which run the same plain versions over other tile
orders and regions, everything is bit-equal."""
import functools

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

from parity_util import bunny_rays, exact_cull, leaves, soup_rays

FIXTURES = {"bunny3": functools.partial(bunny_rays, 64), "soup400": soup_rays}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small CPU ops: one intra-op thread, the caller's setting
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def case(request):
    scene, o_t, d_t = FIXTURES[request.param]()
    accel = jax.jit(build_clusters, static_argnums=2)(scene.verts, scene.tris, 32)
    words, counts = exact_cull(accel, o_t, d_t, T_FAR)
    # Light-origin segments to points along the primary rays, a seventh of
    # them dead (d == 0), as test_torch_traversal2.py's any-hit case.
    light = np.array([0.3, 1.4, 0.2], np.float32)
    so = np.broadcast_to(light, o_t.shape).copy()
    sd = (o_t + 2.5 * d_t - light).astype(np.float32)
    sd[:, ::7] = 0.0
    tm = np.full(so.shape[:2], 1.0 - 1e-3, np.float32)
    s_words, s_counts = exact_cull(accel, so, sd, jnp.asarray(tm))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return dict(j_accel=accel, accel=accel_from_arrays(leaves(accel), "cpu"),
                primary=(o_t, d_t, words, counts), shadow=(so, sd, tm, s_words, s_counts),
                t=t)


def test_trace_sorted_matches_reference(case):
    o_t, d_t, words, counts = case["primary"]
    ref = jax.jit(functools.partial(jt2.trace_tiles_sorted, interpret=True, batch=tt2.BATCH))
    bt, gid = ref(jnp.asarray(o_t), jnp.asarray(d_t), case["j_accel"], words, counts)
    t = case["t"]
    t_bt, t_gid = tt2.trace_tiles_sorted(t(o_t), t(d_t), case["accel"], t(words), t(counts))
    np.testing.assert_array_equal(t_gid.numpy(), np.asarray(gid))
    np.testing.assert_allclose(t_bt.numpy(), np.asarray(bt), rtol=1e-6)
    assert (t_gid.numpy() >= 0).mean() > 0.05, "fixture must hit something"


def test_anyhit_sorted_matches_reference(case):
    so, sd, tm, words, counts = case["shadow"]
    ref = jax.jit(functools.partial(jt2.any_hit_tiles_sorted, interpret=True,
                                    batch=tt2.BATCH))
    occ = ref(jnp.asarray(so), jnp.asarray(sd), jnp.asarray(tm), case["j_accel"], words, counts)
    t = case["t"]
    t_occ = tt2.any_hit_tiles_sorted(t(so), t(sd), t(tm), case["accel"], t(words), t(counts))
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(occ))
    assert 0.0 < t_occ.numpy().mean() < 1.0, "fixture must occlude some segments, not all"


def test_sorted_bit_equal_to_split_passes(case):
    """The whole-set passes against the count-sorted split passes on the
    same inputs: bt bits, gid and occlusion equal."""
    t = case["t"]
    o_t, d_t, words, counts = (t(x) for x in case["primary"])
    bt, gid = tt2.trace_tiles_sorted(o_t, d_t, case["accel"], words, counts)
    s_bt, s_gid, _, (p, z) = tt2.trace_tiles_split(o_t, d_t, case["accel"], words, counts)
    assert p > 0
    np.testing.assert_array_equal(gid.numpy(), s_gid.numpy())
    np.testing.assert_array_equal(bt.view(torch.int32).numpy(), s_bt.view(torch.int32).numpy())
    so, sd, tm, s_words, s_counts = (t(x) for x in case["shadow"])
    occ = tt2.any_hit_tiles_sorted(so, sd, tm, case["accel"], s_words, s_counts)
    g_occ, _, _ = tt2.any_hit_tiles_graded(so, sd, tm, case["accel"], s_words, s_counts)
    np.testing.assert_array_equal(occ.numpy(), g_occ.numpy())


def test_sorted_take_only_the_kernels_t_min(case):
    """The kernels are built for T_MIN: another t_min is refused, not
    ignored."""
    t = case["t"]
    o_t, d_t, words, counts = (t(x) for x in case["primary"])
    with pytest.raises(ValueError, match="t_min"):
        tt2.trace_tiles_sorted(o_t, d_t, case["accel"], words, counts, t_min=1e-3)
    so, sd, tm, s_words, s_counts = (t(x) for x in case["shadow"])
    with pytest.raises(ValueError, match="t_min"):
        tt2.any_hit_tiles_sorted(so, sd, tm, case["accel"], s_words, s_counts, t_min=0.0)
