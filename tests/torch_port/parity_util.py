"""Helpers shared by the torch-port parity tests: JAX dataclass leaves as
numpy arrays, the unit-vector tolerance, the golden image gate, and the
traversal fixtures (tiled rays over the bunny and a triangle soup, and the
reference's exact cull)."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tracer.bvh.cull import cull_clusters_sorted2
from tracer.core.camera import Camera as JCamera
from tracer.kernels.traversal import generate_rays_tiled, tile_rays
from tracer.scene.procedural import bunny_scene, random_tri_soup


def leaves(obj) -> dict:
    """A JAX dataclass -> {field: np.asarray(leaf)}, nested dataclasses as
    nested dicts (the input format of tracer_torch.bridge)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = leaves(v) if dataclasses.is_dataclass(v) else np.asarray(v)
    return out


def assert_unit_close(want, got):
    """Unit vectors agree to 2 units in the last place of 1.0 (2**-22
    absolute): the spread left by XLA's CPU rsqrt, which is not 1/sqrt."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=2.0 ** -22)


def golden_check(img, ref, frac_tol=0.015, p98_tol=2e-3):
    """The image gate of tests/golden/test_golden_cpp.py:_golden_check:
    fewer than 1.5% of pixels off by more than 2e-3, p98 error below 2e-3."""
    img = np.asarray(img)
    ref = np.asarray(ref)
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max(axis=-1)
    frac_bad = (err > 2e-3).mean()
    assert frac_bad < frac_tol, f"{frac_bad:.2%} pixels off (max err {err.max():.4f})"
    p98 = np.percentile(err, 98)
    assert p98 < p98_tol, f"p98 err {p98:.2e} (max err {err.max():.4f})"


def bunny_rays(size: int = 64):
    """The subdiv-3 bunny and its primary rays, (size/8)^2 tiles of 8x8."""
    scene, cam = bunny_scene(3)
    o, d, _ = generate_rays_tiled(JCamera.make(**cam), size, size, 64)
    return scene, np.array(o), np.array(d)


def soup_rays(size: int = 32):
    """400 random triangles seen from one origin along seeded random
    directions into their cube (no spatial coherence in the tiles)."""
    scene = random_tri_soup(400)
    rng = np.random.default_rng(7)
    o = np.broadcast_to(np.array([0.0, 0.0, 3.0], np.float32), (size, size, 3))
    d = rng.uniform(-1.0, 1.0, size=(size, size, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o_t, d_t, _ = tile_rays(jnp.asarray(o), jnp.asarray(d), 64)
    return scene, np.array(o_t), np.array(d_t)


@functools.partial(jax.jit, static_argnames=("k", "s"))
def _cull_jit(accel, o_t, d_t, t_max, k, s):
    return cull_clusters_sorted2(accel, o_t, d_t, t_max, k, s_cap=s, bf16_fetch=False)


def exact_cull(accel, o_t, d_t, t_max):
    """The reference's cull at caps wide enough to drop nothing, with the
    exact f32 box fetch -> (words, counts)."""
    k = max(8, -(-accel.num_clusters // 8) * 8)
    words, counts, excess, _ = _cull_jit(accel, jnp.asarray(o_t), jnp.asarray(d_t),
                                         jnp.asarray(t_max, jnp.float32), k=k,
                                         s=accel.super_lo.shape[0])
    assert int(excess) == 0
    return words, counts


def segment_list(order, ends, seg: int):
    """The segments of a table of tracer_torch's anyhit_segments, in the
    table's order -> (tile (n,) int64, k0 (n,) int64) numpy arrays: rank r
    holds the first ends[r] - ends[r-1] tiles of `order`, from word r*seg."""
    order, ends = np.asarray(order), np.asarray(ends).astype(np.int64)
    per_rank = np.diff(ends, prepend=0)
    assert (per_rank >= 0).all() and (per_rank <= order.shape[0]).all()
    tile = np.concatenate([order[:n] for n in per_rank] + [order[:0]])
    k0 = np.repeat(np.arange(ends.shape[0], dtype=np.int64) * seg, per_rank)
    return tile, k0

