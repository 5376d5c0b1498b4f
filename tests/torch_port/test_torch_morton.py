"""tracer_torch.bvh.morton's decode against the JAX package's
(tracer.bvh.morton.morton_decode3d): equal on every code, including codes
that use all 32 bits; and the round trip through morton3d."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh.morton import morton_decode3d as j_morton_decode3d
from tracer_torch.bvh.morton import morton3d, morton_decode3d


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_decode_matches_reference():
    rng = np.random.default_rng(0)
    codes = np.concatenate([rng.integers(0, 2**30, 2000), rng.integers(0, 2**32, 2000),
                            [0, 2**30 - 1, 2**32 - 1]]).astype(np.uint32)
    want = np.asarray(j_morton_decode3d(jnp.asarray(codes)))
    got = morton_decode3d(torch.from_numpy(codes.astype(np.int64)))
    assert got.shape == (codes.shape[0], 3)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_roundtrip():
    """tests/unit/test_bvh.py's check: decode(morton3d(q)) == q."""
    q = np.random.default_rng(1).integers(0, 1024, size=(1000, 3))
    back = morton_decode3d(morton3d(torch.from_numpy(q)))
    np.testing.assert_array_equal(back.numpy(), q)
