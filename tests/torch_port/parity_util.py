"""Helpers shared by the torch-port parity tests: JAX dataclass leaves as
numpy arrays, the unit-vector tolerance, and the golden image gate."""
from __future__ import annotations

import dataclasses

import numpy as np


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
