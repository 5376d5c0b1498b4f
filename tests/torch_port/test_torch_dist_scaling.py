"""tracer_torch.dist.scaling against tracer.dist.scaling on the CPU:
default_device_counts exactly as tests/dist/test_scaling.py has it and equal
to the reference's for 1 to 32; scaling_sweep(device="cpu") at counts 1 and
2 (a world of 1 and a world of 2 gloo ranks, each rendering the sharded
accel frame) gives rows of the shape tests/dist/test_scaling.py holds the
reference's to."""
import numpy as np

from tracer.dist.scaling import default_device_counts as j_default_device_counts
from tracer_torch.dist.scaling import default_device_counts, scaling_sweep
from tracer_torch.utils.config import load_config


def test_default_device_counts():
    assert default_device_counts(1) == [1]
    assert default_device_counts(8) == [1, 2, 4, 8]
    assert default_device_counts(6) == [1, 2, 4, 6]
    assert default_device_counts(16) == [1, 2, 4, 8, 16]
    for n in range(1, 33):
        assert default_device_counts(n) == j_default_device_counts(n)


def test_scaling_sweep_measures_rows():
    cfg = load_config("cornell256", height=31, width=16)
    rows = scaling_sweep(cfg, device_counts=[1, 2], iters=2, warmup=1, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["height"] for r in rows] == [31, 32]
    for r in rows:
        assert set(r) == {"devices", "height", "ms_per_frame", "rays_per_s", "efficiency"}
        assert np.isfinite(r["rays_per_s"]) and r["rays_per_s"] > 0
        assert np.isfinite(r["efficiency"]) and r["efficiency"] > 0
        assert r["height"] % r["devices"] == 0
        assert np.isclose(r["rays_per_s"] * r["ms_per_frame"] / 1e3,
                          r["height"] * cfg.width * cfg.max_bounces * 2)
    assert abs(rows[0]["efficiency"] - 1.0) < 1e-9
