"""The readers of the grad step's row sums (the span "grad.rows_sum" and the
counter "rows_summed") read numbers from a CPU run of the program's
recorder, and nothing where it recorded nothing, where the program has no
recorder, or where its gathers are the plain x[idx]."""
import pytest
import torch
from test_rtbench_program_spans import GRAD, bunny, empty_recorder, run_units  # noqa: F401

from rtbench import harness

ROWS = ["rows_sum_ms.grad", "rows_summed.grad"]


@pytest.mark.parametrize("name", ROWS)
def test_a_row_sum_reader_reads_a_cpu_run(bunny, name):
    run_units(bunny, 2)
    v = harness.load_metric(name).read(None)
    assert isinstance(v, float) and v > 0


@pytest.mark.parametrize("name", ROWS)
def test_a_row_sum_reader_reads_nothing_where_nothing_was_recorded(name):
    assert harness.load_metric(name).read(None) is None


def test_a_program_without_the_recorder_gives_no_row_sums(bunny, monkeypatch):
    from tracer_torch.utils import metrics

    run_units(bunny, 1)
    assert metrics.span_totals("grad.step")["units"] == 1
    monkeypatch.delattr(metrics, "span_totals")
    for name in ROWS:
        assert harness.load_metric(name).read(None) is None


def test_the_row_sum_readers_read_nothing_from_a_program_without_the_span(bunny, monkeypatch):
    """A program whose gathers are the plain x[idx] (no "grad.rows_sum" span,
    no "rows_summed" counter) still records grad steps; the two readers give
    None there, the others their numbers."""
    import tracer_torch.bvh.cluster as cluster
    import tracer_torch.render.tiled as tiled
    import tracer_torch.scene.types as types

    def plain(src, idx):
        return src[idx.clamp_min(0)]

    for mod in (cluster, tiled, types):
        monkeypatch.setattr(mod, "gather_rows", plain)
    run_units(bunny, 1)
    assert all(harness.load_metric(n).read(None) is None for n in ROWS)
    got = {n: harness.load_metric(n).read(None) for n in GRAD}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got


def test_rows_summed_counts_every_gathered_row(bunny):
    """A step with verts as the parameter sums the shade row of each ray;
    of each padded slot, its 3 corners' vertices and normals; and the face
    normals of each vertex's incidences (vertices x the largest degree)."""
    from tracer_torch.bvh.cluster import build_scene_accel

    cfg, scene, _ = bunny
    slots = build_scene_accel(scene).shade.shape[0]
    incidences = scene.verts.shape[0] * int(torch.bincount(scene.tris.reshape(-1).long()).max())
    run_units(bunny, 2)
    assert harness.load_metric("rows_summed.grad").read(None) == (
        cfg.height * cfg.width + 6 * slots + incidences)
